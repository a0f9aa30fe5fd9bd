"""MobileNet V1 / V2 / V3 Small and Large (counterpart of
paddle_tpu/vision/models/mobilenet.py): `scale=` widths, V3's
squeeze-excitation blocks with Hardswish / Hardsigmoid. Depthwise convs
are Conv2D with groups equal to the channels. `pretrained=True` raises
RuntimeError: no weights are downloaded.
"""
from __future__ import annotations

from ... import nn

__all__ = [
    "MobileNetV1", "MobileNetV2", "MobileNetV3Small", "MobileNetV3Large",
    "mobilenet_v1", "mobilenet_v2", "mobilenet_v3_small", "mobilenet_v3_large",
]


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act=nn.ReLU):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = act() if act is not None else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act is not None else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, mid_c, out_c, stride, scale):
        super().__init__()
        in_c = int(in_c * scale)
        mid_c = int(mid_c * scale)
        out_c = int(out_c * scale)
        self.dw = ConvBNLayer(in_c, mid_c, 3, stride=stride, padding=1,
                              groups=in_c)
        self.pw = ConvBNLayer(mid_c, out_c, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1)
        cfg = [
            # in, mid, out, stride
            (32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
            (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
            (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
            (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
            (1024, 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, m, o, s, scale) for i, m, o, s in cfg
        ])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden_dim, 1, act=nn.ReLU6))
        layers.extend([
            ConvBNLayer(hidden_dim, hidden_dim, 3, stride=stride, padding=1,
                        groups=hidden_dim, act=nn.ReLU6),
            ConvBNLayer(hidden_dim, oup, 1, act=None),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res_connect else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        cfg = [
            # t, c, n, s
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                act=nn.ReLU6)]
        for t, c, n, s in cfg:
            out_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_channel, s if i == 0 else 1, t))
                input_channel = out_channel
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features.append(ConvBNLayer(input_channel, self.last_channel, 1,
                                    act=nn.ReLU6))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2), nn.Linear(self.last_channel, num_classes))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class SqueezeExcitation(nn.Layer):
    def __init__(self, channel, reduction=4):
        super().__init__()
        mid = _make_divisible(channel // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(channel, mid, 1)
        self.relu = nn.ReLU()
        self.fc2 = nn.Conv2D(mid, channel, 1)
        self.hsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        s = self.pool(x)
        s = self.relu(self.fc1(s))
        s = self.hsigmoid(self.fc2(s))
        return x * s


class V3Block(nn.Layer):
    def __init__(self, inp, mid, out, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and inp == out
        layers = []
        if mid != inp:
            layers.append(ConvBNLayer(inp, mid, 1, act=act))
        layers.append(ConvBNLayer(mid, mid, kernel, stride=stride,
                                  padding=kernel // 2, groups=mid, act=act))
        if use_se:
            layers.append(SqueezeExcitation(mid))
        layers.append(ConvBNLayer(mid, out, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class _MobileNetV3(nn.Layer):
    # cfg rows: kernel, mid, out, use_se, act, stride
    def __init__(self, cfg, last_c, last_mid_c, scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        inp = _make_divisible(16 * scale)
        layers = [ConvBNLayer(3, inp, 3, stride=2, padding=1,
                              act=nn.Hardswish)]
        for k, mid, out, use_se, act, s in cfg:
            mid_c = _make_divisible(mid * scale)
            out_c = _make_divisible(out * scale)
            layers.append(V3Block(inp, mid_c, out_c, k, s, use_se, act))
            inp = out_c
        last_mid = _make_divisible(last_mid_c * scale)
        layers.append(ConvBNLayer(inp, last_mid, 1, act=nn.Hardswish))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_mid, last_c),
                nn.Hardswish(),
                nn.Dropout(0.2),
                nn.Linear(last_c, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        RE, HS = nn.ReLU, nn.Hardswish
        cfg = [
            (3, 16, 16, True, RE, 2), (3, 72, 24, False, RE, 2),
            (3, 88, 24, False, RE, 1), (5, 96, 40, True, HS, 2),
            (5, 240, 40, True, HS, 1), (5, 240, 40, True, HS, 1),
            (5, 120, 48, True, HS, 1), (5, 144, 48, True, HS, 1),
            (5, 288, 96, True, HS, 2), (5, 576, 96, True, HS, 1),
            (5, 576, 96, True, HS, 1),
        ]
        super().__init__(cfg, 1024, 576, scale, num_classes, with_pool)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        RE, HS = nn.ReLU, nn.Hardswish
        cfg = [
            (3, 16, 16, False, RE, 1), (3, 64, 24, False, RE, 2),
            (3, 72, 24, False, RE, 1), (5, 72, 40, True, RE, 2),
            (5, 120, 40, True, RE, 1), (5, 120, 40, True, RE, 1),
            (3, 240, 80, False, HS, 2), (3, 200, 80, False, HS, 1),
            (3, 184, 80, False, HS, 1), (3, 184, 80, False, HS, 1),
            (3, 480, 112, True, HS, 1), (3, 672, 112, True, HS, 1),
            (5, 672, 160, True, HS, 2), (5, 960, 160, True, HS, 1),
            (5, 960, 160, True, HS, 1),
        ]
        super().__init__(cfg, 1280, 960, scale, num_classes, with_pool)


def _no_pretrained(arch, pretrained):
    if pretrained:
        raise RuntimeError(
            f"pretrained weights for {arch} are not downloaded")


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v1", pretrained)
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v2", pretrained)
    return MobileNetV2(scale=scale, **kwargs)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v3_small", pretrained)
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    _no_pretrained("mobilenet_v3_large", pretrained)
    return MobileNetV3Large(scale=scale, **kwargs)
