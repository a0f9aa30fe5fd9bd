"""The ShuffleNetV2 family (counterpart of
paddle_tpu/vision/models/shufflenetv2.py): x0_25 to x2_0 and the swish
variant; the channel shuffle is `F.channel_shuffle` (a reshape and a
transpose)."""
from __future__ import annotations

from ... import nn
from ...tensor import concat
from ._utils import check_pretrained
from ...nn import functional as F

__all__ = [
    "ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
    "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
    "shufflenet_v2_x2_0", "shufflenet_v2_swish",
]

_STAGE_REPEATS = (4, 8, 4)

_STAGE_OUT = {
    0.25: (24, 24, 48, 96, 512),
    0.33: (24, 32, 64, 128, 512),
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


def _act(name):
    return nn.Swish() if name == "swish" else nn.ReLU()


class _InvertedResidual(nn.Layer):
    """Stride-1 unit: split channels, transform one branch, concat+shuffle."""

    def __init__(self, channels, act):
        super().__init__()
        branch = channels // 2
        self.branch_main = nn.Sequential(
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
            nn.Conv2D(branch, branch, 3, padding=1, groups=branch,
                      bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )

    def forward(self, x):
        half = x.shape[1] // 2
        x1, x2 = x[:, :half], x[:, half:]
        out = concat([x1, self.branch_main(x2)], axis=1)
        return F.channel_shuffle(out, 2)


class _InvertedResidualDS(nn.Layer):
    """Stride-2 (downsample) unit: both branches transform, concat doubles
    channels."""

    def __init__(self, in_channels, out_channels, act):
        super().__init__()
        branch = out_channels // 2
        self.branch_proj = nn.Sequential(
            nn.Conv2D(in_channels, in_channels, 3, stride=2, padding=1,
                      groups=in_channels, bias_attr=False),
            nn.BatchNorm2D(in_channels),
            nn.Conv2D(in_channels, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )
        self.branch_main = nn.Sequential(
            nn.Conv2D(in_channels, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
            nn.Conv2D(branch, branch, 3, stride=2, padding=1, groups=branch,
                      bias_attr=False),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1, bias_attr=False),
            nn.BatchNorm2D(branch), _act(act),
        )

    def forward(self, x):
        out = concat([self.branch_proj(x), self.branch_main(x)],
                            axis=1)
        return F.channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True):
        super().__init__()
        if scale not in _STAGE_OUT:
            raise ValueError(f"scale must be one of {sorted(_STAGE_OUT)}")
        out_ch = _STAGE_OUT[scale]
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv1 = nn.Sequential(
            nn.Conv2D(3, out_ch[0], 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(out_ch[0]), _act(act),
        )
        self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)

        stages = []
        in_c = out_ch[0]
        for stage_i, repeats in enumerate(_STAGE_REPEATS):
            out_c = out_ch[stage_i + 1]
            units = [_InvertedResidualDS(in_c, out_c, act)]
            units += [_InvertedResidual(out_c, act)
                      for _ in range(repeats - 1)]
            stages.append(nn.Sequential(*units))
            in_c = out_c
        self.stages = nn.LayerList(stages)

        self.conv_last = nn.Sequential(
            nn.Conv2D(in_c, out_ch[-1], 1, bias_attr=False),
            nn.BatchNorm2D(out_ch[-1]), _act(act),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(out_ch[-1], num_classes)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        for stage in self.stages:
            x = stage(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _shufflenet(scale, act, pretrained, **kwargs):
    check_pretrained(pretrained)
    return ShuffleNetV2(scale=scale, act=act, **kwargs)


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return _shufflenet(0.25, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return _shufflenet(0.33, "relu", pretrained, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return _shufflenet(0.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return _shufflenet(1.0, "relu", pretrained, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return _shufflenet(1.5, "relu", pretrained, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return _shufflenet(2.0, "relu", pretrained, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return _shufflenet(1.0, "swish", pretrained, **kwargs)
