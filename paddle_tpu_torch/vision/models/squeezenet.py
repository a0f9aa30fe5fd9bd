"""SqueezeNet 1.0 and 1.1 (counterpart of
paddle_tpu/vision/models/squeezenet.py). Its pools ask for
`ceil_mode=True`, which the max pool ignores, as the reference's does
(ROADMAP, reference facts)."""
from __future__ import annotations

from ... import nn
from ...tensor import concat
from ._utils import check_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(nn.Layer):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes,
                 expand3x3_planes):
        super().__init__()
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1)
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1_planes, 1)
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3_planes, 3,
                                   padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat(
            [self.relu(self.expand1x1(x)), self.relu(self.expand3x3(x))],
            axis=1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError("version must be '1.0' or '1.1'")
        self.num_classes = num_classes
        self.with_pool = with_pool
        relu = nn.ReLU()
        pool = lambda: nn.MaxPool2D(3, stride=2, ceil_mode=True)  # noqa: E731
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), relu, pool(),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), pool(),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256), pool(),
                _Fire(512, 64, 256, 256),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), relu, pool(),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64), pool(),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128), pool(),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256),
            )
        if num_classes > 0:
            self.classifier_dropout = nn.Dropout(0.5)
            self.final_conv = nn.Conv2D(512, num_classes, 1)
            self.classifier_relu = nn.ReLU()
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier_relu(
                self.final_conv(self.classifier_dropout(x)))
        if self.with_pool:
            x = self.avgpool(x)
            x = x.flatten(1)
        return x


def _squeezenet(version, pretrained, **kwargs):
    check_pretrained(pretrained)
    return SqueezeNet(version=version, **kwargs)


def squeezenet1_0(pretrained=False, **kwargs):
    return _squeezenet("1.0", pretrained, **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return _squeezenet("1.1", pretrained, **kwargs)
