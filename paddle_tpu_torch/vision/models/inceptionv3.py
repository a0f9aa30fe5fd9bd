"""Inception v3 (counterpart of paddle_tpu/vision/models/inceptionv3.py):
one logit head, no aux head, at 299 x 299 inputs."""
from __future__ import annotations

from ... import nn
from ...tensor import concat
from ._utils import ConvBNReLU, check_pretrained

__all__ = ["InceptionV3", "inception_v3"]


def _cat(tensors):
    return concat(tensors, axis=1)


class _InceptionA(nn.Layer):
    def __init__(self, in_ch, pool_features):
        super().__init__()
        self.branch1x1 = ConvBNReLU(in_ch, 64, 1)
        self.branch5x5 = nn.Sequential(ConvBNReLU(in_ch, 48, 1),
                                       ConvBNReLU(48, 64, 5, padding=2))
        self.branch3x3dbl = nn.Sequential(
            ConvBNReLU(in_ch, 64, 1), ConvBNReLU(64, 96, 3, padding=1),
            ConvBNReLU(96, 96, 3, padding=1))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1),
            ConvBNReLU(in_ch, pool_features, 1))

    def forward(self, x):
        return _cat([self.branch1x1(x), self.branch5x5(x),
                     self.branch3x3dbl(x), self.branch_pool(x)])


class _InceptionB(nn.Layer):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = ConvBNReLU(in_ch, 384, 3, stride=2)
        self.branch3x3dbl = nn.Sequential(
            ConvBNReLU(in_ch, 64, 1), ConvBNReLU(64, 96, 3, padding=1),
            ConvBNReLU(96, 96, 3, stride=2))
        self.branch_pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.branch3x3(x), self.branch3x3dbl(x),
                     self.branch_pool(x)])


class _InceptionC(nn.Layer):
    """Factorized 7x7 convolutions at 17x17."""

    def __init__(self, in_ch, channels_7x7):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = ConvBNReLU(in_ch, 192, 1)
        self.branch7x7 = nn.Sequential(
            ConvBNReLU(in_ch, c7, 1),
            ConvBNReLU(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNReLU(c7, 192, (7, 1), padding=(3, 0)))
        self.branch7x7dbl = nn.Sequential(
            ConvBNReLU(in_ch, c7, 1),
            ConvBNReLU(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNReLU(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNReLU(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNReLU(c7, 192, (1, 7), padding=(0, 3)))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNReLU(in_ch, 192, 1))

    def forward(self, x):
        return _cat([self.branch1x1(x), self.branch7x7(x),
                     self.branch7x7dbl(x), self.branch_pool(x)])


class _InceptionD(nn.Layer):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_ch):
        super().__init__()
        self.branch3x3 = nn.Sequential(ConvBNReLU(in_ch, 192, 1),
                                       ConvBNReLU(192, 320, 3, stride=2))
        self.branch7x7x3 = nn.Sequential(
            ConvBNReLU(in_ch, 192, 1),
            ConvBNReLU(192, 192, (1, 7), padding=(0, 3)),
            ConvBNReLU(192, 192, (7, 1), padding=(3, 0)),
            ConvBNReLU(192, 192, 3, stride=2))
        self.branch_pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return _cat([self.branch3x3(x), self.branch7x7x3(x),
                     self.branch_pool(x)])


class _InceptionE(nn.Layer):
    """Expanded-filter-bank output blocks at 8x8."""

    def __init__(self, in_ch):
        super().__init__()
        self.branch1x1 = ConvBNReLU(in_ch, 320, 1)
        self.branch3x3_1 = ConvBNReLU(in_ch, 384, 1)
        self.branch3x3_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = nn.Sequential(
            ConvBNReLU(in_ch, 448, 1), ConvBNReLU(448, 384, 3, padding=1))
        self.branch3x3dbl_2a = ConvBNReLU(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_2b = ConvBNReLU(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNReLU(in_ch, 192, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = _cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)])
        bd = self.branch3x3dbl_1(x)
        bd = _cat([self.branch3x3dbl_2a(bd), self.branch3x3dbl_2b(bd)])
        return _cat([self.branch1x1(x), b3, bd, self.branch_pool(x)])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBNReLU(3, 32, 3, stride=2),
            ConvBNReLU(32, 32, 3),
            ConvBNReLU(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            ConvBNReLU(64, 80, 1),
            ConvBNReLU(80, 192, 3),
            nn.MaxPool2D(3, stride=2),
        )
        self.blocks = nn.Sequential(
            _InceptionA(192, pool_features=32),
            _InceptionA(256, pool_features=64),
            _InceptionA(288, pool_features=64),
            _InceptionB(288),
            _InceptionC(768, channels_7x7=128),
            _InceptionC(768, channels_7x7=160),
            _InceptionC(768, channels_7x7=160),
            _InceptionC(768, channels_7x7=192),
            _InceptionD(768),
            _InceptionE(1280),
            _InceptionE(2048),
        )
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.dropout(x)
            x = x.flatten(1)
            x = self.fc(x)
        return x


def inception_v3(pretrained=False, **kwargs):
    check_pretrained(pretrained)
    return InceptionV3(**kwargs)
