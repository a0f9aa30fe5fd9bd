"""GoogLeNet / Inception v1 (counterpart of
paddle_tpu/vision/models/googlenet.py). Returns (main, aux1, aux2)
logits as the reference does: the aux heads run in eval too and the
caller weighs them. Its pools ask for `ceil_mode=True`, which the max
pool ignores, as the reference's does (ROADMAP, reference facts)."""
from __future__ import annotations

from ... import nn
from ...tensor import concat
from ._utils import ConvBNReLU, check_pretrained

__all__ = ["GoogLeNet", "googlenet"]


class _Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.branch1 = ConvBNReLU(in_ch, c1, 1)
        self.branch2 = nn.Sequential(ConvBNReLU(in_ch, c3r, 1),
                                     ConvBNReLU(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(ConvBNReLU(in_ch, c5r, 1),
                                     ConvBNReLU(c5r, c5, 5, padding=2))
        self.branch4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                     ConvBNReLU(in_ch, proj, 1))

    def forward(self, x):
        return concat([self.branch1(x), self.branch2(x),
                              self.branch3(x), self.branch4(x)], axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_ch, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = ConvBNReLU(in_ch, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = x.flatten(1)
        x = self.dropout(self.relu(self.fc1(x)))
        return self.fc2(x)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            ConvBNReLU(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
            ConvBNReLU(64, 64, 1),
            ConvBNReLU(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, ceil_mode=True),
        )
        self.inc3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.4)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(self.dropout(x))
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    check_pretrained(pretrained)
    return GoogLeNet(**kwargs)
