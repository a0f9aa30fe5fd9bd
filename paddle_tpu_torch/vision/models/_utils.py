"""Shared helpers of paddle.vision.models (counterpart of
paddle_tpu/vision/models/_utils.py)."""
from __future__ import annotations

from ... import nn


class ConvBNReLU(nn.Layer):
    """Conv2D (no bias) + BatchNorm2D + ReLU — the stem/branch block shared
    by GoogLeNet and InceptionV3."""

    def __init__(self, in_channels, out_channels, kernel, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_channels, out_channels, kernel,
                              stride=stride, padding=padding,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_channels)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


def check_pretrained(pretrained):
    if pretrained:
        raise ValueError("pretrained weights are not downloaded; pass "
                         "pretrained=False and load a local state_dict")
