"""The DenseNet family (counterpart of
paddle_tpu/vision/models/densenet.py): DenseNet 121 / 161 / 169 / 201 /
264, each dense layer concatenating its output onto its input.
"""
from __future__ import annotations

from ... import nn
from ...tensor import concat
from ._utils import check_pretrained

__all__ = [
    "DenseNet", "densenet121", "densenet161", "densenet169", "densenet201",
    "densenet264",
]

_ARCH = {
    121: (6, 12, 24, 16),
    161: (6, 12, 36, 24),
    169: (6, 12, 32, 32),
    201: (6, 12, 48, 32),
    264: (6, 12, 64, 48),
}


class _DenseLayer(nn.Layer):
    """BN-ReLU-Conv1x1 (bottleneck to bn_size*growth) -> BN-ReLU-Conv3x3."""

    def __init__(self, num_input_features, growth_rate, bn_size, dropout):
        super().__init__()
        inter = bn_size * growth_rate
        self.norm1 = nn.BatchNorm2D(num_input_features)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input_features, inter, 1, bias_attr=False)
        self.norm2 = nn.BatchNorm2D(inter)
        self.conv2 = nn.Conv2D(inter, growth_rate, 3, padding=1,
                               bias_attr=False)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class _DenseBlock(nn.Layer):
    def __init__(self, num_layers, num_input_features, bn_size, growth_rate,
                 dropout):
        super().__init__()
        self.layers = nn.LayerList([
            _DenseLayer(num_input_features + i * growth_rate, growth_rate,
                        bn_size, dropout)
            for i in range(num_layers)
        ])

    def forward(self, x):
        features = [x]
        for layer in self.layers:
            new = layer(concat(features, axis=1)
                        if len(features) > 1 else features[0])
            features.append(new)
        return concat(features, axis=1)


class _Transition(nn.Layer):
    def __init__(self, num_input_features, num_output_features):
        super().__init__()
        self.norm = nn.BatchNorm2D(num_input_features)
        self.relu = nn.ReLU()
        self.conv = nn.Conv2D(num_input_features, num_output_features, 1,
                              bias_attr=False)
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.norm(x))))


class DenseNet(nn.Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True, growth_rate=None, num_init_features=None):
        super().__init__()
        if layers not in _ARCH:
            raise ValueError(f"layers must be one of {sorted(_ARCH)}")
        block_config = _ARCH[layers]
        if growth_rate is None:
            growth_rate = 48 if layers == 161 else 32
        if num_init_features is None:
            num_init_features = 96 if layers == 161 else 64
        self.num_classes = num_classes
        self.with_pool = with_pool

        self.conv0 = nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                               bias_attr=False)
        self.norm0 = nn.BatchNorm2D(num_init_features)
        self.relu0 = nn.ReLU()
        self.pool0 = nn.MaxPool2D(3, stride=2, padding=1)

        blocks, transitions = [], []
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            blocks.append(_DenseBlock(num_layers, num_features, bn_size,
                                      growth_rate, dropout))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                transitions.append(_Transition(num_features,
                                               num_features // 2))
                num_features //= 2
        self.blocks = nn.LayerList(blocks)
        self.transitions = nn.LayerList(transitions)
        self.norm5 = nn.BatchNorm2D(num_features)
        self.relu5 = nn.ReLU()
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Linear(num_features, num_classes)

    def forward(self, x):
        x = self.pool0(self.relu0(self.norm0(self.conv0(x))))
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.transitions):
                x = self.transitions[i](x)
        x = self.relu5(self.norm5(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _densenet(layers, pretrained, **kwargs):
    check_pretrained(pretrained)
    return DenseNet(layers=layers, **kwargs)


def densenet121(pretrained=False, **kwargs):
    return _densenet(121, pretrained, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return _densenet(161, pretrained, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return _densenet(169, pretrained, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return _densenet(201, pretrained, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return _densenet(264, pretrained, **kwargs)
