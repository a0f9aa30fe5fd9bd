"""The norm layers (counterparts of paddle_tpu/nn/layer/norm.py):
LayerNorm and RMSNorm through the norm kernels K4 / K5 on the card (over
the last axis with a weight; the plain op for other forms, T2),
BatchNorm*, SyncBatchNorm, GroupNorm, InstanceNorm*, LocalResponseNorm
and SpectralNorm.

BatchNorm keeps its running statistics in the buffers `_mean` and
`_variance` (the reference's names, so state dicts cross by name); in
training they are blended in place under no_grad with paddle's momentum
(0.9) and the biased batch variance (`F.batch_norm`), in eval the layer
normalizes by them. SyncBatchNorm is BatchNorm, as in the reference
(whose batch statistics span the global batch through XLA's sharding);
across ranks its statistics are queue 1 item 6b2 and refused.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["LayerNorm", "RMSNorm", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(shape=self.normalized_shape,
                                  attr=weight_attr,
                                  default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self.normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, epsilon=self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)


def _affine(layer, n, weight_attr, bias_attr):
    layer.weight = None if weight_attr is False else \
        layer.create_parameter(shape=[n], attr=weight_attr,
                               default_initializer=I.Constant(1.0))
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape=[n], attr=bias_attr, is_bias=True)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine(self, num_features, weight_attr, bias_attr)
        dev = self.weight._t.device if self.weight is not None else None
        self.register_buffer("_mean", Tensor(
            np.zeros(num_features, np.float32), place=dev))
        self.register_buffer("_variance", Tensor(
            np.ones(num_features, np.float32), place=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm over this rank's batch (a world of 1); statistics across
    ranks are queue 1 item 6b2 and raise."""

    def forward(self, x):
        from ...distributed.group import get_world_size

        if self.training and get_world_size() > 1:
            raise NotImplementedError(
                "SyncBatchNorm's statistics across ranks are ROADMAP queue "
                "1 item 6b2; in a world of 1 it is BatchNorm")
        return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every BatchNorm replaced by a SyncBatchNorm that
        shares its parameters and buffers."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = SyncBatchNorm(layer.num_features, layer.momentum,
                                layer.epsilon, data_format=layer.data_format)
            for name in ("weight", "bias"):
                setattr(new, name, getattr(layer, name))
            new._buffers["_mean"] = layer._buffers["_mean"]
            new._buffers["_variance"] = layer._buffers["_variance"]
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        _affine(self, num_channels, weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            epsilon=self.epsilon,
                            data_format=self.data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        _affine(self, num_features, weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k)


class SpectralNorm(Layer):
    """paddle.nn.SpectralNorm: forward(weight) is weight / sigma, sigma the
    largest singular value of the weight matricized with `dim` as rows,
    estimated by `power_iters` power iterations from the buffers
    `weight_u` / `weight_v` (seeded normal vectors, refreshed each
    forward) and computed as u^T W v, differentiable in W. (The JAX
    package's SpectralNorm raises; its `nn.utils.spectral_norm` is this
    estimate.)"""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self.weight_shape = list(weight_shape)
        self.dim = dim % len(self.weight_shape)
        self.power_iters = power_iters
        self.epsilon = epsilon
        h = self.weight_shape[self.dim]
        w = int(np.prod(self.weight_shape)) // h
        rng = np.random.default_rng(0)
        for name, n in (("weight_u", h), ("weight_v", w)):
            vec = rng.standard_normal(n).astype(np.float32)
            self.register_buffer(name, Tensor(vec / np.linalg.norm(vec)))

    def forward(self, weight):
        w = weight._t
        perm = [self.dim] + [i for i in range(w.dim()) if i != self.dim]
        mat = w.permute(perm).reshape(w.shape[self.dim], -1)
        u, v = self._buffers["weight_u"], self._buffers["weight_v"]
        with torch.no_grad():
            m = mat.detach()
            for _ in range(self.power_iters):
                v.copy_(torch.nn.functional.normalize(m.t() @ u, dim=0,
                                                      eps=self.epsilon))
                u.copy_(torch.nn.functional.normalize(m @ v, dim=0,
                                                      eps=self.epsilon))
        sigma = u @ mat @ v
        return Tensor._wrap(w / sigma)
