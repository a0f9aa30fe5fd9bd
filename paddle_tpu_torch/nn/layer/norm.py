"""The norm layers (counterparts of paddle_tpu/nn/layer/norm.py):
LayerNorm and RMSNorm through the norm kernels K4 / K5 on the card (over
the last axis with a weight; the plain op for other forms, T2),
BatchNorm*, SyncBatchNorm, GroupNorm, InstanceNorm*, LocalResponseNorm
and SpectralNorm.

BatchNorm keeps its running statistics in the buffers `_mean` and
`_variance` (the reference's names, so state dicts cross by name); in
training they are blended in place under no_grad with paddle's momentum
(0.9) and the biased batch variance (`F.batch_norm`), in eval the layer
normalizes by them.

SyncBatchNorm computes its training statistics over the global batch, as
the reference's do (there XLA shards the batch axis, so every BatchNorm
is global). Here every rank is a process: each rank's count, mean and
sum of squared deviations a channel (fp32, also under O2) are
all-gathered over the data-parallel group (fleet's dp group when fleet
is initialised, else the world) and combined in rank order (Chan's
parallel variance, in float64), so no `E[x^2] - E[x]^2` loses digits to
a large mean; the backward all-reduces each channel's sum of dy and of
dy * x_hat in one collective. In a world of one rank, and in eval, it is
BatchNorm bit for bit. Plain BatchNorm under DataParallel normalizes by
its own rank's batch, as Paddle's does.
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


def _sync_group():
    """fleet's data-parallel group when fleet is initialised, else the
    world."""
    from ...distributed.fleet import get_hybrid_communicate_group
    from ...distributed.group import _default

    hcg = get_hybrid_communicate_group()
    return hcg.get_data_parallel_group() if hcg is not None else _default()


class _SyncBatchNormFn(torch.autograd.Function):
    """Batch normalization of a channel-first `x` (fp32 or float64) by the
    statistics of every rank's batch in `group`."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        from ...distributed.communication import all_gather

        dims = [0] + list(range(2, x.dim()))
        count = x.numel() // x.shape[1]
        var_l, mean_l = torch.var_mean(x, dim=dims, correction=0)
        local = torch.cat([mean_l, var_l * count,
                           mean_l.new_tensor([count])]).double()
        parts = torch.stack(all_gather(None, local, group))   # rank order
        c = x.shape[1]
        n = parts[:, 2 * c:]
        total = n.sum()
        mean = (n * parts[:, :c]).sum(0) / total
        m2 = parts[:, c:2 * c].sum(0) + (
            n * (parts[:, :c] - mean) ** 2).sum(0)
        mean, var = mean.to(x.dtype), (m2 / total).to(x.dtype)
        shape = [1, c] + [1] * (x.dim() - 2)
        invstd = torch.rsqrt(var + eps)
        out = (x - mean.reshape(shape)) * invstd.reshape(shape)
        if weight is not None:
            out = out * weight.reshape(shape)
        if bias is not None:
            out = out + bias.reshape(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.total = group, float(total)
        ctx.has_bias = bias is not None
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        from ...distributed.communication import all_reduce

        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        shape = [1, c] + [1] * (x.dim() - 2)
        dims = [0] + list(range(2, x.dim()))
        xhat = (x - mean.reshape(shape)) * invstd.reshape(shape)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        sums = all_reduce(local.clone(), group=ctx.group) / ctx.total
        scale = invstd if weight is None else weight * invstd
        dx = scale.reshape(shape) * (dy - sums[:c].reshape(shape)
                                     - xhat * sums[c:].reshape(shape))
        dw = local[c:] if weight is not None else None
        db = local[:c] if ctx.has_bias else None
        return dx, dw, db, None, None


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose training statistics span every rank's batch (see
    the module docstring); BatchNorm itself in a world of one rank and in
    eval."""

    def forward(self, x):
        group = _sync_group()
        use_stats = (not self.training) if self.use_global_stats is None \
            else self.use_global_stats
        if use_stats or group.nranks == 1:
            return super().forward(x)
        from ... import amp

        t = x._t
        out_dtype = amp.cast_inputs("batch_norm_train", t,
                                    amp_list="black")[0].dtype
        last = self.data_format[-1] == "C" and t.dim() > 2
        x32 = (t.movedim(-1, 1) if last else t).contiguous()
        if x32.dtype != torch.float64:      # statistics in at least fp32
            x32 = x32.float()
        w = None if self.weight is None else self.weight._t.to(x32.dtype)
        b = None if self.bias is None else self.bias._t.to(x32.dtype)
        out, mean, var = _SyncBatchNormFn.apply(x32, w, b, group,
                                                self.epsilon)
        with torch.no_grad():
            for name, batch in (("_mean", mean), ("_variance", var)):
                run = self._buffers[name]
                run.copy_(self.momentum * run + (1.0 - self.momentum)
                          * batch.to(run.dtype))
        if last:
            out = out.movedim(1, -1)
        return Tensor._wrap(out.to(out_dtype))

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
