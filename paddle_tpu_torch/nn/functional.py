"""paddle.nn.functional for the port: functions over Paddle Tensors in
paddle's layouts (counterpart of paddle_tpu/nn/functional/__init__.py).

Most dispatch the op table's ops (`ops.math` for the activations,
`ops.nn_ops` for the convolutions, pools, norms and losses), so the amp
casts are the ops' declarations. The rest are thin layers over the
port's torch-native functional (`nn.torch_functional`), which the models
use too: `linear(x, w)` is the torch-native linear on `w.t()` (paddle's
(in, out) weight, a view, no copy); `layer_norm` over the last axis with
a weight and `rms_norm` with a weight reach the norm kernels (K4 forward,
K5 backward), any other form the plain op, as the reference routes them
(T2); `scaled_dot_product_attention` and `flash_attention` reach the
flash kernels (K1 forward with dropout, K2 / K3 backward) exactly as the
models do. `dropout`, attention dropout and the other random functionals
draw from the default generator's stream on the input's device
(`core.rng`).

`batch_norm` normalizes by the batch statistics in training and blends
the running ones as the reference does: `momentum * running + (1 -
momentum) * batch` (paddle's momentum, 0.9 by default) with the biased
batch variance, in place under no_grad.
"""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.rng import generator_for
from ..core.tensor import Tensor
from ..ops.nn_ops import attention_mask
from ..ops.registry import get_op
from . import torch_functional as TF

__all__ = [
    "relu", "relu_", "relu6", "gelu", "silu", "swish", "leaky_relu", "elu",
    "selu", "celu", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "mish", "softplus", "softsign", "prelu",
    "rrelu", "softmax", "log_softmax", "glu", "maxout", "sigmoid", "tanh",
    "gumbel_softmax", "log_sigmoid", "thresholded_relu",
    "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose",
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "lp_pool1d", "lp_pool2d", "max_unpool2d",
    "layer_norm", "rms_norm", "batch_norm", "group_norm", "instance_norm",
    "local_response_norm", "normalize",
    "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "pad", "zeropad2d", "interpolate", "upsample",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "unfold", "fold",
    "grid_sample", "affine_grid", "temporal_shift", "sequence_mask",
    "scaled_dot_product_attention", "flash_attention",
    "flash_attn_unpadded",
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "huber_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss", "poisson_nll_loss",
    "gaussian_nll_loss", "pairwise_distance", "triplet_margin_loss",
    "triplet_margin_with_distance_loss", "cosine_embedding_loss",
    "dice_loss", "margin_cross_entropy", "ctc_loss", "rnnt_loss",
    "sigmoid_focal_loss", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_similarity", "label_smooth", "npair_loss", "multi_margin_loss",
    "square_error_cost", "log_loss"]


def _op(name, *args, **kwargs):
    return apply_op(get_op(name), *args, **kwargs)


def _t(x):
    return x._t if isinstance(x, Tensor) else x


def _wrap(t):
    return Tensor._wrap(t)


# ----------------------------------------------------------- activations
def relu(x, name=None):
    return _op("relu", x)


def relu6(x, name=None):
    return _op("relu6", x)


def gelu(x, approximate=False, name=None):
    return _op("gelu", x, approximate=approximate)


def silu(x, name=None):
    return _op("silu", x)


def swish(x, name=None):
    return _op("swish", x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _op("leaky_relu", x, negative_slope=negative_slope)


def elu(x, alpha=1.0, name=None):
    return _op("elu", x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _op("selu", x, scale=scale, alpha=alpha)


def celu(x, alpha=1.0, name=None):
    return _op("celu", x, alpha=alpha)


def hardswish(x, name=None):
    return _op("hardswish", x)


def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5, name=None):
    return _op("hardsigmoid", x, slope=slope, offset=offset)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return _op("hardtanh", x, min=min, max=max)


def hardshrink(x, threshold=0.5, name=None):
    return _op("hardshrink", x, threshold=threshold)


def softshrink(x, threshold=0.5, name=None):
    return _op("softshrink", x, threshold=threshold)


def tanhshrink(x, name=None):
    return _op("tanhshrink", x)


def mish(x, name=None):
    return _op("mish", x)


def softsign(x, name=None):
    return _op("softsign", x)


def softmax(x, axis=-1, dtype=None, name=None):
    out = _op("softmax", x, axis=axis)
    return out.astype(dtype) if dtype is not None else out


def log_softmax(x, axis=-1, dtype=None, name=None):
    out = _op("log_softmax", x, axis=axis)
    return out.astype(dtype) if dtype is not None else out


def glu(x, axis=-1, name=None):
    return _op("glu", x, axis=axis)


def sigmoid(x, name=None):
    return _op("sigmoid", x)


def tanh(x, name=None):
    return _op("tanh", x)


def log_sigmoid(x, name=None):
    return _op("log_sigmoid", x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return _op("thresholded_relu", x, threshold=threshold, value=value)


def relu_(x):
    return x._inplace_op("relu")


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return _op("softplus", x, beta=beta, threshold=threshold)


def prelu(x, weight, name=None):
    return _op("prelu", x, weight)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    return _op("rrelu", x, lower=lower, upper=upper, training=training)


def maxout(x, groups, axis=1, name=None):
    return _op("maxout", x, groups=groups, axis=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + Gumbel noise) / temperature); `hard` gives the one-hot
    of the argmax forward and the soft gradient backward."""
    t = _t(x)
    u = torch.rand(t.shape, generator=generator_for(t.device),
                   device=t.device).clamp(torch.finfo(torch.float32).tiny,
                                          1.0)
    g = (-torch.log(-torch.log(u))).to(t.dtype)
    y = softmax((x + _wrap(g)) / temperature, axis=axis)
    if hard:
        idx = y.argmax(axis=axis)
        hard_y = _op("one_hot", idx, num_classes=x.shape[axis])
        y = (hard_y - y).detach() + y
    return y


# ------------------------------------------------------- linear / norms
def linear(x, weight, bias=None, name=None):
    """x @ weight + bias, weight in paddle's (in, out) layout."""
    return _wrap(TF.linear(_t(x), _t(weight).t(), _t(bias)))


# ---------------------------------------------------- convolutions, pools
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _op("conv1d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _op("conv2d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _op("conv3d", x, weight, bias, stride=stride, padding=padding,
               dilation=dilation, groups=groups, data_format=data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL", name=None):
    return _op("conv1d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding, groups=groups,
               dilation=dilation, data_format=data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", name=None):
    return _op("conv2d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding,
               dilation=dilation, groups=groups, data_format=data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", name=None):
    return _op("conv3d_transpose", x, weight, bias, stride=stride,
               padding=padding, output_padding=output_padding, groups=groups,
               dilation=dilation, data_format=data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               name=None):
    return _op("max_pool1d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    op = "max_pool2d_with_index" if return_mask else "max_pool2d"
    return _op(op, x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, data_format=data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool3d(return_mask=True) is not implemented")
    return _op("max_pool3d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode, data_format=data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               name=None):
    return _op("avg_pool1d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _op("avg_pool2d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode,
               count_include_pad=not exclusive, data_format=data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, data_format="NCDHW", name=None):
    return _op("avg_pool3d", x, kernel_size=kernel_size, stride=stride,
               padding=padding, ceil_mode=ceil_mode,
               count_include_pad=not exclusive, data_format=data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _op("adaptive_avg_pool1d", x, output_size=output_size)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _op("adaptive_avg_pool2d", x, output_size=output_size,
               data_format=data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _op("adaptive_avg_pool3d", x, output_size=output_size,
               data_format=data_format)


def _no_mask(name, return_mask):
    if return_mask:
        raise NotImplementedError(f"{name}(return_mask=True) is not "
                                  "supported")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask("adaptive_max_pool1d", return_mask)
    return _op("adaptive_max_pool1d", x, output_size=output_size)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _op("adaptive_max_pool2d", x, output_size=output_size)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask("adaptive_max_pool3d", return_mask)
    return _op("adaptive_max_pool3d", x, output_size=output_size)


def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _op("lp_pool1d", x, norm_type=norm_type, kernel_size=kernel_size,
               stride=stride, padding=padding, ceil_mode=ceil_mode,
               data_format=data_format)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _op("lp_pool2d", x, norm_type=norm_type, kernel_size=kernel_size,
               stride=stride, padding=padding, ceil_mode=ceil_mode,
               data_format=data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    # paddle's order: data_format before output_size
    return _op("max_unpool2d", x, indices, kernel_size=kernel_size,
               stride=stride, padding=padding, output_size=output_size,
               data_format=data_format)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the trailing len(normalized_shape) axes: through K4 /
    K5 over the last axis with a weight, else the plain op (fp32 under
    O1 either way)."""
    return _wrap(TF.layer_norm(_t(x), normalized_shape, _t(weight),
                               _t(bias), epsilon))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    return _wrap(TF.rms_norm(_t(x), _t(weight), epsilon))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    use_stats = (not training) if use_global_stats is None else \
        use_global_stats
    if use_stats:
        return _op("batch_norm_infer", x, running_mean, running_var, weight,
                   bias, epsilon=epsilon, data_format=data_format)
    out, batch_mean, batch_var = _op("batch_norm_train", x, weight, bias,
                                     epsilon=epsilon,
                                     data_format=data_format)
    if running_mean is not None:
        with torch.no_grad():
            for run, batch in ((running_mean, batch_mean),
                               (running_var, batch_var)):
                r = _t(run)
                r.copy_(momentum * r + (1.0 - momentum) * batch._t.to(
                    r.dtype))
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    return _op("group_norm", x, num_groups, weight, bias, epsilon=epsilon,
               data_format=data_format)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    return _op("instance_norm", x, weight, bias, epsilon=eps)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    return _op("local_response_norm", x, size=size, alpha=alpha, beta=beta,
               k=k)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p over `axis`, epsilon)."""
    t = _t(x)
    n = torch.pow(torch.sum(torch.pow(torch.abs(t), p), dim=axis,
                            keepdim=True), 1.0 / p)
    return _wrap(t / torch.clamp(n, min=epsilon))


# -------------------------------------------------------------- dropout
def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """paddle's dropout: `upscale_in_train` scales kept elements by
    1 / (1 - p); `downscale_in_infer` keeps them as they are; `axis`
    draws one keep decision for every index of the axes it lists. Out of
    training (or at p = 0) x passes through, as in the reference."""
    if not training or p == 0.0:
        return x
    t = _t(x)
    if p >= 1.0:
        return _wrap(torch.zeros_like(t))
    gen = generator_for(t.device)
    if axis is None and mode == "upscale_in_train":
        return _wrap(TF.dropout(t, p, True, gen))
    shape = t.shape
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(a % t.dim() for a in axes)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(t.shape))
    keep = torch.rand(shape, generator=gen, device=t.device) >= p
    if mode == "upscale_in_train":
        t = t * (1.0 / (1.0 - p))
    return _wrap(torch.where(keep, t, torch.zeros_like(t)))


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped element takes SELU's negative saturation,
    then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    t = _t(x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(t.shape, generator=generator_for(t.device),
                      device=t.device) >= p
    a = 1.0 / ((alpha_p ** 2 * p + 1.0) * (1.0 - p)) ** 0.5
    b = -a * alpha_p * p
    return _wrap(a * torch.where(keep, t, torch.full_like(t, alpha_p)) + b)


# ------------------------------------------------------ embedding, misc
def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids `x`; rows at `padding_idx` are zero (and
    give the padding row no gradient). The weight gradient sums each
    row's contributions in a fixed order (`ops.embedding`)."""
    return _wrap(TF.embedding(_t(x).long(), _t(weight), padding_idx))


def one_hot(x, num_classes, name=None):
    return _op("one_hot", x, num_classes=num_classes)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return _op("pad", x, pad=pad, mode=mode, value=value,
               data_format=data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    if isinstance(padding, int):
        padding = [padding] * 4
    left, right, top, bottom = [int(p) for p in padding]
    t = _t(x)
    if data_format == "NCHW":
        return _wrap(torch.nn.functional.pad(t, [left, right, top, bottom]))
    return _wrap(torch.nn.functional.pad(t, [0, 0, left, right, top,
                                             bottom]))


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    return _op("interpolate", x, size=size, scale_factor=scale_factor,
               mode=mode, align_corners=align_corners,
               data_format=data_format)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    return _op("pixel_shuffle", x, upscale_factor=upscale_factor,
               data_format=data_format)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    return _op("pixel_unshuffle", x, downscale_factor=downscale_factor,
               data_format=data_format)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    return _op("channel_shuffle", x, groups=groups, data_format=data_format)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _op("unfold", x, kernel_sizes=kernel_sizes, strides=strides,
               paddings=paddings, dilations=dilations)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    return _op("fold", x, output_sizes=output_sizes,
               kernel_sizes=kernel_sizes, strides=strides, paddings=paddings,
               dilations=dilations)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    return _op("grid_sample", x, grid, mode=mode, padding_mode=padding_mode,
               align_corners=align_corners)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    return _op("affine_grid", theta,
               out_shape=tuple(int(v) for v in out_shape),
               align_corners=align_corners)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    return _op("temporal_shift", x, seg_num=seg_num, shift_ratio=shift_ratio)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """mask[i, ..., j] = j < x[i, ...]; with maxlen None the bound is read
    on the host (a data-dependent shape)."""
    from ..core.dtype import convert_dtype

    t = _t(x)
    if maxlen is None:
        maxlen = int(t.max())
    ar = torch.arange(int(maxlen), device=t.device, dtype=t.dtype)
    return _wrap((ar < t[..., None]).to(convert_dtype(dtype)))


# ------------------------------------------------------------- attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Layout (batch, seqlen, num_heads, head_dim), paddle's; through the
    flash kernels K1 / K2 / K3 (on the card), attention dropout inside
    them when `training` and dropout_p > 0. A boolean mask keeps where
    True; a mask of fewer than 4 axes broadcasts from the right (the
    decoder's (L, L) causal mask)."""
    q = _t(query)
    gen = generator_for(q.device) if training and dropout_p > 0.0 else None
    mask = attention_mask(_t(attn_mask), q)
    return _wrap(TF.scaled_dot_product_attention(
        q, _t(key), _t(value), mask, dropout_p, is_causal, training, gen))


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """paddle's flash_attention: (out, None), through K1 / K2 / K3. The
    softmax is never materialized, and a seed offset or a named generator
    is refused, as in the reference (:699-722)."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax=True requires materializing the attention "
            "matrix, which the fused kernel never does; use "
            "scaled_dot_product_attention's plain path for debugging")
    if dropout > 0.0 and (fixed_seed_offset is not None or rng_name):
        raise NotImplementedError(
            "fixed_seed_offset/rng_name are not supported; seed the "
            "framework generator with paddle.seed(...) for reproducible "
            "dropout")
    out = scaled_dot_product_attention(query, key, value, attn_mask=None,
                                       dropout_p=dropout, is_causal=causal,
                                       training=training)
    return out, None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        name=None):
    """Varlen (packed) flash attention is refused, as in the reference
    (:725-736): pad to a rectangular batch and pass an additive mask to
    scaled_dot_product_attention."""
    raise NotImplementedError(
        "flash_attn_unpadded is not supported (static shapes, as the "
        "reference); pad to a rectangular batch and pass an additive "
        "attn_mask to scaled_dot_product_attention")


# ---------------------------------------------------------------- losses
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0, name=None):
    """Softmax cross-entropy in fp32 (the reference's nn_ops.py:405-440):
    the port's fused form for hard labels over the last axis, else the
    plain op (class weights, soft labels, another axis, label
    smoothing)."""
    logits, lbl = _t(input), _t(label)
    if (weight is None and not soft_label and label_smoothing == 0.0
            and axis in (-1, logits.dim() - 1)):
        return _wrap(TF.cross_entropy(logits, lbl, ignore_index,
                                      reduction))
    return _op("cross_entropy", input, label, weight, soft_label=soft_label,
               axis=axis, ignore_index=ignore_index, reduction=reduction,
               label_smoothing=label_smoothing)


def mse_loss(input, label, reduction="mean", name=None):
    return _wrap(TF.mse_loss(_t(input), _t(label), reduction))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, axis=axis,
                         reduction="none")
    if loss.ndim == logits.ndim - 1:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    return _op("nll_loss", input, label, weight, ignore_index=ignore_index,
               reduction=reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _op("l1_loss", input, label, reduction=reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    return _op("smooth_l1_loss", input, label, reduction=reduction,
               delta=delta)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    return _op("binary_cross_entropy", input, label, weight,
               reduction=reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    return _op("binary_cross_entropy_with_logits", logit, label, weight,
               reduction=reduction, pos_weight=pos_weight)


def kl_div(input, label, reduction="mean", name=None):
    return _op("kl_div", input, label, reduction=reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    return _op("huber_loss", input, label, delta=delta, reduction=reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _op("soft_margin_loss", input, label, reduction=reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    return _op("multi_label_soft_margin_loss", input, label, weight,
               reduction=reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    return _op("poisson_nll_loss", input, label, log_input=log_input,
               full=full, epsilon=epsilon, reduction=reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    return _op("gaussian_nll_loss", input, label, variance, full=full,
               epsilon=epsilon, reduction=reduction)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    return _op("pairwise_distance", x, y, p=p, epsilon=epsilon,
               keepdim=keepdim)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    return _op("triplet_margin_loss", input, positive, negative,
               margin=margin, p=p, epsilon=epsilon, swap=swap,
               reduction=reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    """Triplet loss under a distance callable (default: the p = 2
    pairwise distance, triplet_margin_loss)."""
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = d_neg.minimum(distance_function(positive, negative))
    loss = (d_pos - d_neg + margin).clip(min=0.0)
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    return _op("cosine_embedding_loss", input1, input2, label, margin=margin,
               reduction=reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    return _op("dice_loss", input, label, epsilon=epsilon)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean", group=None, name=None):
    return _op("margin_cross_entropy", logits, label, margin1=margin1,
               margin2=margin2, margin3=margin3, scale=scale,
               return_softmax=return_softmax, reduction=reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    return _op("ctc_loss", log_probs, labels, input_lengths, label_lengths,
               blank=blank, reduction=reduction,
               norm_by_times=norm_by_times)


def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    return _op("rnnt_loss", input, label, input_lengths, label_lengths,
               blank=blank, fastemit_lambda=fastemit_lambda,
               reduction=reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    return _op("sigmoid_focal_loss", logit, label, normalizer, alpha=alpha,
               gamma=gamma, reduction=reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _op("margin_ranking_loss", input, other, label, margin=margin,
               reduction=reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _op("hinge_embedding_loss", input, label, margin=margin,
               reduction=reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    return _op("cosine_similarity", x1, x2, axis=axis, eps=eps)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    return _op("label_smooth", label, epsilon=epsilon, prior_dist=prior_dist)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    return _op("npair_loss", anchor, positive, labels, l2_reg=l2_reg)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """Multi-class margin loss: the true class's own term left out."""
    logits, lab = _t(input), _t(label).reshape(-1).long()
    c = logits.shape[1]
    correct = torch.gather(logits, 1, lab[:, None])
    diff = torch.clamp(margin - correct + logits, min=0.0) ** p
    if weight is not None:
        diff = diff * _t(weight)[lab][:, None]
    mask = torch.arange(c, device=logits.device)[None, :] != lab[:, None]
    per = torch.sum(diff * mask, dim=1) / c
    if reduction == "mean":
        return _wrap(per.mean())
    return _wrap(per.sum() if reduction == "sum" else per)


def square_error_cost(input, label):
    return _op("square_error_cost", input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _op("log_loss", input, label, epsilon=epsilon)

