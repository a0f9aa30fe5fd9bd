"""paddle.nn.functional for the port: functions over Paddle Tensors in
paddle's layouts (counterpart of paddle_tpu/nn/functional/__init__.py).

The activations dispatch the op table's ops. The rest are thin layers
over the port's torch-native functional (`nn.torch_functional`), which
the models use too: `linear(x, w)` is the torch-native linear on `w.t()`
(paddle's (in, out) weight, a view, no copy); `layer_norm` and `rms_norm`
reach the norm kernels (K4 forward, K5 backward) and
`scaled_dot_product_attention` the flash kernels (K1 forward with
dropout, K2 / K3 backward) exactly as the models do, each with the same
amp casts. `dropout` and attention dropout draw from the default
generator's stream on the input's device (`core.rng`).

Not here yet (queue 1 item 6b): the functionals of the other 72 ops of
paddle_tpu/ops/nn_ops.py (convolutions, pooling, batch / group norm, the
other losses, ...), and `layer_norm` over more than the last axis (T2).
"""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op
from ..core.rng import generator_for
from ..core.tensor import Tensor
from ..ops.registry import get_op
from . import torch_functional as TF

__all__ = [
    "relu", "relu6", "gelu", "silu", "swish", "leaky_relu", "elu", "selu",
    "celu", "hardswish", "hardsigmoid", "hardtanh", "hardshrink",
    "softshrink", "tanhshrink", "mish", "softsign", "softmax",
    "log_softmax", "glu", "sigmoid", "tanh", "log_sigmoid",
    "thresholded_relu", "linear", "layer_norm", "rms_norm", "dropout",
    "embedding", "one_hot", "pad", "scaled_dot_product_attention",
    "cross_entropy", "mse_loss", "square_error_cost", "log_loss"]


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


# ------------------------------------------------------- linear / norms
def linear(x, weight, bias=None, name=None):
    """x @ weight + bias, weight in paddle's (in, out) layout."""
    return _wrap(TF.linear(_t(x), _t(weight).t(), _t(bias)))


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """LayerNorm over the last axis through K4 / K5 (fp32 under O1)."""
    return _wrap(TF.layer_norm(_t(x), normalized_shape, _t(weight),
                               _t(bias), epsilon))


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    if weight is None:
        raise NotImplementedError("rms_norm without a weight is queue 1 "
                                  "item 6b (ROADMAP)")
    return _wrap(TF.rms_norm(_t(x), _t(weight), epsilon))


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


# ------------------------------------------------------------- attention
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Layout (batch, seqlen, num_heads, head_dim), paddle's; through the
    flash kernels K1 / K2 / K3 (on the card), attention dropout inside
    them when `training` and dropout_p > 0."""
    q = _t(query)
    gen = generator_for(q.device) if training and dropout_p > 0.0 else None
    return _wrap(TF.scaled_dot_product_attention(
        q, _t(key), _t(value), _t(attn_mask), dropout_p, is_causal,
        training, gen))


# ---------------------------------------------------------------- losses
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  label_smoothing=0.0, name=None):
    """Softmax cross-entropy in fp32 (the reference's nn_ops.py:405-440):
    the port's fused form for hard labels over the last axis, else the
    plain one with class weights, soft labels, another axis or label
    smoothing."""
    logits, lbl = _t(input), _t(label)
    if (weight is None and not soft_label and label_smoothing == 0.0
            and axis in (-1, logits.dim() - 1)):
        return _wrap(TF.cross_entropy(logits, lbl, ignore_index,
                                      reduction))
    from .. import amp

    (logits,) = amp.cast_inputs("cross_entropy", logits)
    logp = torch.log_softmax(logits.float(), dim=axis)
    n_classes = logp.shape[axis]
    if soft_label:
        loss = -torch.sum(lbl.float() * logp, dim=axis)
        valid = torch.ones_like(loss)
    else:
        if lbl.dim() == logp.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        keep = lbl != ignore_index
        safe = torch.where(keep, lbl, 0)
        if label_smoothing > 0.0:
            onehot = torch.movedim(torch.nn.functional.one_hot(
                safe, n_classes).float(), -1, axis % logp.dim())
            target = onehot * (1.0 - label_smoothing) \
                + label_smoothing / n_classes
            loss = -torch.sum(target * logp, dim=axis)
        else:
            loss = -torch.take_along_dim(
                logp, safe.unsqueeze(axis), dim=axis).squeeze(axis)
        valid = keep.float()
        if weight is not None:
            w = _t(weight).float()[safe]
            loss, valid = loss * w, valid * w
        loss = loss * keep.to(loss.dtype)
    if reduction == "none":
        return _wrap(loss)
    if reduction == "sum":
        return _wrap(loss.sum())
    return _wrap(loss.sum() / valid.sum().clamp_min(1.0))


def mse_loss(input, label, reduction="mean", name=None):
    return _wrap(TF.mse_loss(_t(input), _t(label), reduction))


def square_error_cost(input, label):
    return _op("square_error_cost", input, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _op("log_loss", input, label, epsilon=epsilon)

