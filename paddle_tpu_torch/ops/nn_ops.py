"""The nn ops of the op table (counterpart of paddle_tpu/ops/nn_ops.py and
the 72 ops.yaml entries whose kernel is `nn_ops.*`): activations,
convolutions and their transposes, pooling, the norms, dropout, the
lookup, the losses, attention, resizing, the shuffles, fold / unfold,
grid sampling, CTC and RNN-T.

Each body is torch code over torch tensors under the reference's name and
declaration. Where the reference's math differs from a PyTorch call of
the same name, the body follows the reference:

- `interpolate` is `jax.image.resize` (nn_ops.py:757-768): nearest takes
  floor((i + 0.5) * in / out); linear and cubic are separable weight
  matrices with half-pixel centres, weights renormalized at the borders,
  the kernel widened when downsampling (antialiasing), cubic with Keys'
  a = -0.5; `align_corners` is ignored, as there.
- the pools pad with -inf (max) or 0 (avg) as `lax.reduce_window` does,
  to any width; `avg` divides by the window size unless
  `count_include_pad` is False and the window is padded (:156-185);
  `ceil_mode` is ignored, as there.
- `batch_norm_train` returns the biased batch variance (:300-317); its
  normalization is `torch.native_batch_norm`, whose saved inverse
  standard deviation gives the variance back.
- `ctc_loss` and `rnnt_loss` run the reference's forward recursions
  (log space, -1e30 for impossible paths), so their gradients are those
  of the recursion with respect to the given log-probabilities (PyTorch's
  `ctc_loss` returns the gradient with respect to the logits instead).
- `scaled_dot_product_attention` goes through the port's flash path
  (`ops.flash_attention.attention`: K1 forward, K2 / K3 backward on the
  card, their plain versions on the CPU); the reference op's `rng_key`
  is a `torch.Generator` here, from which one kernel seed is drawn.
- `dropout` takes a `torch.Generator` where the reference takes a key.

The convolutions are `torch.nn.functional.conv*d` (the reference's are
`lax.conv_general_dilated`, outside any Pallas kernel); string and
asymmetric paddings become an explicit pad first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from .registry import register_op as op

_NEG = -1e30


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _reduce(loss, reduction):
    if reduction == "none":
        return loss
    return loss.sum() if reduction == "sum" else loss.mean()


def _c_last(x):
    """NC... -> N...C."""
    return x.permute(0, *range(2, x.dim()), 1)


def _c_first(x):
    """N...C -> NC..."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


# ------------------------------------------------------------ activations
@op("softplus")
def softplus(x, beta=1.0, threshold=20.0):
    bx = beta * x
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, torch.zeros_like(bx)) / beta)


@op("prelu")
def prelu(x, weight):
    w = weight
    if w.numel() > 1 and x.dim() >= 2:
        shape = [1] * x.dim()
        shape[1] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, w * x)


@op("rrelu")
def rrelu(x, lower=0.125, upper=1.0 / 3.0, training=False):
    slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


@op("maxout")
def maxout(x, groups, axis=1):
    axis = axis % x.dim()
    shape = list(x.shape)
    shape[axis] = x.shape[axis] // groups
    shape.insert(axis + 1, groups)
    return x.reshape(shape).amax(dim=axis + 1)


# ---------------------------------------------------------- convolutions
def _same_pads(size, k, stride, dilation):
    """lax's 'SAME' padding of one axis: (lo, hi)."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _conv_pads(padding, x_spatial, ks, stride, dilation):
    """The reference's `_conv_padding` as a list of (lo, hi) an axis."""
    n = len(ks)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        if padding.upper() != "SAME":
            raise ValueError(f"bad padding {padding!r}")
        return [_same_pads(s, k, st, d) for s, k, st, d in
                zip(x_spatial, ks, stride, dilation)]
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding!r}")


def _flat_pads(pads):
    """[(lo, hi) per spatial axis] as F.pad's list, innermost axis first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


_CONV = {1: _F.conv1d, 2: _F.conv2d, 3: _F.conv3d}
_CONV_T = {1: _F.conv_transpose1d, 2: _F.conv_transpose2d,
           3: _F.conv_transpose3d}


def _conv(x, weight, bias, stride, pads, dilation, groups, nd):
    """conv over NC... with (lo, hi) pads an axis: symmetric pads go to
    the convolution, others to an explicit zero pad first."""
    if all(lo == hi for lo, hi in pads):
        return _CONV[nd](x, weight, bias, stride, [lo for lo, _ in pads],
                         dilation, groups)
    x = _F.pad(x, _flat_pads(pads))
    return _CONV[nd](x, weight, bias, stride, 0, dilation, groups)


@op("conv2d", amp="white")
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    nhwc = data_format != "NCHW"
    if nhwc:
        x = _c_first(x)
    pads = _conv_pads(padding, x.shape[2:], weight.shape[-2:], stride,
                      dilation)
    out = _conv(x, weight, bias, stride, pads, dilation, groups, 2)
    return _c_last(out) if nhwc else out


@op("conv1d", amp="white")
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    stride, dilation = _ntuple(stride, 1)[:1], _ntuple(dilation, 1)[:1]
    if isinstance(padding, str):
        pads = _conv_pads(padding, x.shape[2:], weight.shape[-1:], stride,
                          dilation)
    elif isinstance(padding, int):
        pads = [(padding, padding)]
    else:
        p = list(padding)
        pads = [(int(p[0]), int(p[-1]))]
    return _conv(x, weight, bias, stride, pads, dilation, groups, 1)


@op("conv3d", amp="white")
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    stride, dilation = _ntuple(stride, 3), _ntuple(dilation, 3)
    pads = _conv_pads(padding, x.shape[2:], weight.shape[-3:], stride,
                      dilation)
    return _conv(x, weight, bias, stride, pads, dilation, groups, 3)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd):
    """The gradient-of-convolution form (nn_ops.py:1421-1454): the full
    transposed convolution, then each axis cropped by (lo, hi - op), a
    negative crop being a zero pad."""
    stride, dilation, output_padding = (_ntuple(stride, nd),
                                        _ntuple(dilation, nd),
                                        _ntuple(output_padding, nd))
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    pads = _conv_pads(padding, x.shape[2:], weight.shape[-nd:], stride,
                      dilation)
    full = _CONV_T[nd](x, weight, None, stride, 0, 0, groups, dilation)
    out = _F.pad(full, _flat_pads([(-lo, -hi + o) for (lo, hi), o in
                                   zip(pads, output_padding)]))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


@op("conv2d_transpose", amp="white")
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    if data_format != "NCHW":
        raise NotImplementedError(
            "conv2d_transpose supports NCHW only; transpose the input")
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2)


@op("conv1d_transpose", amp="white")
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCL"):
    if data_format != "NCL":
        raise NotImplementedError(
            "conv1d_transpose supports NCL only; transpose the input")
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1)


@op("conv3d_transpose", amp="white")
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW"):
    if data_format != "NCDHW":
        raise NotImplementedError(
            "conv3d_transpose supports NCDHW only; transpose the input")
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3)


# ---------------------------------------------------------------- pooling
_MAX_POOL = {1: _F.max_pool1d, 2: _F.max_pool2d, 3: _F.max_pool3d}
_AVG_POOL = {1: _F.avg_pool1d, 2: _F.avg_pool2d, 3: _F.avg_pool3d}


def _window_pool(x, k, s, pads, is_max, count_include_pad=True):
    """lax.reduce_window over the spatial axes of NC... x: a max (pads of
    -inf) or a mean over the window (pads of 0; without
    `count_include_pad`, over the real elements of a padded window)."""
    nd = len(k)
    padded = any(lo or hi for lo, hi in pads)
    if is_max:
        if padded:
            x = _F.pad(x, _flat_pads(pads), value=float("-inf"))
        return _MAX_POOL[nd](x, k, s)
    if padded:
        x = _F.pad(x, _flat_pads(pads))
    out = _AVG_POOL[nd](x, k, s)
    if count_include_pad or not padded:
        return out
    shape = [1, 1] + [n - lo - hi for n, (lo, hi) in
                      zip(x.shape[2:], pads)]
    ones = _F.pad(torch.ones(shape, dtype=x.dtype, device=x.device),
                  _flat_pads(pads))
    frac = _AVG_POOL[nd](ones, k, s)
    return out / frac


def _pool2d(x, kernel, stride, padding, is_max, data_format,
            count_include_pad=True):
    k = _ntuple(kernel, 2)
    s = _ntuple(stride, 2) if stride is not None else k
    nhwc = data_format != "NCHW"
    if nhwc:
        x = _c_first(x)
    pads = _conv_pads(padding, x.shape[2:], k, s, (1, 1))
    out = _window_pool(x, k, s, pads, is_max, count_include_pad)
    return _c_last(out) if nhwc else out


@op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    return _pool2d(x, kernel_size, stride, padding, True, data_format)


@op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCHW"):
    return _pool2d(x, kernel_size, stride, padding, False, data_format,
                   count_include_pad)


def _pool1d_args(kernel_size, stride, padding):
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = k if stride is None else (stride if isinstance(stride, int)
                                  else stride[0])
    p = padding if isinstance(padding, int) else padding[0]
    return (int(k),), (int(s),), [(int(p), int(p))]


@op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    k, s, pads = _pool1d_args(kernel_size, stride, padding)
    return _window_pool(x, k, s, pads, True)


@op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    k, s, pads = _pool1d_args(kernel_size, stride, padding)
    return _window_pool(x, k, s, pads, False)


def _check_pool3d_args(ceil_mode, data_format):
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True is not implemented for "
                                  "3d/lp pooling; pad the input instead")
    if data_format not in ("NCDHW", "NDHWC"):
        raise ValueError(f"unsupported data_format {data_format!r}")


def _pool3d(x, kernel_size, stride, padding, is_max, data_format,
            count_include_pad=True):
    k = _ntuple(kernel_size, 3)
    s = _ntuple(stride, 3) if stride is not None else k
    pads = [(p, p) for p in _ntuple(padding, 3)]
    nd = data_format == "NDHWC"
    if nd:
        x = _c_first(x)
    out = _window_pool(x, k, s, pads, is_max, count_include_pad)
    return _c_last(out) if nd else out


@op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCDHW"):
    _check_pool3d_args(ceil_mode, data_format)
    return _pool3d(x, kernel_size, stride, padding, True, data_format)


@op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCDHW"):
    _check_pool3d_args(ceil_mode, data_format)
    return _pool3d(x, kernel_size, stride, padding, False, data_format,
                   count_include_pad)


# adaptive pools: window i spans [floor(i * n / o), ceil((i + 1) * n / o)),
# the reference's windows and PyTorch's alike
@op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    o = _ntuple(output_size, 2)
    if data_format != "NCHW":
        return _c_last(_F.adaptive_avg_pool2d(_c_first(x), o))
    return _F.adaptive_avg_pool2d(x, o)


@op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _F.adaptive_max_pool2d(x, _ntuple(output_size, 2))


@op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    o = _ntuple(output_size, 3)
    if data_format != "NCDHW":
        return _c_last(_F.adaptive_avg_pool3d(_c_first(x), o))
    return _F.adaptive_avg_pool3d(x, o)


@op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size):
    return _F.adaptive_avg_pool1d(x, _ntuple(output_size, 1)[:1])


@op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size):
    return _F.adaptive_max_pool1d(x, _ntuple(output_size, 1)[:1])


@op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size):
    return _F.adaptive_max_pool3d(x, _ntuple(output_size, 3))


def _lp_pool(x, norm_type, k, s, pads):
    """sum(x^p)^(1/p) over each window of the SIGNED values in fp32
    (an odd p can give nan on a negative window, as the reference)."""
    xp = x.float() ** norm_type
    summed = _window_pool(xp, k, s, pads, False) * math.prod(k)
    return (summed ** (1.0 / norm_type)).to(x.dtype)


@op("lp_pool1d")
def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL"):
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True is not implemented for "
                                  "lp pooling")
    if data_format != "NCL":
        raise ValueError("lp_pool1d supports data_format='NCL' only")
    k = int(kernel_size)
    s = int(stride) if stride is not None else k
    return _lp_pool(x, norm_type, (k,), (s,), [(int(padding),) * 2])


@op("lp_pool2d")
def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW"):
    if ceil_mode:
        raise NotImplementedError("ceil_mode=True is not implemented for "
                                  "lp pooling")
    if data_format != "NCHW":
        raise ValueError("lp_pool2d supports data_format='NCHW' only")
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride, 2) if stride is not None else k
    return _lp_pool(x, norm_type, k, s,
                    [(p, p) for p in _ntuple(padding, 2)])


@op("max_pool2d_with_index", multi_output=True)
def max_pool2d_with_index(x, kernel_size, stride=None, padding=0,
                          ceil_mode=False, data_format="NCHW"):
    """(values, flat argmax over H * W of the unpadded input): the taps
    stacked and reduced, as the reference (:1337-1375)."""
    if ceil_mode:
        raise NotImplementedError("ceil_mode with return_mask is not "
                                  "implemented")
    if data_format != "NCHW":
        raise ValueError("return_mask supports data_format='NCHW' only")
    k = _ntuple(kernel_size, 2)
    st = _ntuple(stride, 2) if stride is not None else k
    p = _ntuple(padding, 2)
    n, c, h, w = x.shape
    xp = _F.pad(x, [p[1], p[1], p[0], p[0]], value=float("-inf"))
    oh = (h + 2 * p[0] - k[0]) // st[0] + 1
    ow = (w + 2 * p[1] - k[1]) // st[1] + 1
    oy = torch.arange(oh, device=x.device)[:, None] * st[0] - p[0]
    ox = torch.arange(ow, device=x.device)[None, :] * st[1] - p[1]
    vals, idxs = [], []
    for i in range(k[0]):
        for j in range(k[1]):
            vals.append(xp[:, :, i:i + (oh - 1) * st[0] + 1:st[0],
                           j:j + (ow - 1) * st[1] + 1:st[1]])
            idxs.append((oy + i) * w + (ox + j))
    stacked = torch.stack(vals)
    out, tap = stacked.max(dim=0)
    index = torch.stack(idxs)[:, None, None].expand(-1, n, c, -1, -1)
    return out, torch.gather(index, 0, tap[None])[0].to(torch.int32)


@op("max_unpool2d")
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports data_format='NCHW' only")
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride, 2) if stride is not None else k
    p = _ntuple(padding, 2)
    n, c, h, w = x.shape
    if output_size is None:
        oh = (h - 1) * s[0] - 2 * p[0] + k[0]
        ow = (w - 1) * s[1] - 2 * p[1] + k[1]
    else:
        osz = list(output_size)
        oh, ow = int(osz[-2]), int(osz[-1])
    flat = x.new_zeros((n, c, oh * ow))
    idx = indices.long().reshape(n, c, h * w)
    return flat.scatter(2, idx, x.reshape(n, c, h * w)).reshape(n, c, oh, ow)


# ---------------------------------------------------------- normalization
@op("layer_norm", amp="black")
def layer_norm(x, weight=None, bias=None, epsilon=1e-5, begin_norm_axis=-1):
    if isinstance(begin_norm_axis, int) and begin_norm_axis >= 0:
        axes = tuple(range(begin_norm_axis, x.dim()))
    else:
        axes = (x.dim() - 1,)
    x32 = x.float()
    mean = x32.mean(dim=axes, keepdim=True)
    var = torch.square(x32 - mean).mean(dim=axes, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op("rms_norm", amp="black")
def rms_norm(x, weight=None, epsilon=1e-6):
    x32 = x.float()
    ms = torch.square(x32).mean(dim=-1, keepdim=True)
    out = (x32 * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


def _channel_shape(x, data_format):
    c_axis = 1 if data_format.startswith("NC") else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = -1
    return c_axis, shape


@op("batch_norm_infer", amp="black")
def batch_norm_infer(x, running_mean, running_var, weight=None, bias=None,
                     epsilon=1e-5, data_format="NCHW"):
    _, shape = _channel_shape(x, data_format)
    inv = torch.rsqrt(running_var.float() + epsilon).reshape(shape)
    out = (x.float() - running_mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


@op("batch_norm_train", amp="black", multi_output=True)
def batch_norm_train(x, weight=None, bias=None, epsilon=1e-5,
                     data_format="NCHW"):
    """(out, batch mean, biased batch variance); the running-stat update
    is the layer's (F.batch_norm)."""
    c_axis, shape = _channel_shape(x, data_format)
    x32 = x.float()
    if c_axis != 1:
        x32 = _c_first(x32)
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    out, mean, invstd = torch.native_batch_norm(x32, w, b, None, None, True,
                                                0.0, epsilon)
    var = torch.reciprocal(torch.square(invstd)) - epsilon
    if c_axis != 1:
        out = _c_last(out)
    return out.to(x.dtype), mean, var


@op("group_norm", amp="black")
def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    if data_format != "NCHW":
        raise NotImplementedError("group_norm supports NCHW")
    n, c = x.shape[0], x.shape[1]
    x32 = x.float().reshape((n, num_groups, c // num_groups)
                            + tuple(x.shape[2:]))
    axes = tuple(range(2, x32.dim()))
    var, mean = torch.var_mean(x32, dim=axes, correction=0, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    _, shape = _channel_shape(x, "NC")
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


@op("instance_norm", amp="black")
def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    axes = tuple(range(2, x.dim()))
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=axes, correction=0, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + epsilon)
    _, shape = _channel_shape(x, "NC")
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out.to(x.dtype)


@op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0):
    """x / (k + alpha * sum of x^2 over `size` channels)^beta (the sum, not
    PyTorch's mean)."""
    half = size // 2
    sq = torch.square(x)
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    sq = _F.pad(sq, pads)
    c = x.shape[1]
    s = sum(sq[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * s, beta)


# ------------------------------------------------- dropout / lookup / linear
@op("dropout")
def dropout(x, key=None, p=0.5, training=True, mode="upscale_in_train",
            axis=None):
    """`key` is the torch.Generator the keep mask is drawn from (on x's
    device); with `axis`, one draw for each index of those axes."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x) if mode == "upscale_in_train" else x * 0.0
    shape = x.shape
    if axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(a % x.dim() for a in axes)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = torch.rand(shape, generator=key, device=x.device) >= p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(keep, x, torch.zeros_like(x))


@op("embedding")
def embedding(ids, weight, padding_idx=None, sparse=False):
    from .embedding import embedding as _lookup

    out = _lookup(ids.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


@op("linear", amp="white")
def linear(x, weight, bias=None):
    """x @ weight + bias, weight in paddle's (in, out) layout."""
    return _F.linear(x, weight.t(), bias)


# ------------------------------------------------------------------ losses
@op("cross_entropy", amp="black")
def cross_entropy(logits, label, weight=None, soft_label=False, axis=-1,
                  ignore_index=-100, reduction="mean", label_smoothing=0.0):
    logp = torch.log_softmax(logits.float(), dim=axis)
    n_classes = logp.shape[axis]
    if soft_label:
        loss = -torch.sum(label.float() * logp, dim=axis)
        valid = torch.ones_like(loss)
    else:
        lbl = label
        if lbl.dim() == logp.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        keep = lbl != ignore_index
        safe = torch.where(keep, lbl, 0)
        if label_smoothing > 0.0:
            onehot = torch.movedim(_F.one_hot(safe, n_classes).float(), -1,
                                   axis % logp.dim())
            target = onehot * (1.0 - label_smoothing) \
                + label_smoothing / n_classes
            loss = -torch.sum(target * logp, dim=axis)
        else:
            loss = -torch.take_along_dim(
                logp, safe.unsqueeze(axis), dim=axis).squeeze(axis)
        valid = keep.float()
        if weight is not None:
            w = weight[safe]
            loss, valid = loss * w, valid * w
        loss = loss * keep.to(loss.dtype)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp_min(1.0)


@op("fused_linear_cross_entropy", amp="white")
def fused_linear_cross_entropy(x, weight, bias=None, label=None,
                               ignore_index=-100, transpose_y=False,
                               reduction="mean", chunk_size=2048):
    from .cross_entropy import fused_linear_cross_entropy as _flce

    return _flce(x, weight, bias, label, ignore_index, transpose_y,
                 reduction, chunk_size)


@op("nll_loss", amp="black")
def nll_loss(logp, label, weight=None, ignore_index=-100, reduction="mean"):
    lbl = label.long()
    keep = lbl != ignore_index
    safe = torch.where(keep, lbl, 0)
    loss = -torch.gather(logp, 1, safe[:, None]).squeeze(1)
    valid = keep.float()
    if weight is not None:
        w = weight[safe]
        loss, valid = loss * w, valid * w
    loss = loss * keep.to(loss.dtype)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp_min(1.0)


@op("mse_loss")
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


@op("l1_loss")
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - label), reduction)


@op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


@op("binary_cross_entropy", amp="black")
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    x = torch.clamp(input.float(), eps, 1.0 - eps)
    loss = -(label * torch.log(x) + (1.0 - label) * torch.log(1.0 - x))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def _bce_logits_terms(logit, label):
    max_val = torch.clamp(-logit, min=0)
    return max_val, torch.log(torch.exp(-max_val) + torch.exp(-logit
                                                              - max_val))


@op("binary_cross_entropy_with_logits", amp="black")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    logit, label = logit.float(), label.float()
    max_val, lse = _bce_logits_terms(logit, label)
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1.0 - label) * logit + log_w * (lse + max_val)
    else:
        loss = (1.0 - label) * logit + max_val + lse
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("kl_div", amp="black")
def kl_div(input, label, reduction="mean", log_target=False):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        safe = torch.where(label > 0, label, torch.ones_like(label))
        loss = torch.where(label > 0, label * (torch.log(safe) - input),
                           torch.zeros_like(label))
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


@op("cosine_similarity")
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


@op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


@op("sigmoid_focal_loss", amp="black")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    logit32, label32 = logit.float(), label.float()
    max_val, lse = _bce_logits_terms(logit32, label32)
    ce = (1.0 - label32) * logit32 + max_val + lse
    p_t = p * label32 + (1 - p) * (1 - label32)
    loss = ce * torch.pow(1 - p_t, gamma)
    loss = (alpha * label32 + (1 - alpha) * (1 - label32)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@op("label_smooth")
def label_smooth(label, epsilon=0.1, prior_dist=None):
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


@op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.t()
    lbl = labels.reshape(-1, 1)
    target = (lbl == lbl.t()).float()
    target = target / target.sum(dim=1, keepdim=True)
    logp = torch.log_softmax(sim, dim=-1)
    ce = -torch.mean(torch.sum(target * logp, dim=1))
    reg = l2_reg * (torch.mean(torch.sum(torch.square(anchor), dim=1))
                    + torch.mean(torch.sum(torch.square(positive), dim=1))
                    ) * 0.25
    return ce + reg


@op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean"):
    diff = torch.abs(input - label)
    loss = torch.where(diff <= delta, 0.5 * diff * diff,
                       delta * (diff - 0.5 * delta))
    return _reduce(loss, reduction)


@op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean"):
    z = -label.to(input.dtype) * input
    return _reduce(torch.logaddexp(z, torch.zeros_like(z)), reduction)


@op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    lab = label.to(input.dtype)
    loss = -(lab * _F.logsigmoid(input) + (1.0 - lab) * _F.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


@op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2.0 * math.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


@op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - label) / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce(loss, reduction)


@op("pairwise_distance")
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    d = x - y + epsilon
    return torch.sum(torch.abs(d) ** p, dim=-1, keepdim=keepdim) ** (1.0 / p)


@op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    d_pos = pairwise_distance(input, positive, p, epsilon)
    d_neg = pairwise_distance(input, negative, p, epsilon)
    if swap:
        d_neg = torch.minimum(d_neg, pairwise_distance(positive, negative,
                                                       p, epsilon))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


@op("dice_loss")
def dice_loss(input, label, epsilon=1e-5):
    lab = _F.one_hot(label.squeeze(-1).long(), input.shape[-1]).to(
        input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * lab, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(lab, dim=dims)
    return torch.mean(1.0 - (2.0 * inter + epsilon) / (union + epsilon))


@op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean"):
    cos = torch.clamp(logits, -1.0 + 1e-6, 1.0 - 1e-6)
    target_cos = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    onehot = _F.one_hot(label.long(), logits.shape[-1]).to(logits.dtype)
    logp = torch.log_softmax(torch.where(onehot > 0, target_cos, cos)
                             * scale, dim=-1)
    loss = _reduce(-torch.sum(onehot * logp, dim=-1), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


@op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    x1, x2 = input1.float(), input2.float()
    cos = torch.sum(x1 * x2, -1) / torch.clamp(
        torch.linalg.vector_norm(x1, dim=-1)
        * torch.linalg.vector_norm(x2, dim=-1), min=1e-12)
    loss = torch.where(label.float() > 0, 1.0 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


@op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """The CTC forward recursion over time in log space (nn_ops.py:947-
    1007): log_probs (T, B, C), labels (B, L); the per-sample negative log
    likelihood, mean over label lengths then batch for 'mean'."""
    T, B, _ = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    lbl_len = label_lengths.long()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    pos = torch.arange(S, device=dev)[None, :]
    valid = pos < (2 * lbl_len[:, None] + 1)
    prev2 = _F.pad(ext, [2, 0], value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != prev2)
    neg = torch.full((), _NEG, dtype=log_probs.dtype, device=dev)

    def emit(t):
        return torch.gather(log_probs[t], 1, ext)

    lp0 = emit(0)
    alpha = torch.where(pos <= 1, lp0, neg)
    alpha = torch.where(valid, alpha, neg)
    alphas = [alpha]
    for t in range(1, T):
        a1 = _F.pad(alpha, [1, 0], value=_NEG)[:, :S]
        a2 = _F.pad(alpha, [2, 0], value=_NEG)[:, :S]
        a = torch.logaddexp(alpha, a1)
        a = torch.where(can_skip, torch.logaddexp(a, a2), a)
        alpha = torch.where(valid, a + emit(t), neg)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                             # (T, B, S)
    bidx = torch.arange(B, device=dev)
    t_idx = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    alpha_t = alphas[t_idx, bidx]                            # (B, S)
    end = 2 * lbl_len
    a_last = alpha_t[bidx, end]
    a_prev = alpha_t[bidx, torch.clamp(end - 1, min=0)]
    nll = -torch.logaddexp(a_last, torch.where(lbl_len > 0, a_prev, neg))
    if norm_by_times:
        nll = nll / torch.clamp(input_lengths.to(nll.dtype), min=1.0)
    if reduction == "mean":
        return torch.mean(nll / torch.clamp(lbl_len.to(nll.dtype), min=1.0))
    return _reduce(nll, reduction)


@op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean"):
    """The RNN-T forward variables (Graves 2012), t outer and u inner
    (nn_ops.py:1010-1078): input (B, T, U + 1, V) joint logits, label
    (B, U)."""
    if fastemit_lambda:
        raise NotImplementedError(
            "fastemit_lambda != 0 is not implemented (warprnnt applies "
            "FastEmit to the gradient only; a forward-side rescale would "
            "change the returned NLL)")
    logp = torch.log_softmax(input.float(), dim=-1)
    B, T, U1, _ = logp.shape
    U = U1 - 1
    lab = label.long()
    emit = torch.gather(logp[:, :, :U, :], 3,
                        lab[:, None, :, None].expand(B, T, U, 1))[..., 0]
    blank_p = logp[..., blank]                               # (B, T, U+1)

    def row_scan(base, emit_row):
        cols = [base[:, 0]]
        for u in range(1, U1):
            cols.append(torch.logaddexp(base[:, u],
                                        cols[-1] + emit_row[:, u - 1]))
        return torch.stack(cols, dim=1)

    alpha = row_scan(torch.cat([logp.new_zeros(B, 1),
                                logp.new_full((B, U), _NEG)], dim=1),
                     emit[:, 0])
    alphas = [alpha]
    for t in range(1, T):
        alpha = row_scan(alpha + blank_p[:, t - 1], emit[:, t])
        alphas.append(alpha)
    alphas = torch.stack(alphas)                             # (T, B, U+1)
    bb = torch.arange(B, device=logp.device)
    t_last = torch.clamp(input_lengths.long() - 1, 0, T - 1)
    u_last = torch.clamp(label_lengths.long(), 0, U)
    nll = -(alphas[t_last, bb, u_last] + blank_p[bb, t_last, u_last])
    return _reduce(nll, reduction)


# --------------------------------------------------------------- attention
@op("scaled_dot_product_attention", amp="white")
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 rng_key=None, dropout_p=0.0,
                                 is_causal=False, scale=None):
    """(batch, seq, heads, head_dim) attention through the port's flash
    path; a boolean mask keeps where True; a mask of fewer than 4 axes
    broadcasts from the right."""
    from .flash_attention import attention

    seed = None
    if dropout_p > 0.0 and rng_key is not None:
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=rng_key,
                             device=query.device, dtype=torch.int32)
    else:
        dropout_p = 0.0
    return attention(query, key, value, attention_mask(attn_mask, query),
                     is_causal, dropout_p, seed, scale)


def attention_mask(mask, query):
    """A boolean or lower-rank attention mask as the flash path's 4-D
    additive float mask: False -> -inf, leading axes of size 1."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        mask = torch.zeros(mask.shape, dtype=query.dtype,
                           device=mask.device).masked_fill(
            ~mask, float("-inf"))
    while mask.dim() < 4:
        mask = mask.unsqueeze(0)
    return mask


# --------------------------------------------------------------- resizing
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _resize_weights(n_in, n_out, kernel, device):
    """jax.image's `compute_weight_mat` (antialiased, translation 0): the
    (n_in, n_out) fp32 weights of one axis."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(
        torch.float32).eps, w / torch.where(total != 0, total,
                                            torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """jax.image.resize of NCHW x to `size` (or the floor of the scaled
    size): see the module docstring."""
    n, c, h, w = x.shape
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) else \
            (scale_factor, scale_factor)
        size = (int(h * sf[0]), int(w * sf[1]))
    out_hw = (int(size[0]), int(size[1]))
    method = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic",
              "linear": "linear"}[mode]
    if not x.is_floating_point():
        x = x.float()
    if method == "nearest":
        for axis, (m, o) in zip((2, 3), ((h, out_hw[0]), (w, out_hw[1]))):
            if m != o:
                idx = torch.floor((torch.arange(o, dtype=torch.float32,
                                                device=x.device) + 0.5)
                                  * m / o).long()
                x = torch.index_select(x, axis, idx)
        return x
    kernel = _triangle if method == "linear" else _keys_cubic
    out = x
    for axis, (m, o) in zip((2, 3), ((h, out_hw[0]), (w, out_hw[1]))):
        if m != o:
            wm = _resize_weights(m, o, kernel, x.device).to(x.dtype)
            out = torch.movedim(torch.movedim(out, axis, -1) @ wm, -1, axis)
    return out.to(x.dtype)


@op("pixel_shuffle")
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = upscale_factor
    if data_format == "NHWC":
        n, h, w, c = x.shape
        oc = c // (r * r)
        out = x.reshape(n, h, w, oc, r, r).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(n, h * r, w * r, oc)
    n, c, h, w = x.shape
    oc = c // (r * r)
    out = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return out.reshape(n, oc, h * r, w * r)


@op("channel_shuffle")
def channel_shuffle(x, groups, data_format="NCHW"):
    if data_format == "NHWC":
        n, h, w, c = x.shape
        return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)


@op("unfold")
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    return _F.unfold(x, _ntuple(kernel_sizes, 2), _ntuple(dilations, 2),
                     _ntuple(paddings, 2), _ntuple(strides, 2))


@op("fold")
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """col2im, overlapping patches summed."""
    (kh, kw), (sh, sw) = _ntuple(kernel_sizes, 2), _ntuple(strides, 2)
    (ph, pw), (dh, dw) = _ntuple(paddings, 2), _ntuple(dilations, 2)
    oh, ow = _ntuple(output_sizes, 2)
    n_h = (oh + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    n_w = (ow + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if n_h * n_w != x.shape[2]:
        raise ValueError(f"fold: L={x.shape[2]} inconsistent with "
                         f"output_sizes (expected {n_h * n_w} patches)")
    return _F.fold(x, (oh, ow), (kh, kw), (dh, dw), (ph, pw), (sh, sw))


@op("temporal_shift")
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    nt, c, h, w = x.shape
    x5 = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold_ = int(c * shift_ratio)
    left = torch.cat([x5[:, 1:, :fold_],
                      torch.zeros_like(x5[:, :1, :fold_])], dim=1)
    right = torch.cat([torch.zeros_like(x5[:, :1, fold_:2 * fold_]),
                       x5[:, :-1, fold_:2 * fold_]], dim=1)
    return torch.cat([left, right, x5[:, :, 2 * fold_:]], dim=2).reshape(
        nt, c, h, w)


@op("affine_grid")
def affine_grid(theta, out_shape, align_corners=True):
    """theta (N, 2, 3) -> the sampling grid (N, H, W, 2) in [-1, 1]."""
    n, _, h, w = [int(v) for v in out_shape]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2.0 + 1.0) / w - 1.0
        ys = (torch.arange(h, device=dev) * 2.0 + 1.0) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,njk->nhwj", base, theta.float()).to(theta.dtype)


@op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """x (N, C, H, W) sampled at the normalized grid (N, Hg, Wg, 2), the
    reference's corner gathers (nn_ops.py:1276-1334)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be 'bilinear' or "
                         f"'nearest', got {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"grid_sample padding_mode must be zeros/border/"
                         f"reflection, got {padding_mode!r}")
    n, c, h, w = x.shape
    g = grid.float()

    def unnorm(v, size):
        if align_corners:
            return (v + 1.0) / 2.0 * (size - 1)
        return ((v + 1.0) * size - 1.0) / 2.0

    gx, gy = unnorm(g[..., 0], w), unnorm(g[..., 1], h)

    def reflect(v, size):
        if size <= 1:
            return torch.zeros_like(v)
        span = 2.0 * (size - 1) if align_corners else 2.0 * size
        off = 0.0 if align_corners else 0.5
        v2 = torch.remainder(v + off, span)
        return torch.minimum(v2, span - v2) - off

    if padding_mode == "reflection":
        gx, gy = reflect(gx, w), reflect(gy, h)
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def sample(ix, iy):
        inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        cx = torch.clamp(ix, 0, w - 1).long()
        cy = torch.clamp(iy, 0, h - 1).long()
        v = x.permute(0, 2, 3, 1)[bidx, cy, cx]      # (n, hg, wg, c)
        if padding_mode == "zeros":
            v = v * inside[..., None].to(x.dtype)
        return v

    if mode == "nearest":
        out = sample(torch.round(gx), torch.round(gy))
    else:
        x0, y0 = torch.floor(gx), torch.floor(gy)
        wx = (gx - x0)[..., None].to(x.dtype)
        wy = (gy - y0)[..., None].to(x.dtype)
        out = (sample(x0, y0) * (1 - wx) * (1 - wy)
               + sample(x0 + 1, y0) * wx * (1 - wy)
               + sample(x0, y0 + 1) * (1 - wx) * wy
               + sample(x0 + 1, y0 + 1) * wx * wy)
    return out.permute(0, 3, 1, 2)
