"""Shape, layout, indexing and scatter ops of the op table (counterparts
of paddle_tpu/ops/manipulation.py and the inline manipulation entries of
ops.yaml), as torch code over torch tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from .math import _t
from .registry import register_op as op


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


@op("reshape", inplace_view=True)
def reshape(x, shape):
    return torch.reshape(x, tuple(int(s) for s in shape))


@op("flatten", inplace_view=True)
def flatten(x, start_axis=0, stop_axis=-1):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())


@op("squeeze", inplace_view=True)
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    axes = tuple(a % x.dim() for a in _axes(axis))
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


@op("unsqueeze", inplace_view=True)
def unsqueeze(x, axis):
    out = x
    for a in sorted(_axes(axis)):
        out = torch.unsqueeze(out, a)
    return out


@op("split", multi_output=True)
def split(x, num_or_sections, axis=0):
    axis = int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        n = num_or_sections
        if dim % n != 0:
            raise ValueError(f"cannot split dim {dim} into {n} equal parts")
        sizes = [dim // n] * n
    else:
        sizes = [int(s) for s in num_or_sections]
        if -1 in sizes:
            known = sum(s for s in sizes if s != -1)
            sizes = [dim - known if s == -1 else s for s in sizes]
    return tuple(torch.split(x, sizes, dim=axis))


@op("unbind", multi_output=True)
def unbind(x, axis=0):
    return tuple(torch.unbind(x, int(axis)))


@op("expand")
def expand(x, shape):
    shape = list(shape)
    xshape = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    out = tuple(xshape[i] if shape[i] == -1 else int(shape[i])
                for i in range(len(shape)))
    return torch.broadcast_to(x.reshape(xshape), out)


@op("broadcast_to")
def broadcast_to(x, shape):
    return torch.broadcast_to(x, tuple(int(s) for s in shape))


@op("tile")
def tile(x, repeat_times):
    return torch.tile(x, tuple(int(r) for r in repeat_times))


@op("cast", inplace_view=True)
def cast(x, dtype):
    from ..core.dtype import convert_dtype

    return x.to(convert_dtype(dtype))


@op("gather")
def gather(x, index, axis=0):
    index = index.reshape(-1) if index.dim() > 1 else index
    return torch.index_select(x, int(axis), index.long())


@op("gather_nd")
def gather_nd(x, index):
    return x[tuple(torch.movedim(index.long(), -1, 0))]


@op("put_along_axis")
def put_along_axis(x, indices, values, axis, reduce="assign"):
    values = torch.broadcast_to(_t(values, x), indices.shape).to(x.dtype)
    indices = indices.long()
    if reduce == "assign":
        return torch.scatter(x, axis, indices, values)
    if reduce in ("add", "sum"):
        return torch.scatter_add(x, axis, indices, values)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(x, axis, indices, values, "prod")
    raise ValueError(f"unsupported reduce mode {reduce!r}")


@op("scatter")
def scatter(x, index, updates, overwrite=True):
    idx = (index.reshape(-1).long(),)
    updates = updates.to(x.dtype)
    if overwrite:
        return x.index_put(idx, updates)
    zeroed = x.index_put(idx, torch.zeros_like(updates))
    return zeroed.index_put(idx, updates, accumulate=True)


@op("scatter_nd_add")
def scatter_nd_add(x, index, updates):
    return x.index_put(tuple(torch.movedim(index.long(), -1, 0)),
                       updates.to(x.dtype), accumulate=True)


@op("flip")
def flip(x, axis):
    return torch.flip(x, _axes(axis))


@op("sort")
def sort(x, axis=-1, descending=False, stable=False):
    out = torch.sort(x, dim=axis, stable=stable).values
    return torch.flip(out, (axis,)) if descending else out


@op("argsort")
def argsort(x, axis=-1, descending=False, stable=False):
    return torch.argsort(x, dim=axis, descending=descending, stable=stable)


@op("topk_indices")
def topk_indices(x, k, axis=-1, largest=True):
    return torch.topk(x, k, dim=axis, largest=largest).indices


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i % n
    # reflect (the edge element not repeated)
    period = 2 * (n - 1)
    i = i.abs() % period if period else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@op("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW"):
    # paddle's F.pad: `pad` lists (lo, hi) per axis, innermost axes first
    # for the NC* forms, or covers all 2 * ndim entries
    ndim = x.dim()
    pads = [int(p) for p in pad]
    if len(pads) == 2 * ndim:
        cfg = [(pads[2 * i], pads[2 * i + 1]) for i in range(ndim)]
    else:
        n_spatial = len(pads) // 2
        spatial = [(pads[2 * i], pads[2 * i + 1]) for i in range(n_spatial)]
        if data_format.startswith("NC"):
            cfg = [(0, 0)] * (ndim - n_spatial) + spatial[::-1]
        else:
            cfg = [(0, 0)] + spatial[::-1] + [(0, 0)]
    if len(pads) == 2 and ndim >= 3 and data_format.startswith("NC"):
        cfg = [(0, 0)] * (ndim - 1) + [(pads[0], pads[1])]
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return _F.pad(x, flat, mode="constant", value=value)
    out = x
    for axis, (lo, hi) in enumerate(cfg):
        if lo or hi:
            out = torch.index_select(out, axis, _pad_index(
                out.shape[axis], lo, hi, mode, x.device))
    return out


@op("diag")
def diag(x, offset=0, padding_value=0.0):
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0.0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, _t(padding_value, x).to(out.dtype))
    return out


@op("diag_embed")
def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    return torch.diag_embed(x, offset, dim1, dim2)


@op("slice_op", inplace_view=True)
def slice_op(x, axes, starts, ends):
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        idx[ax] = slice(st, en)
    return x[tuple(idx)]


@op("strided_slice", inplace_view=True)
def strided_slice(x, axes, starts, ends, strides):
    out = x
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        rng = range(*slice(st, en, sd).indices(x.shape[ax]))
        out = torch.index_select(out, ax, torch.tensor(
            list(rng), dtype=torch.long, device=x.device))
    return out


@op("as_strided", inplace_view=True)
def as_strided(x, shape, stride, offset=0):
    flat = x.reshape(-1)
    idx = torch.full(tuple(shape), offset, dtype=torch.long,
                     device=x.device)
    for d, (s, st) in enumerate(zip(shape, stride)):
        r = torch.arange(s, device=x.device) * st
        idx = idx + r.reshape((-1,) + (1,) * (len(shape) - d - 1))
    return flat[idx]


@op("one_hot")
def one_hot(x, num_classes):
    return _F.one_hot(x.long(), num_classes).to(torch.float32)


@op("set_value_by_index")
def set_value_by_index(x, value, _index_tree=None):
    raise NotImplementedError(
        "set_value_by_index is the reference's Program-mode carrier of "
        "__setitem__; the port's Tensor.__setitem__ writes directly")


@op("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, _t(values, sorted_sequence),
                              out_int32=out_int32, right=right)


# ---------------------------------------------- ops.yaml: manipulation
@op("atleast_1d")
def atleast_1d(x):
    return torch.atleast_1d(x)


@op("atleast_2d")
def atleast_2d(x):
    return torch.atleast_2d(x)


@op("atleast_3d")
def atleast_3d(x):
    return torch.atleast_3d(x)


@op("hstack")
def hstack(xs):
    return torch.hstack(list(xs))


@op("vstack")
def vstack(xs):
    return torch.vstack(list(xs))


@op("dstack")
def dstack(xs):
    return torch.dstack(list(xs))


@op("column_stack")
def column_stack(xs):
    return torch.column_stack(list(xs))


@op("row_stack")
def row_stack(xs):
    return torch.vstack(list(xs))


def _sections(num_or_indices):
    return num_or_indices if isinstance(num_or_indices, int) \
        else [int(i) for i in num_or_indices]


@op("hsplit", multi_output=True)
def hsplit(x, num_or_indices):
    return tuple(torch.hsplit(x, _sections(num_or_indices)))


@op("vsplit", multi_output=True)
def vsplit(x, num_or_indices):
    return tuple(torch.vsplit(x, _sections(num_or_indices)))


@op("dsplit", multi_output=True)
def dsplit(x, num_or_indices):
    return tuple(torch.dsplit(x, _sections(num_or_indices)))


@op("tensor_split", method="tensor_split", multi_output=True)
def tensor_split(x, num_or_indices, axis=0):
    return tuple(torch.tensor_split(x, _sections(num_or_indices), dim=axis))


@op("unflatten", method="unflatten")
def unflatten(x, axis, shape):
    axis = axis % x.dim()
    return torch.reshape(x, tuple(x.shape[:axis]) + tuple(shape)
                         + tuple(x.shape[axis + 1:]))


@op("block_diag")
def block_diag(xs):
    return torch.block_diag(*[torch.atleast_2d(a) for a in xs])


@op("bucketize", method="bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False):
    return torch.searchsorted(sorted_sequence, x, out_int32=out_int32,
                              right=right)


@op("index_fill", method="index_fill")
def index_fill(x, index, axis, value):
    return torch.index_fill(x, axis, index.long(), _t(value, x).to(x.dtype))


@op("index_put", method="index_put")
def index_put(x, indices, value, accumulate=False):
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    return x.index_put(idx, _t(value, x).to(x.dtype), accumulate=accumulate)


@op("masked_select", method="masked_select", eager_only=True)
def masked_select(x, mask):
    return x[torch.broadcast_to(mask.to(torch.bool), x.shape)]


@op("index_add", method="index_add")
def index_add(x, index, axis, value):
    return torch.index_add(x, axis, index.long(), value.to(x.dtype))


@op("take", method="take")
def take(x, index, mode="raise"):
    flat = x.reshape(-1)
    idx = index.reshape(-1).long()
    if mode == "wrap":
        idx = idx % flat.shape[0]
    elif mode == "clip":
        idx = idx.clamp(0, flat.shape[0] - 1)
    return flat[idx].reshape(index.shape)


@op("masked_scatter", method="masked_scatter")
def masked_scatter(x, mask, value):
    mask = torch.broadcast_to(mask.to(torch.bool), x.shape)
    return torch.masked_scatter(x, mask, value.to(x.dtype))


@op("scatter_nd")
def scatter_nd(index, updates, shape):
    out = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                      device=updates.device)
    return out.index_put(tuple(torch.movedim(index.long(), -1, 0)), updates,
                         accumulate=True)


@op("select_scatter", method="select_scatter")
def select_scatter(x, values, axis, index):
    return torch.select_scatter(x, values.to(x.dtype), axis, index)


@op("slice_scatter", method="slice_scatter")
def slice_scatter(x, value, axes=None, starts=None, ends=None, strides=None):
    if axes is None:
        return torch.broadcast_to(value, x.shape).to(x.dtype).clone()
    out = x.clone()
    idx = [slice(None)] * x.dim()
    for ax, st, en, sr in zip(axes, starts, ends, strides):
        idx[ax] = slice(st, en, sr)
    out[tuple(idx)] = value.to(x.dtype)
    return out


@op("diagonal_scatter", method="diagonal_scatter")
def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1):
    return torch.diagonal_scatter(x, y.to(x.dtype), offset, axis1, axis2)


@op("combinations")
def combinations(x, r=2, with_replacement=False):
    return torch.combinations(x, r, with_replacement)


@op("unique_consecutive", eager_only=True)
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    res = torch.unique_consecutive(x, return_inverse=return_inverse,
                                   return_counts=return_counts, dim=axis)
    if not isinstance(res, tuple):
        return res
    if return_inverse and axis is None:
        res = (res[0], res[1].reshape(-1)) + tuple(res[2:])
    return res


@op("tensor_unfold", method="unfold")
def tensor_unfold(x, axis, size, step):
    return x.unfold(axis % x.dim(), size, step)


@op("pixel_unshuffle")
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    r = int(downscale_factor)
    if data_format == "NCHW":
        return _F.pixel_unshuffle(x, r)
    n, h, w, c = x.shape
    out = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return out.reshape(n, h // r, w // r, c * r * r)


@op("transpose", inplace_view=True)
def transpose(x, perm):
    return x.permute(tuple(int(p) for p in perm))


@op("concat")
def concat(xs, axis=0):
    return torch.cat(list(xs), dim=int(axis))


@op("stack")
def stack(xs, axis=0):
    return torch.stack(list(xs), dim=int(axis))


@op("expand_as")
def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


@op("index_select")
def index_select(x, index, axis=0):
    return torch.index_select(x, int(axis), index.reshape(-1).long())


@op("index_sample")
def index_sample(x, index):
    return torch.take_along_dim(x, index.long(), dim=1)


@op("take_along_axis")
def take_along_axis(x, indices, axis, broadcast=True):
    return torch.take_along_dim(x, indices.long(), dim=int(axis))


@op("where")
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@op("roll")
def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, _axes(axis))


@op("repeat_interleave")
def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


@op("tril")
def tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@op("triu")
def triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@op("diagonal")
def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2)


@op("kron")
def kron(x, y):
    return torch.kron(x, y)


@op("moveaxis", inplace_view=True)
def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


@op("swapaxes", inplace_view=True)
def swapaxes(x, axis1, axis2):
    return torch.swapaxes(x, axis1, axis2)


@op("rot90")
def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


@op("meshgrid", multi_output=True)
def meshgrid(xs, indexing="ij"):
    return tuple(torch.meshgrid(*list(xs), indexing=indexing))


@op("masked_fill")
def masked_fill(x, mask, value):
    return torch.where(mask.to(torch.bool), _t(value, x).to(x.dtype), x)


@op("full_like")
def full_like(x, fill_value, dtype=None):
    from ..core.dtype import convert_dtype

    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))


@op("bincount", eager_only=True)
def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights, minlength)
