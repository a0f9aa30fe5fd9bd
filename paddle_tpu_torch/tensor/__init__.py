"""paddle.tensor for the port: the functional API over Paddle Tensors
(counterpart of paddle_tpu/tensor/__init__.py), one function an op of
the op table (`ops.registry`) plus the creation and random functions and
the few that need more than one op. Every name here is also a top-level
name of the package (`paddle.add`, `paddle.to_tensor`)."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dispatch import apply_op
from ..core.dtype import convert_dtype
from ..core.tensor import Tensor
from ..ops.registry import OPS, _load, get_op
from . import creation, random
from .creation import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403

_FN_CACHE: dict = {}


def _make_fn(opname):
    # one function object an op, whatever namespace exports it
    if opname in _FN_CACHE:
        return _FN_CACHE[opname]
    op = get_op(opname)

    def fn(*args, **kwargs):
        return apply_op(op, *args, **kwargs)

    fn.__name__ = fn.__qualname__ = opname
    fn.__doc__ = (op.fn.__doc__ or "") + f"\n\n(framework op {opname!r})"
    _FN_CACHE[opname] = fn
    return fn


_load()
_g = globals()
for _name in OPS:
    if _name not in _g:
        _g[_name] = _make_fn(_name)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """(hist, [edges_0, ..., edges_{D-1}]), as paddle returns them."""
    out = apply_op(get_op("histogramdd"), x, bins=bins, ranges=ranges,
                   density=density, weights=weights)
    return out[0], list(out[1:])


def pow(x, y):
    if isinstance(y, (int, float)):
        return apply_op(get_op("pow_scalar"), x, value=y)
    return apply_op(get_op("elementwise_pow"), x, y)


def round(x):
    return apply_op(get_op("round"), x)


def chunk(x, chunks, axis=0):
    return apply_op(get_op("split"), x, num_or_sections=chunks, axis=axis)


def topk(x, k, axis=-1, largest=True, sorted=True):
    return Tensor.topk(x, k, axis=axis, largest=largest)


def unique(x, **kwargs):
    return Tensor.unique(x, **kwargs)


def nonzero(x, as_tuple=False):
    return Tensor.nonzero(x, as_tuple=as_tuple)


def masked_select(x, mask):
    return Tensor.masked_select(x, mask)


def einsum(equation, *operands):
    return apply_op(get_op("einsum"), list(operands), equation=equation)


def trace(x, offset=0, axis1=0, axis2=1):
    return apply_op(get_op("trace_op"), x, offset=offset, axis1=axis1,
                    axis2=axis2)


def slice(x, axes, starts, ends):
    return apply_op(get_op("slice_op"), x, axes=list(axes),
                    starts=list(starts), ends=list(ends))


def strided_slice(x, axes, starts, ends, strides):
    return apply_op(get_op("strided_slice"), x, axes=list(axes),
                    starts=list(starts), ends=list(ends),
                    strides=list(strides))


def increment(x, value=1.0):
    return x.add_(to_tensor(value, dtype=x.dtype, place=x.place))  # noqa


def unstack(x, axis=0, num=None):
    return list(apply_op(get_op("unbind"), x, axis=axis))


def split_fn(x, num_or_sections, axis=0):
    return apply_op(get_op("split"), x, num_or_sections=num_or_sections,
                    axis=axis)


def rank(x):
    """The number of dimensions as a 0-d int Tensor (paddle.rank)."""
    return Tensor(np.int32(len(x.shape)), place=x.place)


def shape(x):
    """The shape as a 1-D int Tensor (paddle.shape)."""
    return Tensor(np.asarray(list(x.shape), np.int32), place=x.place)


def is_floating_point(x):
    return x._t.is_floating_point()


def is_complex(x):
    return x._t.is_complex()


def is_integer(x):
    return not (x._t.is_floating_point() or x._t.is_complex()
                or x._t.dtype == torch.bool)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def crop(x, shape=None, offsets=None, name=None):
    """The `shape`-sized window at `offsets` (-1 in shape: to the end)."""
    def _as_list(v, default):
        if v is None:
            return default
        if isinstance(v, Tensor):
            return [int(i) for i in v.tolist()]
        return list(v)

    offs = _as_list(offsets, [0] * len(x.shape))
    shp = _as_list(shape, [-1] * len(x.shape))
    return x[tuple(builtins.slice(o, None if s == -1 else o + s)
                   for o, s in zip(offs, shp))]


def index_put(x, indices, value, accumulate=False, name=None):
    """Scatter `value` at the coordinate tensors `indices`."""
    return apply_op(get_op("index_put"), x, tuple(indices), value,
                    accumulate=accumulate)


#: Tensor-repr print options (numpy's own options are untouched)
PRINT_OPTIONS: dict = {}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    for key, value in (("precision", precision), ("threshold", threshold),
                       ("edgeitems", edgeitems), ("linewidth", linewidth)):
        if value is not None:
            PRINT_OPTIONS[key] = value
    if sci_mode is not None:
        PRINT_OPTIONS["suppress"] = not sci_mode


def cat(x, axis=0, name=None):
    return apply_op(get_op("concat"), x, axis=axis)


#: the same function as mod (paddle's floor_mod is mod)
floor_mod = _make_fn("mod")


def permute(x, *perm):
    if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
        perm = tuple(perm[0])
    return apply_op(get_op("transpose"), x, perm=list(perm))


def view(x, shape_or_dtype, name=None):
    """A shape view (reshape) or a dtype view over the same bytes."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return apply_op(get_op("reshape"), x, shape=list(shape_or_dtype))
    return Tensor._wrap(x._t.view(convert_dtype(shape_or_dtype)))


def view_as(x, other, name=None):
    return apply_op(get_op("reshape"), x, shape=list(other.shape))


def add_n(inputs, name=None):
    if isinstance(inputs, Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = apply_op(get_op("add"), out, t)
    return out


def broadcast_tensors(inputs, name=None):
    shape = list(np.broadcast_shapes(*[tuple(t.shape) for t in inputs]))
    return [apply_op(get_op("broadcast_to"), t, shape=shape)
            for t in inputs]


def multiplex(inputs, index, name=None):
    """Row-wise select: out[i] = inputs[index[i]][i]."""
    st = torch.stack([t._t for t in inputs])
    rows = torch.arange(st.shape[1], device=st.device)
    return Tensor._wrap(st[index._t.reshape(-1).long(), rows])


def tolist(x):
    return x.tolist()


def unfold(x, axis, size, step, name=None):
    return apply_op(get_op("tensor_unfold"), x, axis=axis, size=size,
                    step=step)


__all__ = sorted(n for n in globals() if not n.startswith("_") and n not in (
    "annotations", "builtins", "np", "torch", "apply_op", "convert_dtype",
    "OPS", "get_op", "creation", "random"))
del _g, _name
