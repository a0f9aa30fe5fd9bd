"""Tensor creation under paddle's names (counterpart of
paddle_tpu/tensor/creation.py). New tensors land on the port's default
device ("cuda" unless `set_device("cpu")`) or on `place=`; the `_like`
forms follow their argument."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.tensor import Tensor, to_torch

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "logspace", "eye", "diagflat", "tril_indices", "triu_indices",
           "assign", "clone", "numel", "is_tensor", "complex", "as_complex",
           "as_real"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _dt(dtype, default=None):
    return convert_dtype(dtype) or default or get_default_dtype()


def _new(fn, *args, dtype, place=None):
    return Tensor._wrap(fn(*args, dtype=dtype, device=torch_device(place)))


def zeros(shape, dtype=None, name=None, place=None):
    return _new(torch.zeros, _shape(shape), dtype=_dt(dtype), place=place)


def ones(shape, dtype=None, name=None, place=None):
    return _new(torch.ones, _shape(shape), dtype=_dt(dtype), place=place)


def full(shape, fill_value, dtype=None, name=None, place=None):
    if dtype is None and isinstance(fill_value, int):
        dtype = "int64"
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    return _new(torch.full, _shape(shape), fill_value, dtype=_dt(dtype),
                place=place)


def empty(shape, dtype=None, name=None, place=None):
    return zeros(shape, dtype=dtype, place=place)


def _like(fn, x, *args, dtype=None):
    t = x._t if isinstance(x, Tensor) else to_torch(x)
    return Tensor._wrap(fn(t, *args, dtype=convert_dtype(dtype)))


def zeros_like(x, dtype=None, name=None):
    return _like(torch.zeros_like, x, dtype=dtype)


def ones_like(x, dtype=None, name=None):
    return _like(torch.ones_like, x, dtype=dtype)


def full_like(x, fill_value, dtype=None, name=None):
    return _like(torch.full_like, x, fill_value, dtype=dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, place=None):
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange bounds must be python scalars")
    if dtype is None:
        dtype = "int64" if all(isinstance(v, int)
                               for v in (start, end, step)) \
            else get_default_dtype()
    return _new(torch.arange, start, end, step, dtype=convert_dtype(dtype),
                place=place)


def linspace(start, stop, num, dtype=None, name=None, place=None):
    return _new(torch.linspace, start, stop, int(num),
                dtype=_dt(dtype, torch.float32), place=place)


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             place=None):
    return _new(torch.logspace, start, stop, int(num), base,
                dtype=_dt(dtype, torch.float32), place=place)


def eye(num_rows, num_columns=None, dtype=None, name=None, place=None):
    return _new(torch.eye, num_rows,
                num_rows if num_columns is None else num_columns,
                dtype=_dt(dtype), place=place)


def diagflat(x, offset=0, name=None):
    return Tensor._wrap(torch.diagflat(to_torch(x), offset))


def tril_indices(row, col, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, offset, col)
    return Tensor(np.stack([r, c]), dtype=dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r, c = np.triu_indices(row, offset, col if col is not None else row)
    return Tensor(np.stack([r, c]), dtype=dtype)


def assign(x, output=None):
    data = x._t if isinstance(x, Tensor) else to_torch(x)
    if output is None:
        return Tensor._wrap(data.clone())
    return output.set_value(Tensor._wrap(data))


def clone(x):
    return x.clone()


def numel(x):
    return Tensor(np.int64(x.size), place=x._t.device)


def is_tensor(x):
    return isinstance(x, Tensor)


def complex(real, imag):
    return Tensor._wrap(torch.complex(real._t, imag._t))


def as_complex(x):
    return Tensor._wrap(torch.complex(x._t[..., 0], x._t[..., 1]))


def as_real(x):
    return Tensor._wrap(torch.stack([x._t.real, x._t.imag], dim=-1))
