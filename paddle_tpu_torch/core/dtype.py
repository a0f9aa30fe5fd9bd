"""Dtypes under paddle's names (counterpart of paddle_tpu/core/dtype.py).

The dtype objects are PyTorch's own (`paddle.float32 is torch.float32`),
so a dtype taken from a Tensor goes straight back into any creation op or
torch call. `convert_dtype` takes a name, a numpy dtype, a torch dtype or
None. `finfo` / `iinfo` are the reference's, read from torch.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "dtype_name", "set_default_dtype",
           "get_default_dtype", "is_floating_point", "is_integer",
           "is_complex", "iinfo", "finfo", "to_numpy_dtype"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME2DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    # paddle's legacy aliases
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
}
_DTYPE2NAME = {d: n for n, d in list(_NAME2DTYPE.items())[:12]}

_DEFAULT_DTYPE = [float32]


def convert_dtype(dtype):
    """Any dtype spec (a name, a numpy or torch dtype, a numpy scalar type)
    as a torch.dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype[len("paddle."):] if dtype.startswith("paddle.") \
            else dtype
        if name in _NAME2DTYPE:
            return _NAME2DTYPE[name]
        dtype = np.dtype(name)
    name = np.dtype(dtype).name
    if name not in _NAME2DTYPE:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _NAME2DTYPE[name]


def dtype_name(dtype) -> str:
    return _DTYPE2NAME[convert_dtype(dtype)]


def to_numpy_dtype(dtype):
    """The numpy dtype that holds `dtype`'s values (bfloat16: float32,
    numpy having no bfloat16)."""
    d = convert_dtype(dtype)
    return np.dtype("float32" if d == bfloat16 else dtype_name(d))


def set_default_dtype(dtype):
    d = convert_dtype(dtype)
    if d not in (float16, bfloat16, float32, float64):
        raise ValueError(f"default dtype must be floating, got {d}")
    _DEFAULT_DTYPE[0] = d


def get_default_dtype():
    return _DEFAULT_DTYPE[0]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in (float16, bfloat16, float32, float64)


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d == bool_ or not (d.is_floating_point or d.is_complex)


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


class iinfo:
    """paddle.iinfo: an integer dtype's limits."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.iinfo(d)
        self.min, self.max, self.bits = int(info.min), int(info.max), \
            info.bits
        self.dtype = dtype_name(d)

    def __repr__(self):
        return (f"paddle.iinfo(min={self.min}, max={self.max}, "
                f"bits={self.bits}, dtype={self.dtype})")


class finfo:
    """paddle.finfo: a floating dtype's limits."""

    def __init__(self, dtype):
        d = convert_dtype(dtype)
        info = torch.finfo(d)
        self.min, self.max = float(info.min), float(info.max)
        self.eps = float(info.eps)
        self.tiny = self.smallest_normal = float(info.tiny)
        self.resolution = float(info.resolution)
        self.bits = info.bits
        self.dtype = dtype_name(d)

    def __repr__(self):
        return (f"paddle.finfo(min={self.min}, max={self.max}, "
                f"eps={self.eps}, bits={self.bits}, dtype={self.dtype})")
