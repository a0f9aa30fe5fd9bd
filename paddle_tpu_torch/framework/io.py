"""paddle.save / paddle.load for the port (counterpart of
paddle_tpu/framework/io.py): a pickle of nested state (dicts, lists,
tuples) over Paddle Tensors.

A Tensor (a Parameter too) or a torch tensor is pickled as the JAX
package's record: its numpy array, stop_gradient and name under the same
marker key, so either package loads what the other saved, and a file
never holds device memory. numpy has no bfloat16, so the port writes one
as float32 with a "dtype" entry that restores it (the JAX package reads
that array as float32), and reads the JAX package's bfloat16 arrays
(ml_dtypes') as float32 widened exactly and cast back. `load` gives
Paddle Tensors on the port's default device (or `place=`), in their
saved types, or numpy arrays with `return_numpy=True`.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.tensor import Tensor

__all__ = ["save", "load"]

_SENTINEL = "__paddle_tpu_tensor__"     # the JAX package's marker


def _pack(obj):
    if isinstance(obj, (Tensor, torch.Tensor)):
        t = obj._t if isinstance(obj, Tensor) else obj
        dtype = str(t.dtype).replace("torch.", "")
        data = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            data = data.float()
        return {_SENTINEL: True, "data": data.numpy(), "dtype": dtype,
                "stop_gradient": not t.requires_grad,
                "name": obj.name if isinstance(obj, Tensor) else ""}
    if isinstance(obj, dict):
        return type(obj)((k, _pack(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy=False, place=None):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL):
            arr, dtype = obj["data"], obj.get("dtype")
            if return_numpy:
                return arr
            if arr.dtype.name == "bfloat16":    # the JAX package's bf16
                arr, dtype = arr.astype(np.float32), "bfloat16"
            t = Tensor(arr, dtype=dtype, place=place,
                       stop_gradient=obj.get("stop_gradient", True))
            t.name = obj.get("name", "")
            return t
        return type(obj)((k, _unpack(v, return_numpy, place))
                         for k, v in obj.items())
    if isinstance(obj, list):
        return [_unpack(v, return_numpy, place) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy, place) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Write a Tensor, a state dict or any nested structure to `path` (a
    file name, its directories made, or a binary file object)."""
    if isinstance(path, (str, os.PathLike)):
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(_pack(obj), f, protocol=protocol)
    else:
        pickle.dump(_pack(obj), path, protocol=protocol)


def load(path, **configs):
    """What `save` wrote: Tensors on `place` (default: the port's default
    device), or numpy arrays with `return_numpy=True`."""
    if isinstance(path, (str, os.PathLike)):
        with open(path, "rb") as f:
            raw = pickle.load(f)
    else:
        raw = pickle.load(path)
    return _unpack(raw, configs.get("return_numpy", False),
                   configs.get("place"))
