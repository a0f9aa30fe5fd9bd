"""The op dispatch (counterpart of paddle_tpu/core/dispatch.py:52
`apply_op`).

`apply_op(opdef, *args, **kwargs)` unwraps every Paddle Tensor among the
arguments (lists and tuples included) to its torch tensor, turns numpy
arrays into tensors on the first tensor's device, asks
`amp.cast_inputs` for the positional tensors' types under `auto_cast` by
the op's name and `amp:` declaration (view ops are never cast, as the
reference's `_amp_handler`), runs the op's torch body and wraps what it
returns: a tuple of Tensors for a multi-output op, else one Tensor. Torch
autograd records the body as it runs, so there is no tape here; an output
needs grad exactly when one of its inputs does and it is floating.
`FLAGS_check_nan_inf` makes every floating output checked on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import amp as _amp
from .flags import get_flag

__all__ = ["apply_op", "unwrap", "wrap_out"]


def _tensor_cls():
    from .tensor import Tensor

    return Tensor


def _np_to_torch(a: np.ndarray, device) -> torch.Tensor:
    from .dtype import get_default_dtype

    if a.dtype == np.float64:
        return torch.tensor(a, dtype=get_default_dtype(), device=device)
    if a.dtype == np.complex128:
        return torch.tensor(a, dtype=torch.complex64, device=device)
    return torch.tensor(a, device=device)


def unwrap(a, device=None):
    """`a` with every Paddle Tensor replaced by its torch tensor and every
    numpy array by a tensor on `device` (lists and tuples rebuilt)."""
    Tensor = _tensor_cls()
    if isinstance(a, Tensor):
        return a._t
    if isinstance(a, (list, tuple)):
        return type(a)(unwrap(x, device) for x in a) if type(a) in (
            list, tuple) else a
    if isinstance(a, np.ndarray):
        return _np_to_torch(a, device)
    return a


def _first_device(args):
    Tensor = _tensor_cls()
    for a in args:
        if isinstance(a, Tensor):
            return a._t.device
        if isinstance(a, (list, tuple)):
            d = _first_device(a)
            if d is not None:
                return d
    return None


def _cast(a, opdef):
    if isinstance(a, torch.Tensor):
        return _amp.cast_inputs(opdef.name, a, amp_list=opdef.amp_list)[0]
    if type(a) in (list, tuple):
        return type(a)(_cast(x, opdef) for x in a)
    return a


def wrap_out(out, multi=False):
    Tensor = _tensor_cls()
    if isinstance(out, torch.Tensor):
        return (Tensor._wrap(out),) if multi else Tensor._wrap(out)
    if isinstance(out, (tuple, list)):
        return tuple(Tensor._wrap(o) if isinstance(o, torch.Tensor) else o
                     for o in out)
    return out


def _check_finite(name, out):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if (isinstance(o, torch.Tensor) and o.is_floating_point()
                and not bool(torch.isfinite(o).all())):
            raise FloatingPointError(f"op {name!r} produced nan/inf output")


def apply_op(opdef, *args, **kwargs):
    """Run registered op `opdef` on Tensor / array / scalar arguments."""
    dev = _first_device(args)
    targs = [unwrap(a, dev) for a in args]
    if kwargs:
        kwargs = {k: unwrap(v, dev) for k, v in kwargs.items()}
    if _amp._STATE["enabled"] and not opdef.inplace_view:
        targs = [_cast(a, opdef) for a in targs]
    out = opdef.fn(*targs, **kwargs)
    if get_flag("FLAGS_check_nan_inf"):
        _check_finite(opdef.name, out)
    return wrap_out(out, opdef.multi_output)
