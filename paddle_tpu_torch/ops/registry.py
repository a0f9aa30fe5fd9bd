"""The port's op table (counterpart of paddle_tpu/ops/registry.py and the
declarations of paddle_tpu/ops/ops.yaml).

Each op is a function over torch tensors, registered under the
reference's name with the reference's declaration: `amp_list` ('white',
'black' or None: the ops.yaml `amp:` field), `method` (the Tensor method
it binds under, or None), `multi_output` (returns a tuple),
`inplace_view` (a view op, never cast under amp) and `eager_only` (an
output shape that depends on the data). The op bodies live in
`ops.math`, `ops.manipulation`, `ops.reduction` and `ops.linalg`;
`core.dispatch.apply_op` runs them on Paddle Tensors. Autograd is not
declared per op: torch autograd records the bodies as they run.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["OpDef", "OPS", "register_op", "get_op"]


class OpDef:
    __slots__ = ("name", "fn", "multi_output", "inplace_view", "amp_list",
                 "eager_only", "method")

    def __init__(self, name: str, fn: Callable, multi_output: bool = False,
                 inplace_view: bool = False, amp_list: Optional[str] = None,
                 eager_only: bool = False, method: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.multi_output = multi_output
        self.inplace_view = inplace_view
        self.amp_list = amp_list
        self.eager_only = eager_only
        self.method = method

    def __repr__(self):
        return f"OpDef({self.name})"


OPS: Dict[str, OpDef] = {}


def register_op(name: str, amp: Optional[str] = None,
                method: Optional[str] = None, multi_output: bool = False,
                inplace_view: bool = False, eager_only: bool = False):
    """Decorator registering a function over torch tensors as op `name`."""

    def deco(fn: Callable):
        if name in OPS:
            raise ValueError(f"op {name!r} registered twice")
        OPS[name] = OpDef(name, fn, multi_output=multi_output,
                          inplace_view=inplace_view, amp_list=amp,
                          eager_only=eager_only, method=method)
        return fn

    return deco


def get_op(name: str) -> OpDef:
    _load()
    try:
        return OPS[name]
    except KeyError:
        raise KeyError(f"op {name!r} is not registered") from None


_LOADED = [False]


def _load():
    """Import the op bodies (once), which registers them."""
    if not _LOADED[0]:
        _LOADED[0] = True
        from . import linalg, manipulation, math, nn_ops, reduction  # noqa: F401
