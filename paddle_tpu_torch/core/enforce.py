"""Error-checking layer (the port's copy of paddle_tpu/core/enforce.py).

`enforce(cond, msg)` raises EnforceNotMet with a captured Python stack, as
PADDLE_ENFORCE's stacktraced errors do.
"""
from __future__ import annotations

import traceback

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "UnimplementedError", "enforce", "enforce_eq",
           "enforce_shape_match"]


class EnforceNotMet(RuntimeError):
    """Invariant violation (paddle's PADDLE_ENFORCE)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, KeyError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


def enforce(cond, msg: str = "enforce failed", exc=EnforceNotMet):
    if not cond:
        stack = "".join(traceback.format_stack()[:-1][-6:])
        raise exc(f"{msg}\n----- python call stack -----\n{stack}")


def enforce_eq(a, b, msg: str = ""):
    enforce(a == b, f"expected {a!r} == {b!r}. {msg}", InvalidArgumentError)


def enforce_shape_match(shape_a, shape_b, msg: str = ""):
    enforce(
        tuple(shape_a) == tuple(shape_b),
        f"shape mismatch: {tuple(shape_a)} vs {tuple(shape_b)}. {msg}",
        InvalidArgumentError,
    )
