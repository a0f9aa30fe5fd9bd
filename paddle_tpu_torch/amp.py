"""Automatic mixed precision: paddle's `auto_cast` at level O1 for the ops
the port has (counterpart of paddle_tpu/amp/__init__.py:22-120).

The reference casts at op dispatch: a white-listed op runs in the amp type
(bf16), a black-listed op in fp32, and every other op in the type of its
inputs. The port keeps its own copy of that policy for its ops, taken from
the `amp:` fields of paddle_tpu/ops/ops.yaml (never read at run time):

    white: linear (:2114), matmul (:1765), scaled_dot_product_attention
           (:2197), fused_linear_cross_entropy (:2126)
    black: layer_norm (:2062), rms_norm (:2068), cross_entropy (:2120)

`gelu`, `relu`, `dropout`, `embedding`, `tanh`, `mse_loss` (:2138) and
additions are in neither list and follow their inputs. The port's functional layer
(`nn.functional`) asks `cast_inputs(op, ...)` before each listed op, so
under O1 the residual stream and every norm stay fp32 while the products
and attention run in bf16; gradients flow back through the casts into the
fp32 parameters.

The cast is the one of the reference's op dispatch (paddle_tpu/core/
dispatch.py:67-68), which casts EVERY float input of a listed op: for
`scaled_dot_product_attention` that includes a float attention mask, so
T5's trainable position bias enters attention in bf16 and its gradient
flows back through that cast. That dispatch is what the JAX package runs on
the CPU, in its tests and in the port's parity tests. Its TPU flash path
(`apply_callable`, dispatch.py:125) casts nothing; the port follows the op
dispatch.

`torch.autocast` is not used: it keys its own lists on aten ops (its fp32
list alone covers exp, log, pow, sum and more than the reference casts),
it does not see inside the port's custom autograd Functions, and it runs
on CUDA and CPU with different lists, so it would not give the reference's
cast on every op of the step. The casts here are the same on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["auto_cast", "cast_inputs", "WHITE_LIST", "BLACK_LIST"]

WHITE_LIST = frozenset({"linear", "matmul", "scaled_dot_product_attention",
                        "fused_linear_cross_entropy"})
BLACK_LIST = frozenset({"layer_norm", "rms_norm", "cross_entropy"})

_STATE = {"enabled": False, "dtype": torch.bfloat16}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class auto_cast:
    """Context manager enabling autocast (paddle.amp.auto_cast). Levels:
    O0 (off) and O1 (white list in `dtype`, black list in fp32)."""

    def __init__(self, level: str = "O1", dtype: str = "bfloat16"):
        if level in ("O2", "OD"):
            raise NotImplementedError(
                f"auto_cast level {level} is not ported yet (ROADMAP T4: "
                "amp O2 with fp32 master weights)")
        if level not in ("O0", "O1"):
            raise ValueError(f"level must be O0/OD/O1/O2, got {level!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"amp dtype must be bfloat16 or float16, got "
                             f"{dtype!r}")
        self.enable = level == "O1"
        self.dtype = _DTYPES[dtype]
        self._saved = None

    def __enter__(self):
        self._saved = dict(_STATE)
        _STATE.update(enabled=self.enable, dtype=self.dtype)
        return self

    def __exit__(self, *exc):
        _STATE.update(self._saved)
        return False


def cast_inputs(op: str, *tensors: Optional[torch.Tensor]
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """`tensors` cast as the O1 policy casts op `op`'s inputs: floating
    tensors to the amp type (white) or fp32 (black); None, integer tensors
    and unlisted ops pass through."""
    if not _STATE["enabled"]:
        return tensors
    if op in WHITE_LIST:
        target = _STATE["dtype"]
    elif op in BLACK_LIST:
        target = torch.float32
    else:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)
