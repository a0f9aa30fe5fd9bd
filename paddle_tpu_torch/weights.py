"""Carry weights from the JAX package into the port, by name.

`load_reference_state(model, params)` takes the dict that the reference's
`extract_state` (paddle_tpu/jit/functional.py:21) returns, keyed by
`named_parameters()` names, with values as numpy arrays (or anything
`np.asarray` takes), and copies it into the port's model in place.
Paddle's `Linear.weight` is (in, out) and PyTorch's is (out, in), so
Linear weights are transposed; Embedding and RMSNorm weights cross as they
are. A missing or extra key, or a shape that does not match, raises.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state"]


@torch.no_grad()
def load_reference_state(model: nn.Module, params: Mapping[str, object]
                         ) -> None:
    own = dict(model.named_parameters())
    missing = sorted(own.keys() - params.keys())
    extra = sorted(params.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"reference state does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    linear = {f"{name}.weight" for name, mod in model.named_modules()
              if isinstance(mod, nn.Linear)}
    for name, p in own.items():
        # via fp32: numpy has no bfloat16, and the copy casts to p's type
        arr = np.asarray(params[name], dtype=np.float32)
        if name in linear:
            arr = arr.T
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {arr.shape} does not "
                             f"match the port's {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
