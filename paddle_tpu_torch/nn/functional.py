"""Functional layer of the port (counterpart of
paddle_tpu/nn/functional/__init__.py:27-31, 140, 261, 368, 676).

`rms_norm` reaches the fused norm kernel and `scaled_dot_product_attention`
the flash-attention kernel, as their JAX counterparts reach the Pallas
kernels; `linear`, `embedding` and `silu` are PyTorch's own. `linear`
takes PyTorch's (out, in) weight layout: `weights.load_reference_state`
transposes paddle's (in, out) weights when they cross.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF

from ..ops.flash_attention import flash_attention
from ..ops.norm import rms_norm as _rms_norm

__all__ = ["linear", "embedding", "silu", "rms_norm",
           "scaled_dot_product_attention"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _tF.linear(x, weight, bias)


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return _tF.embedding(x, weight)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _tF.silu(x)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    return _rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True) -> torch.Tensor:
    """Layout (batch, seqlen, num_heads, head_dim), paddle's. Attention
    dropout is not ported yet (it belongs to the training slice)."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP queue 2: K1 "
            "dropout, with the training slice)")
    return flash_attention(query, key, value, attn_mask, is_causal)
