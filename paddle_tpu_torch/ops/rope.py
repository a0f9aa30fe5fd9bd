"""Rotary position embedding (port of the `rotary_position_embedding` op,
paddle_tpu/ops/ops.yaml:406-451).

NeoX rotate-half RoPE over (b, s, heads, head_dim) q and k, trig in fp32
and the result cast back to the input type (bf16-safe). `position_offset`
is a scalar (uniform prefill: positions offset .. offset+s-1), a (b,)
tensor (ragged decode: every row at its own offset) or a (b, s) tensor
that already holds the positions.

`rope_tables` and `apply_rope` split the op in two so that a model can
compute the cos/sin tables once per forward and apply them in every layer
(XLA shares them across layers by common-subexpression elimination;
eager PyTorch would recompute them 32 times).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["rotary_position_embedding", "rope_tables", "apply_rope"]


def rope_tables(s: int, head_dim: int, theta: float = 10000.0,
                position_offset: Union[int, torch.Tensor] = 0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (cos, sin) of shape (1 or b, s, 1, head_dim // 2)."""
    if head_dim % 2 != 0:
        raise ValueError(f"RoPE requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=device) * 2.0 / head_dim))
    if isinstance(position_offset, (int, float)):
        # a host scalar stays a host scalar: no tiny host-to-device copy
        pos = torch.arange(s, dtype=torch.float32, device=device) + float(
            position_offset)
        pos = pos[None]
    else:
        off = position_offset.to(device=device, dtype=torch.float32)
        if off.dim() == 0:
            pos = (torch.arange(s, dtype=torch.float32, device=device)
                   + off)[None]
        elif off.dim() == 2:
            pos = off
        else:
            pos = (torch.arange(s, dtype=torch.float32, device=device)[None]
                   + off[:, None])
    ang = pos[..., None] * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    half = q.shape[-1] // 2

    def rot(x):
        xc = x.float()
        x1, x2 = xc[..., :half], xc[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def rotary_position_embedding(q: torch.Tensor, k: torch.Tensor,
                              theta: float = 10000.0,
                              position_offset: Union[int, torch.Tensor] = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope_tables(q.shape[1], q.shape[-1], theta, position_offset,
                           q.device)
    return apply_rope(q, k, cos, sin)
