"""Layers of the port under paddle's names (counterparts of
paddle_tpu/nn/layer/norm.py RMSNorm and LayerNorm, common.py Linear and
Dropout). Embedding is PyTorch's own `torch.nn.Embedding`. `Linear` is
`torch.nn.Linear` (so its weight is (out, in) where paddle's is (in, out))
whose forward goes through the port's `F.linear`, so that `amp.auto_cast`
sees it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm", "LayerNorm", "Linear", "Dropout"]


class RMSNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(
            self.normalized_shape, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, self.weight, epsilon=self.epsilon)

    def extra_repr(self) -> str:
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


class LayerNorm(nn.Module):
    """LayerNorm over the last axis: weight ones, bias zeros."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.epsilon = epsilon
        fk = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(self.normalized_shape, **fk))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape, **fk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self) -> str:
        return f"{self.normalized_shape}, epsilon={self.epsilon}"


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Dropout(nn.Module):
    """upscale_in_train dropout; the forward takes the generator to draw
    from (needed in training mode when p > 0)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return F.dropout(x, self.p, self.training, generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"
