"""Layers of the port (counterpart of paddle_tpu/nn/layer/norm.py:115
RMSNorm). Linear and Embedding are PyTorch's own `torch.nn` layers: their
parameter is `weight`, as in the JAX package, but `Linear.weight` is
(out, in) where paddle's is (in, out).
"""
from __future__ import annotations

import torch
from torch import nn

from . import functional as F

__all__ = ["RMSNorm"]


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
