"""Functional layer of the port (counterpart of
paddle_tpu/nn/functional/__init__.py:27, 236-258, 326, 676-696 and the
ops.yaml ops they dispatch to).

`rms_norm` and `layer_norm` reach the fused norm kernels (K4 forward, K5
backward) and `scaled_dot_product_attention` the flash-attention kernels
(K1 forward with dropout, K2 / K3 backward), as their JAX counterparts
reach the Pallas kernels; `linear`, `matmul`, `embedding`, `gelu`, `relu`,
`silu`, `tanh`, `dropout` and `mse_loss` (:536) are PyTorch's own
arithmetic, and the two cross-entropies live in `ops.cross_entropy`. The
ops of the amp lists cast their inputs through `amp.cast_inputs` first, as
the reference's dispatch does under `auto_cast`. `linear` takes PyTorch's
(out, in) weight layout: `weights.load_reference_state` transposes
paddle's (in, out) weights when they cross.

Randomness is explicit: `dropout` and attention dropout draw from the
`torch.Generator` they are given (on the tensors' device), never from
PyTorch's global generator.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _tF

from .. import amp
from ..ops import cross_entropy as _ce
from ..ops.flash_attention import attention as _attention
from ..ops.norm import layer_norm as _layer_norm
from ..ops.norm import rms_norm as _rms_norm

__all__ = ["linear", "matmul", "embedding", "silu", "gelu", "relu", "tanh",
           "dropout", "rms_norm", "layer_norm",
           "scaled_dot_product_attention", "cross_entropy",
           "fused_linear_cross_entropy", "mse_loss"]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    x, weight, bias = amp.cast_inputs("linear", x, weight, bias)
    return _tF.linear(x, weight, bias)


def matmul(x: torch.Tensor, y: torch.Tensor,
           transpose_y: bool = False) -> torch.Tensor:
    x, y = amp.cast_inputs("matmul", x, y)
    if transpose_y:
        y = y.transpose(-1, -2)
    return x @ y


def embedding(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return _tF.embedding(x, weight)


def silu(x: torch.Tensor) -> torch.Tensor:
    return _tF.silu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, exact (erf), paddle's default."""
    return _tF.gelu(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def _need_generator(generator, what):
    if generator is None:
        raise ValueError(f"{what} in training needs an explicit "
                         "torch.Generator (the port keeps no global random "
                         "state)")
    return generator


def dropout(x: torch.Tensor, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """upscale_in_train dropout (paddle's default mode): kept elements
    scaled by 1 / (1 - p), the keep mask drawn from `generator` (on x's
    device)."""
    if not training or p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout p must lie in [0, 1), got {p}")
    gen = _need_generator(generator, "dropout")
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x * (1.0 / (1.0 - p)), 0.0)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis through K4 / K5 (fp32 under O1)."""
    x, weight = amp.cast_inputs("rms_norm", x, weight)
    return _rms_norm(x, weight, epsilon)


def layer_norm(x: torch.Tensor, normalized_shape, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis through K4 / K5 (fp32 under O1)."""
    n = normalized_shape if isinstance(normalized_shape, int) else (
        normalized_shape[0] if len(normalized_shape) == 1 else None)
    if n != x.shape[-1] or weight is None:
        raise NotImplementedError(
            "layer_norm is ported over the last axis with a weight only "
            "(ROADMAP T2)")
    x, weight, bias = amp.cast_inputs("layer_norm", x, weight, bias)
    return _layer_norm(x, weight, bias, epsilon)


def scaled_dot_product_attention(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor,
                                 attn_mask: Optional[torch.Tensor] = None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True,
                                 generator: Optional[torch.Generator] = None
                                 ) -> torch.Tensor:
    """Layout (batch, seqlen, num_heads, head_dim), paddle's. Differentiable
    through K1 / K2 / K3, a trainable float mask included (its gradient from
    K2); under O1 the mask is cast with q, k and v, as the reference's
    dispatch casts every float input of the op. Attention dropout (when
    `training`) runs inside the kernels, keyed by one int32 seed drawn on
    the device from `generator`, so the host never waits for it."""
    query, key, value, attn_mask = amp.cast_inputs(
        "scaled_dot_product_attention", query, key, value, attn_mask)
    seed = None
    if not training or dropout_p <= 0.0:
        dropout_p = 0.0
    else:
        gen = _need_generator(generator, "attention dropout")
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             device=query.device, dtype=torch.int32)
    return _attention(query, key, value, attn_mask, is_causal, dropout_p,
                      seed)


def cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    (logits,) = amp.cast_inputs("cross_entropy", logits)
    return _ce.cross_entropy(logits, label, ignore_index, reduction)


def mse_loss(input: torch.Tensor, label: torch.Tensor,
              reduction: str = "mean") -> torch.Tensor:
    """mean / sum / none of (input - label)^2 (nn_ops.mse_loss): on neither
    amp list, so it computes in its inputs' type."""
    loss = torch.square(input - label)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               label: Optional[torch.Tensor] = None,
                               ignore_index: int = -100,
                               transpose_y: bool = False,
                               reduction: str = "mean",
                               chunk_size: int = 2048) -> torch.Tensor:
    x, weight, bias = amp.cast_inputs("fused_linear_cross_entropy", x,
                                      weight, bias)
    return _ce.fused_linear_cross_entropy(x, weight, bias, label,
                                          ignore_index, transpose_y,
                                          reduction, chunk_size)
