"""Ring attention and Ulysses over the sequence-parallel group (counterpart
of paddle_tpu/distributed/fleet/meta_parallel/ring_attention.py).

Both take this rank's [batch, heads, s_local, head_dim] shards of q, k and
v, the sequence split over the group's ranks in rank order, and return
this rank's shard of the output; both are differentiable.

- `ring_flash_attention`: the key / value shards rotate around the ring
  while each rank's query shard attends to them, through the ring form of
  the flash kernels (`ops.ring_flash`): memory O(s / n), no O(s^2) buffer.
- `ulysses_attention`: an all-to-all trades the sequence split for a head
  split, every rank runs full-sequence flash attention on its heads, and a
  second all-to-all trades back (DeepSpeed-Ulysses).

With one rank both are plain flash attention of the local shard (the
reference's `_flash_block` outside a named axis). CUDA tensors run the
kernels; CPU tensors their plain versions, inside the same loops. The
reference's `impl=` and `interpret=` select among its XLA and Pallas
paths and have no counterpart here; its `axis_name` names a mesh axis,
which the group replaces. Its Ulysses runs the flash kernel only at the
default scale (:182-185); the port's kernels take any scale, so every
scale runs them.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....ops.flash_attention import _scale
from ....ops.ring_flash import ring_flash_attention_kernels, ulysses_flash
from ...communication import _resolve, all_to_all
from ...group import Group

__all__ = ["ring_flash_attention", "ulysses_attention", "RingFlashAttention"]


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: Optional[Group] = None, causal: bool = False,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of (b, h, s_local, d) shards over `group` (the
    default group when None)."""
    g = _resolve(group)
    scale = _scale(scale, q.shape[-1])
    if g.nranks == 1:
        return ulysses_flash(q, k, v, scale, causal)
    return ring_flash_attention_kernels(q, k, v, g, causal, scale)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: Optional[Group] = None, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses attention of (b, h, s_local, d) shards over `group`; the
    heads must divide over its ranks."""
    g = _resolve(group)
    scale = _scale(scale, q.shape[-1])
    n = g.nranks
    if n == 1:
        return ulysses_flash(q, k, v, scale, causal)
    if q.shape[1] % n:
        raise ValueError(f"ulysses_attention: {q.shape[1]} heads do not "
                         f"divide over {n} ranks")
    # [b, h, s/n, d] -> [b, h/n, s, d]: heads split, sequence gathered
    qh, kh, vh = (all_to_all(x, 1, 2, g) for x in (q, k, v))
    out = ulysses_flash(qh, kh, vh, scale, causal)
    return all_to_all(out.to(q.dtype), 2, 1, g)


class RingFlashAttention:
    """Callable selecting ring (`mode="ring"`) or Ulysses attention."""

    def __init__(self, mode: str = "ring", group: Optional[Group] = None,
                 causal: bool = True):
        if mode not in ("ring", "ulysses"):
            raise ValueError(f"mode must be 'ring' or 'ulysses', got "
                             f"{mode!r}")
        self.mode = mode
        self.group = group
        self.causal = causal

    def __call__(self, q, k, v):
        fn = (ring_flash_attention if self.mode == "ring"
              else ulysses_attention)
        return fn(q, k, v, group=self.group, causal=self.causal)
