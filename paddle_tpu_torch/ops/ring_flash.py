"""Ring flash attention over a sequence-sharded group, through the ring
form of the flash kernels (K1r, K2r, K3r in `ops.flash_attention`), and
the full-sequence flash attention of Ulysses' head slice.

Counterpart of the K8 glue of paddle_tpu/ops/pallas_kernels.py:945-1115:
`ring_merge` is `_ring_merge` (:963), `RingFlash` the custom vjp of
`_ring_vjp` (:975), `ring_flash_attention_kernels` the entry point
`ring_flash_attention_pallas` (:1063) and `ulysses_flash`
`_fwd_flash_for_ulysses` (:1092). None has a kernel of its own.

Each rank holds one shard of q, k and v along the sequence, all of the
same length s. Forward: n steps; at step t the rank holds the key / value
shard of rank src = (my - t) mod n and runs K1r on it at the global
offsets (my * s, src * s), so causal masking sees global positions and a
key shard wholly in the future runs no key tile (K1r writes out = 0 and
lse = -inf). Each step's partial output, emitted in the input type as the
TPU kernel's is, is merged into an fp32 accumulator with log-sum-exp
weights, and (k, v) move on to rank + 1 after every step but the last.
Every step launches, even a wholly future one, so each rank launches
exactly n K1r a forward and n K2r and n K3r a backward, as the reference.

Backward: p = exp(s - lse) with the ring's global lse (-inf set to 0) is
the globally normalized weight, so the flash backward decomposes step by
step: each step runs K2r (dQ) and K3r (dK, dV) with the global lse and
delta = rowsum(dO * O), adds dK / dV into fp32 accumulators that travel
with (k, v), and rotates (k, v, dK_acc, dV_acc) after every step; the last
rotation carries only the accumulators, so each rank ends holding its own
shard's dK and dV. Nothing O(s^2) is ever materialized; the plain versions
(CPU tensors) run in the same loop.

The ring moves (k, v) through `distributed.ring_shift`: NCCL on a card per
rank, else gloo through pinned host memory (counted by the group).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distributed.communication import ring_shift
from ..distributed.group import Group
from .flash_attention import (attention, attention_delta, flash_attention,
                              flash_attention_dkv, flash_attention_dq)

__all__ = ["ring_merge", "RingFlash", "ring_flash_attention_kernels",
           "ulysses_flash"]


def ring_merge(o_acc: torch.Tensor, lse_acc: torch.Tensor,
               o_s: torch.Tensor, lse_s: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one normalized partial (o_s (b, s, h, d), lse_s (b, h, s)) into
    the fp32 accumulator (o_acc, lse_acc): log-sum-exp weights in fp32,
    a side whose lse is -inf weighed at zero."""
    new_lse = torch.logaddexp(lse_acc, lse_s)
    fin = torch.isfinite(new_lse)
    safe = torch.where(fin, new_lse, torch.zeros_like(new_lse))
    w_acc = torch.where(torch.isfinite(lse_acc), torch.exp(lse_acc - safe),
                        torch.zeros_like(safe))
    w_s = torch.where(torch.isfinite(lse_s), torch.exp(lse_s - safe),
                      torch.zeros_like(safe))
    o = (o_acc * w_acc.transpose(1, 2)[..., None]
         + o_s.float() * w_s.transpose(1, 2)[..., None])
    return o, new_lse


def _offsets(my: int, step: int, n: int, s: int) -> Tuple[int, int]:
    """The global positions of this rank's query shard and of the key
    shard it holds at `step`."""
    return my * s, ((my - step) % n) * s


class RingFlash(torch.autograd.Function):
    """Ring flash attention of one rank's (b, s, h, d) shards over `group`
    (the TPU's `_ring_vjp`): K1r n times forward, K2r and K3r n times
    backward, see the module docstring."""

    @staticmethod
    def forward(ctx, q, k, v, group: Group, causal: bool, scale: float):
        n, my = group.nranks, group.rank
        b, s, h, d = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, s), float("-inf"), dtype=torch.float32,
                         device=q.device)
        kv = (k, v)
        for step in range(n):
            o_s, lse_s = flash_attention(
                q, kv[0], kv[1], is_causal=causal, return_lse=True,
                scale=scale, offsets=_offsets(my, step, n, s),
                keep_neg_inf_lse=True)
            o, lse = ring_merge(o, lse, o_s, lse_s)
            if step != n - 1:
                kv = ring_shift(kv, group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, my = group.nranks, group.rank
        s = q.shape[1]
        dout = dout.contiguous()
        lse0 = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
        delta = attention_delta(out, dout)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        ring = (k, v, torch.zeros(k.shape, dtype=torch.float32,
                                  device=k.device),
                torch.zeros(v.shape, dtype=torch.float32, device=v.device))
        for step in range(n):
            kb, vb, dka, dva = ring
            offs = _offsets(my, step, n, s)
            dq_s = flash_attention_dq(q, kb, vb, dout, lse0, delta,
                                      is_causal=causal, scale=scale,
                                      offsets=offs)
            dk_s, dv_s = flash_attention_dkv(q, kb, vb, dout, lse0, delta,
                                             is_causal=causal, scale=scale,
                                             offsets=offs)
            dka = dka + dk_s.float()
            dva = dva + dv_s.float()
            # every step shifts: after n shifts each accumulator is home
            # with all n contributions; the last carries only them
            if step != n - 1:
                ring = ring_shift((kb, vb, dka, dva), group)
            else:
                dka, dva = ring_shift((dka, dva), group)
            dq += dq_s.float()
        return (dq.to(q.dtype), dka.to(k.dtype), dva.to(v.dtype), None, None,
                None)


def ring_flash_attention_kernels(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, group: Group, causal: bool,
                                 scale: float) -> torch.Tensor:
    """Ring attention of this rank's (b, h, s_local, d) shards over
    `group`, differentiable; the shards are laid out once as the kernels'
    (b, s, h, d) and the output back."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention takes q, k, v shards of one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = RingFlash.apply(qs, ks, vs, group, bool(causal), scale)
    return out.transpose(1, 2)


def ulysses_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, causal: bool) -> torch.Tensor:
    """Full-sequence flash attention on Ulysses' (b, h_local, s, d) head
    slice: K1 forward, K2 + K3 backward through `FlashAttention`."""
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = attention(qs, ks, vs, is_causal=causal, scale=scale)
    return out.transpose(1, 2)
