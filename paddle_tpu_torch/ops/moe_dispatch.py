"""MoE dispatch and combine: the row gather K9 (`csrc/gather_rows.cu`), its
plain PyTorch version, its launch counter, the autograd Function around it,
and the routing metadata that feeds it.

K9 replaces the TPU kernel `_gather_rows_fwd_impl` (paddle_tpu/ops/
pallas_kernels.py:1173, pallas_call at :1196); `gather_rows` is the
custom-vjp `gather_rows` (:1166-1220) and `moe_dispatch_indices` the
reference's function of that name (:1228-1246). The layer that uses them
is `incubate.distributed.models.moe.MoELayer`:

    gather_rows(src (n, d), idx (m,) int) -> (m, d)
        out[i] = src[idx[i]], a zero row where idx[i] < 0

Its backward is the reference's scatter-add with no kernel (:1212-1218):
the cotangent rows where idx < 0 are zeroed and `index_add_` adds them at
max(idx, 0) into a zeroed (n, d) buffer, with no boolean filtering of the
indices (that would wait for the card). In the MoE layer each source row
gets at most k contributions from the dispatch's backward and each expert
slot at most one from the combine's; for k <= 2 the fp32 `index_add_` on
CUDA is therefore bit-deterministic (a + b = b + a, and adding the zeroed
rows is exact). A NaiveGate with topk > 2 is not (ROADMAP queue 2).

`gather_rows` launches K9 for CUDA tensors (counted in
`gather_rows.launches`) and runs `gather_rows_reference` only for CPU
tensors. An index >= n is a caller error that the routing cannot produce:
the plain version raises IndexError, and the kernel writes a zero row
rather than read outside `src`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build

__all__ = ["gather_rows", "gather_rows_reference", "GatherRows",
           "moe_dispatch_indices"]


def gather_rows_reference(src: torch.Tensor, idx: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version: src[idx] with zero rows where idx < 0; raises
    IndexError on the CPU for an index >= n."""
    _check(src, idx)
    idx = idx.long()
    rows = src[idx.clamp_min(0)]
    return torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))


def _check(src, idx):
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes src (n, d) and idx (m,), got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if idx.is_floating_point() or idx.is_complex() or idx.dtype == torch.bool:
        raise TypeError(f"gather_rows takes integer indices, got {idx.dtype}")
    if idx.device != src.device:
        raise ValueError(f"idx lies on {idx.device}, src on {src.device}")


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]


def _launch(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K9 on CUDA tensors: int32 indices (an int64 index tensor is
    converted), any element type; the kernel copies bytes."""
    _check(src, idx)
    src = src.contiguous()
    idx = idx.to(torch.int32).contiguous()
    n, d = src.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=src.dtype, device=src.device)
    if m == 0 or d == 0:
        return out
    lib = _build.load("gather_rows")
    fn = lib.ptt_gather_rows
    if fn.argtypes is None:
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
    err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), n, m,
             d * src.element_size(),
             torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "gather_rows", lib)
    gather_rows.launches += 1
    return out


class GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n = src.shape[0]
        if src.is_cuda:
            return _launch(src, idx)
        return gather_rows_reference(src, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = torch.where((idx >= 0)[:, None], g, torch.zeros_like(g))
        dsrc = torch.zeros((ctx.n, g.shape[1]), dtype=g.dtype,
                           device=g.device)
        dsrc.index_add_(0, idx.clamp_min(0), g)
        return dsrc, None


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] (zero row where idx[i] < 0), differentiable in
    `src`. CUDA tensors launch K9 (counted in `gather_rows.launches`); CPU
    tensors run `gather_rows_reference`."""
    return GatherRows.apply(src, idx)


gather_rows.launches = 0


def moe_dispatch_indices(topi: torch.Tensor, pos: torch.Tensor,
                         keep: torch.Tensor, num_experts: int,
                         capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing metadata -> gather indices (plain torch, no host sync).

    topi / pos / keep: [T, k] expert id, position in the expert's queue,
    capacity mask (0 / 1). Returns (slot_token [E*C] int32: the token that
    fills each expert slot, tok_slot [T, k] int32: the flat slot serving
    each (token, choice)), both -1 where unrouted or empty. The routed
    slots are scattered into E*C + 1 entries whose last one takes every
    unrouted pair, then sliced off: the reference's `mode="drop"`."""
    t, k = topi.shape
    ec = num_experts * capacity
    flat_slot = topi * capacity + pos.clamp(0, capacity - 1)
    routed = keep > 0
    tok_slot = torch.where(routed, flat_slot, -1).to(torch.int32)
    token_ids = torch.arange(t, dtype=torch.int32, device=topi.device)
    token_ids = token_ids[:, None].expand(t, k)
    slot_token = torch.full((ec + 1,), -1, dtype=torch.int32,
                            device=topi.device)
    slot_token.scatter_(0, torch.where(routed, flat_slot, ec).reshape(-1)
                        .long(), token_ids.reshape(-1))
    return slot_token[:ec], tok_slot
