"""The embedding lookup with a backward that sums in a fixed order.

PyTorch's default CUDA embedding backward adds a row's contributions in an
order that changes from run to run (a row that many tokens share, such as
ERNIE's token type 0 with 16384 tokens a step, moved by ~2e-8 between two
identical steps on an H100). The reference's gradient has one value a
run, so the port's `F.embedding` takes this backward instead:

- the ids are sorted stably, so each row's tokens stand together in token
  order;
- each row's run is cut into pieces of at most `PIECE` tokens, each piece
  summed in token order (`torch.segment_reduce`, one sequential sum a
  piece), then each row's pieces summed in order;
- a row no id names gets an empty sum, zero.

Every addition has a fixed place, so two runs give the same bits on any
device. The sums are taken in fp32 and cast to the weight's type once. On
the CPU the result equals `torch.nn.functional.embedding`'s gradient to
fp32 rounding (the order differs from its sequential sum).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

__all__ = ["embedding", "embedding_backward", "PIECE"]

# tokens summed in one piece: long runs become many short sequential sums,
# then one short sum of pieces a row
PIECE = 32


def embedding_backward(grad: torch.Tensor, ids: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """The (num_rows, dim) fp32 gradient of a lookup of `ids` given the
    output gradient `grad` (ids.shape + (dim,)), each row summed in the
    fixed order of the module docstring. No host sync: the pieces are laid
    out in a buffer of their largest possible count, the unused ones
    empty."""
    dim = grad.shape[-1]
    flat = ids.reshape(-1)
    n = flat.numel()
    dev = grad.device
    if n == 0:
        return torch.zeros((num_rows, dim), dtype=torch.float32, device=dev)
    rows = grad.reshape(-1, dim).float()
    order = torch.argsort(flat, stable=True)
    # each row's token count, from the sorted ids (no atomics)
    bounds = torch.searchsorted(flat[order], torch.arange(
        num_rows + 1, device=dev, dtype=flat.dtype))
    counts = bounds[1:] - bounds[:-1]
    pieces = (counts + PIECE - 1) // PIECE
    ends = torch.cumsum(pieces, 0)
    # piece i belongs to the row whose pieces end past it; its length is
    # what is left of the row's count, at most PIECE (0 past the last)
    most = (n + PIECE - 1) // PIECE + min(num_rows, n)
    i = torch.arange(most, device=dev)
    owner = torch.searchsorted(ends, i, right=True)
    own = owner.clamp(max=num_rows - 1)
    j = i - (ends[own] - pieces[own])
    lens = torch.where(owner < num_rows,
                       (counts[own] - j * PIECE).clamp(0, PIECE), 0)
    partial = torch.segment_reduce(rows.index_select(0, order), "sum",
                                   lengths=lens, axis=0, unsafe=True)
    # each row's pieces in order; one last segment takes the empty ones
    per_row = torch.cat([pieces, most - ends[-1:]])
    return torch.segment_reduce(partial, "sum", lengths=per_row, axis=0,
                                unsafe=True)[:num_rows]


class _Embedding(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.num_rows = weight.shape[0]
        return _tF.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None
        dw = embedding_backward(grad, ids, ctx.num_rows)
        return None, dw.to(grad.dtype)


def embedding(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """`weight[ids]`, whose weight gradient sums in a fixed order."""
    if not (torch.is_grad_enabled() and weight.requires_grad):
        return _tF.embedding(ids, weight)
    return _Embedding.apply(ids, weight)
