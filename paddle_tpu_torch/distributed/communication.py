"""Collectives over a `Group` (counterpart of
paddle_tpu/distributed/communication.py), with paddle's names, plus the
pieces the multi-rank slice builds on: `ring_shift` (K8's ppermute), the
differentiable tiled `all_to_all` (Ulysses' and the MoE layer's
`lax.all_to_all`), and `replicated` / `pmean` (what shard_map does to a
replicated input's gradient and to `lax.pmean`).

Every function is the identity on a one-rank group. A CUDA tensor crosses
a gloo group through pinned host memory (`Group.stages_cuda`): copied
out, carried by gloo, copied back, and the bytes counted in
`Group.staged_bytes`. NCCL takes CUDA tensors as they are.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .group import Group, _default

__all__ = ["ReduceOp", "all_reduce", "all_gather", "alltoall_single",
           "send", "recv", "P2POp", "batch_isend_irecv",
           "barrier", "ring_shift", "all_to_all", "replicated", "pmean"]


class ReduceOp:
    SUM = dist.ReduceOp.SUM
    MAX = dist.ReduceOp.MAX
    MIN = dist.ReduceOp.MIN
    PROD = dist.ReduceOp.PRODUCT


def _resolve(group: Optional[Group]) -> Group:
    return group if group is not None else _default()


def _out(t: torch.Tensor, g: Group) -> torch.Tensor:
    """The tensor to hand the backend: a pinned host copy of a CUDA tensor
    on a staging group, else `t` itself."""
    if not (t.is_cuda and g.stages_cuda):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    g.staged_bytes += t.numel() * t.element_size()
    return host


def _in(t: torch.Tensor, g: Group) -> torch.Tensor:
    """The buffer the backend receives `t` into: an empty pinned host
    buffer for a CUDA tensor on a staging group, else `t` itself."""
    if t.is_cuda and g.stages_cuda:
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return t


def _back(wire: torch.Tensor, t: torch.Tensor, g: Group) -> torch.Tensor:
    """Copy a received host buffer into `t` (the CUDA tensor it stands
    for); nothing when the backend wrote `t` itself."""
    if wire is not t:
        t.copy_(wire)
        g.staged_bytes += t.numel() * t.element_size()
    return t


def _received(wire: torch.Tensor, like: torch.Tensor, g: Group
              ) -> torch.Tensor:
    """The received tensor on `like`'s device."""
    if wire.device == like.device:
        return wire
    g.staged_bytes += wire.numel() * wire.element_size()
    return wire.to(like.device)


def all_reduce(tensor: torch.Tensor, op=ReduceOp.SUM,
               group: Optional[Group] = None) -> torch.Tensor:
    """Reduce `tensor` over the group, in place."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    wire = _out(tensor, g)
    dist.all_reduce(wire, op=op, group=g.pg)
    return _back(wire, tensor, g)


def all_gather(tensor_list: Optional[List[torch.Tensor]],
               tensor: torch.Tensor, group: Optional[Group] = None
               ) -> List[torch.Tensor]:
    """Every rank's `tensor`, in rank order, into `tensor_list` (cleared
    first; a new list when None); returns the list."""
    g = _resolve(group)
    out = [] if tensor_list is None else tensor_list
    out.clear()
    if g.nranks == 1:
        out.append(tensor.clone())
        return out
    wire = _out(tensor.contiguous(), g)
    bufs = [torch.empty_like(wire) for _ in range(g.nranks)]
    dist.all_gather(bufs, wire, group=g.pg)
    out.extend(_received(b, tensor, g) for b in bufs)
    return out


def alltoall_single(out_tensor: Optional[torch.Tensor],
                    in_tensor: torch.Tensor,
                    in_split_sizes: Optional[Sequence[int]] = None,
                    out_split_sizes: Optional[Sequence[int]] = None,
                    group: Optional[Group] = None) -> torch.Tensor:
    """Rank i sends the j-th slice of `in_tensor` (dim 0, equal parts or
    `in_split_sizes`) to rank j and receives rank j's i-th slice as the
    j-th slice of `out_tensor` (a new tensor when None, equal splits)."""
    g = _resolve(group)
    in_tensor = in_tensor.contiguous()
    if out_tensor is None:
        if out_split_sizes is not None:
            raise ValueError("alltoall_single: give out_tensor with "
                             "out_split_sizes")
        out_tensor = torch.empty_like(in_tensor)
    if g.nranks == 1:
        return out_tensor.copy_(in_tensor)
    wire_in = _out(in_tensor, g)
    wire_out = _in(out_tensor, g)
    dist.all_to_all_single(
        wire_out, wire_in,
        None if out_split_sizes is None else list(out_split_sizes),
        None if in_split_sizes is None else list(in_split_sizes),
        group=g.pg)
    return _back(wire_out, out_tensor, g)


def send(tensor: torch.Tensor, dst: int = 0,
         group: Optional[Group] = None) -> None:
    """Send `tensor` to rank `dst` of the group; blocks until it left."""
    g = _resolve(group)
    dist.send(_out(tensor.contiguous(), g), g.ranks[dst], group=g.pg)


def recv(tensor: torch.Tensor, src: int = 0,
         group: Optional[Group] = None) -> torch.Tensor:
    """Receive into `tensor` from rank `src` of the group."""
    g = _resolve(group)
    wire = _in(tensor, g)
    dist.recv(wire, g.ranks[src], group=g.pg)
    return _back(wire, tensor, g)


class P2POp:
    """One send or recv (`op` is `send` or `recv`) of `tensor` with rank
    `peer` of `group`, for `batch_isend_irecv`, which posts them all at
    once."""

    def __init__(self, op, tensor: torch.Tensor, peer: int,
                 group: Optional[Group] = None):
        if op not in (send, recv):
            raise ValueError("P2POp takes send or recv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[torch.Tensor]:
    """Post every send and recv of the list at once and wait for all of
    them (the ring exchange K8 needs). Returns the received tensors, in the
    list's order of recvs."""
    if not p2p_op_list:
        return []
    g = _resolve(p2p_op_list[0].group)
    ops, recvs = [], []
    for p in p2p_op_list:
        if p.op is send:
            ops.append(dist.P2POp(dist.isend, _out(p.tensor.contiguous(), g),
                                  g.ranks[p.peer], group=g.pg))
        else:
            wire = _in(p.tensor, g)
            recvs.append((wire, p.tensor))
            ops.append(dist.P2POp(dist.irecv, wire, g.ranks[p.peer],
                                  group=g.pg))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_back(wire, t, g) for wire, t in recvs]


def barrier(group: Optional[Group] = None) -> None:
    g = _resolve(group)
    if g.nranks > 1:
        dist.barrier(group=g.pg)


def ring_shift(tensors: Sequence[torch.Tensor],
               group: Optional[Group] = None) -> Tuple[torch.Tensor, ...]:
    """Send each tensor to rank + 1 and receive its like from rank - 1
    (mod the group's size): `jax.lax.ppermute` with perm i -> i + 1, as
    `_ring_vjp` rotates its blocks. New tensors; the inputs are not
    touched."""
    g = _resolve(group)
    n = g.nranks
    if n == 1:
        return tuple(tensors)
    nxt, prv = (g.rank + 1) % n, (g.rank - 1) % n
    ops, outs = [], []
    for t in tensors:
        out = torch.empty_like(t)
        ops += [P2POp(send, t, nxt, g), P2POp(recv, out, prv, g)]
        outs.append(out)
    batch_isend_irecv(ops)
    return tuple(outs)


def _all_to_all_tiled(x: torch.Tensor, split_axis: int, concat_axis: int,
                      g: Group) -> torch.Tensor:
    """`jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`: x's
    split_axis cut into n equal blocks, block j sent to rank j; the blocks
    received concatenated along concat_axis in rank order."""
    n = g.nranks
    if n == 1:
        return x
    size = x.shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size {size} "
                         f"does not split over {n} ranks")
    parts = x.reshape(*x.shape[:split_axis], n, size // n,
                      *x.shape[split_axis + 1:])
    send_buf = parts.movedim(split_axis, 0).contiguous()
    recv_buf = alltoall_single(None, send_buf, group=g)   # [n, *block]
    block = recv_buf.shape[1:]
    out = recv_buf.movedim(0, concat_axis)
    return out.reshape(*block[:concat_axis], n * block[concat_axis],
                       *block[concat_axis + 1:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes = (split_axis, concat_axis)
        ctx.group = group
        return _all_to_all_tiled(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all_tiled(grad.contiguous(), concat_axis, split_axis,
                                  ctx.group), None, None, None)


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               group: Optional[Group] = None) -> torch.Tensor:
    """Differentiable tiled all-to-all (see `_all_to_all_tiled`); its
    gradient is the inverse all-to-all."""
    g = _resolve(group)
    if g.nranks == 1:
        return x
    return _AllToAll.apply(x, split_axis % x.dim(), concat_axis % x.dim(), g)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), group=ctx.group), None


def replicated(x: torch.Tensor, group: Optional[Group] = None
               ) -> torch.Tensor:
    """`x`, held identical on every rank: the identity, whose gradient is
    summed over the ranks (what shard_map gives a replicated input)."""
    g = _resolve(group)
    return x if g.nranks == 1 else _Replicated.apply(x, g)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = group.nranks
        return all_reduce(x.detach().clone(), group=group) / group.nranks

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def pmean(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The mean of `x` over the ranks (`lax.pmean`). Each rank's loss
    carries the same mean, which the ranks' objective counts once: its
    gradient reaches each rank's `x` divided by the group's size, and a
    `replicated` parameter's summed gradient then holds it once."""
    g = _resolve(group)
    return x if g.nranks == 1 else _PMean.apply(x, g)
