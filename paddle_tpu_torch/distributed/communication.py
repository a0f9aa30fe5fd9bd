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

The rest of paddle's surface (reference :199-480): `reduce` and
`reduce_scatter` reduce in rank order (a gather or an all-to-all, then
the ranks' parts combined 0..n-1, as `parallel.mesh.ordered_psum` does),
so every run gives the same bits; `broadcast`, `scatter`, the list form
of `alltoall`, `isend` / `irecv` (a `Pending` to wait on), `wait` and the
`stream` namespace. A rank argument (`src`, `dst`) names a global rank
when the group holds it, else a rank of the group, as the reference's
`broadcast` reads it. The object collectives pickle over the group (the
bytes ride a uint8 tensor on the group's device), so every rank really
receives the others' objects; the reference's single-controller forms
echo the local value. `get_backend` returns "NCCL" or "GLOO", as Paddle
does (the reference returns "XLA").
"""
from __future__ import annotations

import pickle
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .group import Group, _default

__all__ = ["ReduceOp", "Pending", "all_reduce", "all_gather", "alltoall_single",
           "send", "recv", "P2POp", "batch_isend_irecv",
           "barrier", "ring_shift", "all_to_all", "replicated", "pmean",
           "reduce", "reduce_scatter", "broadcast", "scatter", "alltoall",
           "all_gather_object", "broadcast_object_list",
           "scatter_object_list", "get_backend", "isend", "irecv", "wait",
           "stream"]


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


class Pending:
    """A collective in flight (`async_op=True`): the backend moves the
    bytes while the caller goes on; `wait()` finishes it (copying staged
    bytes back to the card) and returns what the synchronous call would
    have returned."""

    def __init__(self, work, finish):
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish()


def all_gather(tensor_list: Optional[List[torch.Tensor]],
               tensor: torch.Tensor, group: Optional[Group] = None,
               async_op: bool = False):
    """Every rank's `tensor`, in rank order, into `tensor_list` (cleared
    first; a new list when None); returns the list, or with `async_op` a
    `Pending` whose `wait()` returns it."""
    g = _resolve(group)
    out = [] if tensor_list is None else tensor_list
    out.clear()
    if g.nranks == 1:
        out.append(tensor.clone())
        return Pending(None, lambda: out) if async_op else out
    wire = _out(tensor.contiguous(), g)
    bufs = [torch.empty_like(wire) for _ in range(g.nranks)]
    work = dist.all_gather(bufs, wire, group=g.pg, async_op=async_op)

    def finish():
        out.extend(_received(b, tensor, g) for b in bufs)
        return out

    return Pending(work, finish) if async_op else finish()


def alltoall_single(out_tensor: Optional[torch.Tensor],
                    in_tensor: torch.Tensor,
                    in_split_sizes: Optional[Sequence[int]] = None,
                    out_split_sizes: Optional[Sequence[int]] = None,
                    group: Optional[Group] = None, async_op: bool = False):
    """Rank i sends the j-th slice of `in_tensor` (dim 0, equal parts or
    `in_split_sizes`) to rank j and receives rank j's i-th slice as the
    j-th slice of `out_tensor` (a new tensor when None, equal splits).
    Returns `out_tensor`, or with `async_op` a `Pending` whose `wait()`
    returns it."""
    g = _resolve(group)
    in_tensor = in_tensor.contiguous()
    if out_tensor is None:
        if out_split_sizes is not None:
            raise ValueError("alltoall_single: give out_tensor with "
                             "out_split_sizes")
        out_tensor = torch.empty_like(in_tensor)
    if g.nranks == 1:
        out_tensor.copy_(in_tensor)
        return Pending(None, lambda: out_tensor) if async_op else out_tensor
    wire_in = _out(in_tensor, g)
    wire_out = _in(out_tensor, g)
    work = dist.all_to_all_single(
        wire_out, wire_in,
        None if out_split_sizes is None else list(out_split_sizes),
        None if in_split_sizes is None else list(in_split_sizes),
        group=g.pg, async_op=async_op)
    if async_op:
        return Pending(work, lambda: _back(wire_out, out_tensor, g))
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


# ------------------------------------------ the rest of paddle's surface
def _group_rank(g: Group, rank: int, what: str) -> int:
    """`rank` as a rank of `g`: a global rank the group holds, else a
    rank of the group (reference :270-288)."""
    if rank in g.ranks:
        return g.ranks.index(rank)
    if 0 <= rank < g.nranks:
        return rank
    raise ValueError(f"{what}={rank} is neither a member of group "
                     f"{g.ranks} nor a rank of it")


def _combine(parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """parts[0] op parts[1] op ... in that order (a sum in rank order)."""
    out = parts[0]
    for p in parts[1:]:
        if op == ReduceOp.SUM:
            out = out + p
        elif op == ReduceOp.PROD:
            out = out * p
        elif op == ReduceOp.MAX:
            out = torch.maximum(out, p)
        elif op == ReduceOp.MIN:
            out = torch.minimum(out, p)
        else:
            raise ValueError(f"unsupported reduce op {op}")
    return out


def reduce(tensor: torch.Tensor, dst: int = 0, op=ReduceOp.SUM,
           group: Optional[Group] = None,
           sync_op: bool = True) -> torch.Tensor:
    """Every rank's `tensor` combined by `op` in rank order into `dst`'s
    `tensor` (in place); the other ranks' tensors are left as they were."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    parts = all_gather(None, tensor, g)
    if g.rank == _group_rank(g, dst, "dst"):
        tensor.copy_(_combine(parts, op))
    return tensor


def reduce_scatter(tensor: torch.Tensor,
                   tensor_list: Optional[List[torch.Tensor]] = None,
                   op=ReduceOp.SUM, group: Optional[Group] = None,
                   sync_op: bool = True) -> torch.Tensor:
    """Rank i receives the combination over the ranks, in rank order, of
    their i-th parts. With `tensor_list` (one equal-shaped part a rank)
    the result is written into `tensor`; without it `tensor` itself is the
    input, cut into n equal parts along dim 0, and this rank's part comes
    back as a new tensor (a torch tensor keeps its shape)."""
    g = _resolve(group)
    n = g.nranks
    x = torch.cat([t.reshape(1, *t.shape) for t in tensor_list]) \
        if tensor_list is not None else tensor
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 of size {x.shape[0]} does "
                         f"not split over {n} ranks")
    if tensor_list is not None and len(tensor_list) != n:
        raise ValueError(f"reduce_scatter: {len(tensor_list)} parts for "
                         f"{n} ranks")
    part_shape = ((x.shape[0] // n,) + tuple(x.shape[1:])
                  if tensor_list is None else tuple(tensor_list[0].shape))
    if n == 1:
        out = x.reshape(part_shape)
    else:
        received = alltoall_single(None, x.contiguous().reshape(n, -1),
                                   group=g)
        out = _combine(list(received.unbind(0)), op).reshape(part_shape)
    if tensor_list is not None:
        return tensor.copy_(out)
    return out.clone() if out.data_ptr() == x.data_ptr() else out


def broadcast(tensor: torch.Tensor, src: int = 0,
              group: Optional[Group] = None,
              sync_op: bool = True) -> torch.Tensor:
    """`src`'s `tensor` into every rank's `tensor`, in place."""
    g = _resolve(group)
    if g.nranks == 1:
        return tensor
    root = _group_rank(g, src, "src")
    wire = _out(tensor.contiguous(), g) if g.rank == root else _in(tensor,
                                                                    g)
    dist.broadcast(wire, g.ranks[root], group=g.pg)
    if g.rank == root:
        return tensor
    return _back(wire, tensor, g)


def scatter(tensor: torch.Tensor,
            tensor_list: Optional[List[torch.Tensor]] = None, src: int = 0,
            group: Optional[Group] = None,
            sync_op: bool = True) -> torch.Tensor:
    """Rank i receives `src`'s `tensor_list[i]` into `tensor`, in place
    (only `src` passes the list)."""
    g = _resolve(group)
    root = _group_rank(g, src, "src")
    if g.rank == root and (tensor_list is None
                           or len(tensor_list) != g.nranks):
        raise ValueError(f"scatter: src needs a tensor_list of {g.nranks} "
                         "tensors")
    if g.nranks == 1:
        return tensor.copy_(tensor_list[0])
    wire = _in(tensor, g)
    parts = None
    if g.rank == root:
        parts = [_out(t.contiguous(), g) for t in tensor_list]
    dist.scatter(wire, parts, src=g.ranks[root], group=g.pg)
    return _back(wire, tensor, g)


def alltoall(out_tensor_list: Optional[List[torch.Tensor]],
             in_tensor_list: Optional[List[torch.Tensor]] = None,
             group: Optional[Group] = None,
             sync_op: bool = True) -> List[torch.Tensor]:
    """Rank i sends `in_tensor_list[j]` (equal shapes) to rank j and
    receives rank j's i-th tensor as the j-th of `out_tensor_list`
    (cleared first; a new list when None). Called with one list, that list
    is the input, as the reference allows."""
    g = _resolve(group)
    if in_tensor_list is None:
        in_tensor_list, out_tensor_list = out_tensor_list, None
    if len(in_tensor_list) != g.nranks:
        raise ValueError(f"alltoall: {len(in_tensor_list)} tensors for "
                         f"{g.nranks} ranks")
    stacked = torch.stack([t.contiguous() for t in in_tensor_list])
    parts = list(alltoall_single(None, stacked, group=g).unbind(0))
    out = [] if out_tensor_list is None else out_tensor_list
    out.clear()
    out.extend(parts)
    return out


def _object_bytes(obj, dev: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj, protocol=4)),
                            dtype=torch.uint8).to(dev)


def _bcast_object(obj, root: int, g: Group):
    """`root`'s `obj` on every rank of `g` (a length, then the bytes)."""
    dev = g.device
    if g.rank == root:
        data = _object_bytes(obj, dev)
        size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    broadcast(size, g.ranks[root], g)
    if g.rank != root:
        data = torch.empty(int(size.item()), dtype=torch.uint8, device=dev)
    broadcast(data, g.ranks[root], g)
    return obj if g.rank == root else pickle.loads(data.cpu().numpy()
                                                   .tobytes())


def all_gather_object(object_list: List, obj,
                      group: Optional[Group] = None) -> List:
    """Every rank's `obj`, in rank order, appended to `object_list`."""
    g = _resolve(group)
    if g.nranks == 1:
        object_list.append(obj)
        return object_list
    dev = g.device
    data = _object_bytes(obj, dev)
    sizes = [int(s.item()) for s in all_gather(
        None, torch.tensor([data.numel()], dtype=torch.int64, device=dev),
        g)]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[:data.numel()] = data
    for size, got in zip(sizes, all_gather(None, padded, g)):
        object_list.append(pickle.loads(got[:size].cpu().numpy().tobytes()))
    return object_list


def broadcast_object_list(object_list: List, src: int = 0,
                          group: Optional[Group] = None) -> List:
    """`src`'s list into every rank's `object_list`, in place."""
    g = _resolve(group)
    if g.nranks == 1:
        return object_list
    got = _bcast_object(list(object_list), _group_rank(g, src, "src"), g)
    object_list[:] = got
    return object_list


def scatter_object_list(out_object_list: List,
                        in_object_list: Optional[List] = None,
                        src: int = 0, group: Optional[Group] = None) -> List:
    """Rank i receives `src`'s `in_object_list[i]` as the one entry of
    `out_object_list`. A list shorter than the group raises ValueError on
    every rank (src sends the verdict with the objects)."""
    g = _resolve(group)
    root = _group_rank(g, src, "src")
    msg = None
    if g.rank == root:
        ok = in_object_list is not None and len(in_object_list) >= g.nranks
        msg = (True, list(in_object_list[:g.nranks])) if ok else (False,
                                                                  None)
    if g.nranks > 1:
        msg = _bcast_object(msg, root, g)
    ok, objs = msg
    if not ok:
        raise ValueError("in_object_list must have one entry per rank")
    val = objs[g.rank]      # read before clearing: the lists may alias
    out_object_list.clear()
    out_object_list.append(val)
    return out_object_list


def get_backend(group: Optional[Group] = None) -> str:
    """The group's backend as Paddle names it: "NCCL" or "GLOO"."""
    return _resolve(group).backend.upper()


def isend(tensor: torch.Tensor, dst: int = 0,
          group: Optional[Group] = None) -> Pending:
    """Start sending `tensor` to rank `dst` of the group; `wait()` on the
    result blocks until it left. Over NCCL a pair's communicator is made
    at the pair's first exchange, which blocks until the peer posts its
    side: in a ring, let even ranks send first and odd ranks receive
    first (or post both through `batch_isend_irecv`)."""
    g = _resolve(group)
    work = dist.isend(_out(tensor.contiguous(), g), g.ranks[dst], group=g.pg)
    return Pending(work, lambda: None)


def irecv(tensor: torch.Tensor, src: int = 0,
          group: Optional[Group] = None) -> Pending:
    """Start receiving into `tensor` from rank `src` of the group;
    `wait()` on the result finishes it and returns `tensor`."""
    g = _resolve(group)
    wire = _in(tensor, g)
    work = dist.irecv(wire, g.ranks[src], group=g.pg)
    return Pending(work, lambda: _back(wire, tensor, g))


def wait(tensor, group: Optional[Group] = None,
         use_calc_stream: bool = True):
    """Finish a collective in flight: a `Pending` is waited on and its
    result returned. A tensor is returned as it is: the synchronous
    collectives finish before they return."""
    if isinstance(tensor, Pending):
        return tensor.wait()
    return tensor


class _StreamNS:
    """paddle.distributed.stream: the collectives under their stream
    names (the port's collectives order themselves on the current
    stream)."""

    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce = staticmethod(reduce)
    reduce_scatter = staticmethod(reduce_scatter)
    broadcast = staticmethod(broadcast)
    alltoall = staticmethod(alltoall)
    alltoall_single = staticmethod(alltoall_single)
    scatter = staticmethod(scatter)
    send = staticmethod(send)
    recv = staticmethod(recv)


stream = _StreamNS()
