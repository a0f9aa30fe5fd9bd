"""Device ordering and the fixed-shard-order reductions (ported from
paddle_tpu/parallel/mesh.py: `device_order`, `carve_submeshes`,
`chunk_bounds` and `ordered_psum` as tensor-parallel serving uses them,
and the data-parallel collectives the ZeRO trainer calls, :161-317).

The JAX package builds a `Mesh` and reduces inside `shard_map`. The port
has no mesh: a tensor-parallel group is an ordered tuple of
`torch.device`s, one per shard, driven in lockstep by one host thread
(serving/tp.py). A device may appear more than once, which is how one card
holds every shard of a group.

`device_order` sorts by (type, index), so any permutation of the same
device list gives the same group, and a cluster carves identical groups
whatever order its caller listed the cards in. `ordered_allreduce` spells
the reduction order out: every shard's partial is copied to each device
of the group and summed there in shard order 0..n-1, in the partials'
dtype, so every shard holds bit-identical values (floating-point addition
is not associative; a library all-reduce does not promise an order).

The data-parallel collectives run over the ranks of a `distributed.Group`
(one process a rank): `ordered_psum` (all-gather, then the sum in rank
order), `ordered_psum_scatter` / `collected_shard_sum` (an all-to-all,
then the same order on this rank's chunk), the ring forms over
`ring_shift`, the in-flight forms the overlapped ZeRO schedule starts
early (`start_ordered_psum_scatter`, `start_all_gather`) and
`ring_pipeline`. NCCL's all-reduce does not fix its order, so no gradient
goes through `all_reduce`. The tensor-parallel region helpers of the
reference (`tp_dim_spec`, `local_shape`, `copy_to_tp_region`,
`reduce_from_tp_region`) wait for fleet (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["device_order", "carve_submeshes", "chunk_bounds",
           "fixed_order_sum", "ordered_allreduce", "distinct",
           "ordered_psum", "collected_shard_sum", "ordered_psum_scatter",
           "start_ordered_psum_scatter", "start_all_gather", "ring_collect",
           "ring_ordered_psum", "ring_ordered_psum_scatter",
           "ring_pipeline"]


def _key(dev: torch.device) -> Tuple[str, int]:
    return (dev.type, -1 if dev.index is None else dev.index)


def device_order(devices: Optional[Sequence] = None) -> List[torch.device]:
    """`devices` (names or torch.devices; default: every CUDA device of
    this process) sorted by (type, index): the one canonical order of a
    tensor-parallel group. Repeated entries stay, in place."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return sorted((torch.device(d) for d in devices), key=_key)


def carve_submeshes(num_replicas: int, tp_size: int,
                    devices: Optional[Sequence] = None
                    ) -> List[Tuple[torch.device, ...]]:
    """Split the sorted device list into `num_replicas` disjoint
    `tp_size`-wide groups: replica i gets entries [i*tp, (i+1)*tp). The
    groups are disjoint as positions of the list, so a list that repeats
    one card carves groups that share it."""
    devs = device_order(devices)
    need = num_replicas * tp_size
    if len(devs) < need:
        raise ValueError(
            f"{num_replicas} replicas x tp_size={tp_size} needs {need} "
            f"devices, got {len(devs)}")
    return [tuple(devs[i * tp_size:(i + 1) * tp_size])
            for i in range(num_replicas)]


def chunk_bounds(chunks: int, rows: int) -> List[Tuple[int, int]]:
    """Up to `chunks` non-empty [lo, hi) row ranges covering [0, rows) in
    order (a 1-row payload yields one chunk)."""
    k = max(1, min(int(chunks), int(rows)))
    bounds = []
    for j in range(k):
        lo, hi = (j * rows) // k, ((j + 1) * rows) // k
        if hi > lo:
            bounds.append((lo, hi))
    return bounds


def distinct(devices: Sequence[torch.device]) -> List[torch.device]:
    """The devices of a group in order of first appearance, each once."""
    return list(dict.fromkeys(devices))


def fixed_order_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ... in that order (one add at a time)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def ordered_allreduce(partials: Sequence[torch.Tensor],
                      targets: Sequence[torch.device]
                      ) -> Dict[torch.device, torch.Tensor]:
    """All-reduce of one partial per shard (each on its shard's device):
    on each distinct device of `targets`, the partials copied there and
    summed in shard order. Returns device -> result; shards that share a
    device share its result, and every result holds the same bits."""
    return {dev: fixed_order_sum([p.to(dev, non_blocking=True)
                                  for p in partials])
            for dev in distinct(targets)}


# ------------------------------------------ data-parallel collectives
# (reference parallel/mesh.py:161-317): the reductions ZeRO runs over the
# ranks of a `distributed.Group`, each with its order of additions spelled
# out, so every rank holds the same bits and stage 1 / 2 equal stage 0.

def _group(group):
    from ..distributed.group import _default

    return group if group is not None else _default()


def ordered_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce with a fixed order: all-gather, then the sum over ranks
    0..n-1 (`fixed_order_sum`). Bit-identical on every rank and run."""
    from ..distributed.communication import all_gather

    return fixed_order_sum(all_gather(None, x, _group(group)))


def collected_shard_sum(received: torch.Tensor) -> torch.Tensor:
    """The reduce half of a fixed-order reduce-scatter: `received` is
    (n, chunk), row s rank s's slice of this rank's chunk; their sum in
    order 0..n-1."""
    return fixed_order_sum(list(received.unbind(0)))


def ordered_psum_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Reduce-scatter of a flat `x` (its length a multiple of the group's
    size n) in the order of `ordered_psum`: `alltoall_single` hands each
    rank every rank's slice of its own chunk, then `collected_shard_sum`.
    Rank i's result is bit-identical to
    `ordered_psum(x)[i * chunk:(i + 1) * chunk]` (the sum is elementwise),
    and the full sum never exists on any rank."""
    from ..distributed.communication import alltoall_single

    g = _group(group)
    return collected_shard_sum(
        alltoall_single(None, x.reshape(g.nranks, -1), group=g))


def start_ordered_psum_scatter(x: torch.Tensor, group=None):
    """`ordered_psum_scatter` with the transport put in flight: returns a
    `Pending` whose `wait()` gives the same bits."""
    from ..distributed.communication import Pending, alltoall_single

    g = _group(group)
    work = alltoall_single(None, x.reshape(g.nranks, -1), group=g,
                           async_op=True)
    return Pending(None, lambda: collected_shard_sum(work.wait()))


def start_all_gather(x: torch.Tensor, group=None):
    """Every rank's `x` stacked in rank order, (n, *x.shape), with the
    transport put in flight (a `Pending`)."""
    from ..distributed.communication import Pending, all_gather

    work = all_gather(None, x, _group(group), async_op=True)
    return Pending(None, lambda: torch.stack(work.wait()))


def ring_collect(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `x` into a source-indexed (n, *x.shape) buffer by n - 1
    `ring_shift` hops instead of one all-gather: after hop t this rank
    holds the value of rank (i - t) mod n, written into that row. A sum
    in row order over the buffer is bit-identical to `ordered_psum`."""
    from ..distributed.communication import ring_shift

    g = _group(group)
    n, i = g.nranks, g.rank
    buf = x.new_empty((n,) + tuple(x.shape))
    buf[i] = x
    val = x
    for t in range(1, n):
        (val,) = ring_shift([val], g)
        buf[(i - t) % n] = val
    return buf


def ring_ordered_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`ordered_psum` over the ring transport: the same sum, the same
    bits."""
    return fixed_order_sum(list(ring_collect(x, group).unbind(0)))


def ring_ordered_psum_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """`ordered_psum_scatter` over the ring transport: column block i of
    the collected (n, n, chunk) buffer, summed in rank order."""
    g = _group(group)
    n = g.nranks
    blocked = ring_collect(x, g).reshape(n, n, -1)
    return collected_shard_sum(blocked[:, g.rank])


def ring_pipeline(items: Sequence, transport, reduce, consume) -> None:
    """The double-buffered overlap schedule the reference shares between
    serving and ZeRO: for each item, the NEXT item's transport is started
    before the current one is reduced and consumed,

        moved = transport(items[0])
        for j: nxt = transport(items[j + 1]); consume(j, reduce(moved))

    `transport` starts a collective and returns its handle, `reduce`
    finishes it with the fixed-order arithmetic, `consume(j, reduced)` is
    the caller's work on it. The schedule moves bytes earlier; it never
    changes what is summed in what order."""
    if not items:
        return
    moved = transport(items[0])
    for idx in range(len(items)):
        nxt = transport(items[idx + 1]) if idx + 1 < len(items) else None
        consume(idx, reduce(moved))
        moved = nxt
