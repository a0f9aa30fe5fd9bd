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
goes through `all_reduce`.

The tensor-parallel region helpers (reference :117-160, :319-353): a spec
is a tuple with one entry a dimension, each None or an axis name (`"tp"`,
`"dp"`, or fleet's `"mp"`) or a tuple of them; `tp_dim_spec` finds the
dimension a spec shards over the tp axis and `local_shape` a shard's
shape. Megatron's region boundaries are autograd Functions over the ranks
of a tp group: `copy_to_tp_region` (identity forward, the gradient summed
over the group in rank order) and `reduce_from_tp_region` (the forward
summed in rank order, identity backward), with `gather_from_tp_region` /
`scatter_to_tp_region` for the last dimension. Each takes its group
explicitly, or the group `tp_scope` put in scope (what `shard_map` gives
the reference's axis name); with neither, or a one-rank group, each is
the identity.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["device_order", "carve_submeshes", "chunk_bounds",
           "fixed_order_sum", "ordered_allreduce", "distinct",
           "ordered_psum", "collected_shard_sum", "ordered_psum_scatter",
           "start_ordered_psum_scatter", "start_all_gather", "ring_collect",
           "ring_ordered_psum", "ring_ordered_psum_scatter",
           "ring_pipeline", "DP_AXIS", "TP_AXIS", "tp_dim_spec",
           "local_shape", "tp_scope", "copy_to_tp_region",
           "reduce_from_tp_region", "gather_from_tp_region",
           "scatter_to_tp_region", "gather_dim", "split_dim"]

DP_AXIS = "dp"
TP_AXIS = "tp"


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


# --------------------------------------------- Megatron tp region boundaries
def tp_dim_spec(spec, axis: str = TP_AXIS) -> Optional[int]:
    """Index of the dimension `spec` shards over `axis`, or None when the
    spec is replicated with respect to it. A spec sharding one dimension
    over several axes, or `axis` over two dimensions, is refused."""
    if spec is None:
        return None
    hit = None
    for dim, entry in enumerate(tuple(spec)):
        entries = entry if isinstance(entry, tuple) else (entry,)
        if axis in entries:
            if len(entries) > 1:
                raise ValueError(
                    f"spec {spec} shards one dim over multiple axes; "
                    f"only single-axis {axis!r} sharding is supported")
            if hit is not None:
                raise ValueError(f"spec {spec} shards {axis!r} over two dims")
            hit = dim
    return hit


def local_shape(shape: Sequence[int], spec, sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """A shard's shape of a global `shape` placed under `spec` on axes of
    sizes `sizes` (e.g. {"dp": 2, "tp": 2})."""
    out = [int(d) for d in shape]
    if spec is None:
        return tuple(out)
    for dim, entry in enumerate(tuple(spec)):
        entries = entry if isinstance(entry, tuple) else (entry,)
        for ax in entries:
            if ax is None:
                continue
            n = sizes.get(ax, 1)
            if out[dim] % n:
                raise ValueError(
                    f"dim {dim} of shape {tuple(shape)} not divisible by "
                    f"axis {ax!r} size {n}")
            out[dim] //= n
    return tuple(out)


_TP_SCOPE: List = []


@contextlib.contextmanager
def tp_scope(group):
    """Put `group` in scope as the tp group of the region helpers called
    without one (the ZeRO step enters it around its loss function)."""
    _TP_SCOPE.append(group)
    try:
        yield group
    finally:
        _TP_SCOPE.pop()


def _tp_group(group):
    if group is None and _TP_SCOPE:
        group = _TP_SCOPE[-1]
    return group if group is not None and group.nranks > 1 else None


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_psum(g.contiguous(), ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        return ordered_psum(y.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order."""
    from ..distributed.communication import all_gather

    return torch.cat(all_gather(None, x.contiguous(), group), dim=dim)


def split_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n of `x` along `dim`, as its own tensor."""
    n = x.shape[dim] // group.nranks
    return x.narrow(dim, group.rank * n, n).contiguous()


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_dim(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, -1, ctx.group), None


class _ScatterToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return split_dim(x, -1, group)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, -1, ctx.group), None


def copy_to_tp_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's `f`: the identity into a tensor-parallel region; the
    gradient (each rank's partial input gradient) summed over the group in
    rank order."""
    g = _tp_group(group)
    return x if g is None else _CopyToTp.apply(x, g)


def reduce_from_tp_region(y: torch.Tensor, group=None) -> torch.Tensor:
    """Megatron's `g`: the partial sums leaving a tensor-parallel region
    summed over the group in rank order; the gradient passes as it is (it
    is already the same on every rank)."""
    g = _tp_group(group)
    return y if g is None else _ReduceFromTp.apply(y, g)


def gather_from_tp_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's last-dimension slice concatenated in rank order; the
    gradient's own slice goes back."""
    g = _tp_group(group)
    return x if g is None else _GatherFromTp.apply(x, g)


def scatter_to_tp_region(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's 1/n of the last dimension of a replicated tensor; the
    gradient gathered back."""
    g = _tp_group(group)
    return x if g is None else _ScatterToTp.apply(x, g)
