"""Device ordering and the fixed-shard-order all-reduce (ported from the
parts of paddle_tpu/parallel/mesh.py that tensor-parallel serving uses:
`device_order`, `carve_submeshes`, `chunk_bounds`, `ordered_psum`).

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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["device_order", "carve_submeshes", "chunk_bounds",
           "fixed_order_sum", "ordered_allreduce", "distinct"]


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
