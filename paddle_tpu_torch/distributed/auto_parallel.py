"""Semi-automatic parallelism: `ProcessMesh`, the placements and
`shard_tensor` / `reshard` (counterpart of
paddle_tpu/distributed/auto_parallel.py:1-188).

The reference places a global array on a device mesh and lets XLA move
the bytes. Here every rank is a process and holds only its own block:

- `ProcessMesh(mesh, dim_names)` is an N-d array of the world's ranks.
  At construction it makes one process group for every slice along every
  dimension, on every rank and in one order (`mesh.get_group(name)` is
  this rank's group along `name`);
- `shard_tensor(data, mesh, placements)` takes a global tensor that every
  rank holds and keeps this rank's block: `placements[i]` describes mesh
  dimension i: `Shard(d)` splits tensor dimension d over it (several mesh
  dimensions on one tensor dimension split it in mesh order, the first
  outermost), `Replicate()` repeats it, `Partial()` makes the global value
  the sum over it (the value sits on the dimension's first rank, zeros on
  the others). The result is a plain tensor carrying `process_mesh`,
  `placements` and `global_shape`, as the reference sets them on its
  Tensor (:147-159); a Parameter is sharded in place;
- `reshard(t, mesh, placements)` moves between placements with the
  port's collectives, every sum in rank order: Shard -> Replicate is a
  gather along the dimension, Partial -> Replicate an ordered sum,
  Replicate -> Shard a local cut, Shard(i) -> Shard(j) an all-to-all.
  Another mesh over the same ranks goes through the global value;
- `shard_layer` marks (or, with a `shard_fn`, shards) a module's
  parameters and hooks its `input_fn` / `output_fn`.

No `torch.distributed.tensor` (DTensor): its collectives would bypass the
port's transport (gloo's CUDA staging, `Group.staged_bytes`) and its sums
are not in rank order. `_to_partition_spec` gives the reference's
PartitionSpec as a tuple, one entry a tensor dimension.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
           "shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "get_mesh", "set_mesh"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicated(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    def __init__(self, reduce_type=None):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Partial)

    def __hash__(self):
        return hash("partial")

    def __repr__(self):
        return "Partial()"


class ProcessMesh:
    """An N-d array of the world's ranks with named dimensions; the
    process groups along each dimension are made at construction (every
    rank of the world constructs every mesh, in the same order)."""

    def __init__(self, mesh, dim_names: Optional[List[str]] = None):
        from .group import get_rank, get_world_size, new_group

        arr = np.asarray(mesh, dtype=np.int64)
        self._shape = list(arr.shape)
        self._process_ids = arr.reshape(-1).tolist()
        self._dim_names = list(dim_names or
                               [f"d{i}" for i in range(arr.ndim)])
        if len(self._dim_names) != arr.ndim:
            raise ValueError(f"{len(self._dim_names)} names for a mesh of "
                             f"{arr.ndim} dims")
        world = get_world_size()
        if world > 1 and max(self._process_ids) >= world:
            raise ValueError(f"mesh ranks {self._process_ids} outside a "
                             f"world of {world}")
        me = get_rank()
        self._groups: Dict[str, object] = {}
        for d, name in enumerate(self._dim_names):
            rows = np.moveaxis(arr, d, -1).reshape(-1, arr.shape[d])
            for row in rows.tolist():
                g = new_group(row)
                if me in row:
                    self._groups[name] = g

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, name: str) -> int:
        return self._shape[self._dim_names.index(name)]

    def get_group(self, name: str):
        """This rank's process group along dimension `name` (None when the
        rank is not in the mesh)."""
        return self._groups.get(name)

    def get_coord(self, rank: int) -> Optional[tuple]:
        """`rank`'s index in the mesh, or None when it is not in it."""
        hits = np.argwhere(self.mesh == rank)
        return tuple(int(i) for i in hits[0]) if len(hits) else None

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and other._shape == self._shape
                and other._process_ids == self._process_ids
                and other._dim_names == self._dim_names)

    def __hash__(self):
        return hash((tuple(self._shape), tuple(self._process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dims={self._dim_names})"


_GLOBAL_MESH: List[Optional[ProcessMesh]] = [None]


def set_mesh(mesh: ProcessMesh) -> None:
    _GLOBAL_MESH[0] = mesh


def get_mesh() -> Optional[ProcessMesh]:
    return _GLOBAL_MESH[0]


def _to_partition_spec(mesh: ProcessMesh, placements) -> tuple:
    """The reference's PartitionSpec of `placements` (one per mesh dim),
    as a tuple with one entry a tensor dimension: None, a mesh dim's
    name, or a tuple of names (outermost first)."""
    if placements is None:
        return ()
    max_dim = max([p.dim for p in placements if isinstance(p, Shard)],
                  default=-1)
    entries: List = [None] * (max_dim + 1)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            name = mesh.dim_names[mesh_dim]
            if entries[p.dim] is None:
                entries[p.dim] = name
            elif isinstance(entries[p.dim], tuple):
                entries[p.dim] = entries[p.dim] + (name,)
            else:
                entries[p.dim] = (entries[p.dim], name)
    return tuple(entries)


def block_ranges(mesh: ProcessMesh, placements, global_shape,
                 rank: int) -> Optional[List[List[int]]]:
    """[start, stop) along each tensor dimension of the block `rank` holds
    (None when the rank is not in the mesh). Partial dimensions hold the
    whole extent."""
    coord = mesh.get_coord(rank)
    if coord is None:
        return None
    out = [[0, int(d)] for d in global_shape]
    for dim in range(len(global_shape)):
        mdims = [m for m, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim == dim]
        if not mdims:
            continue
        parts, idx = 1, 0
        for m in mdims:
            parts *= mesh.shape[m]
            idx = idx * mesh.shape[m] + coord[m]
        size = int(global_shape[dim])
        if size % parts:
            raise ValueError(f"dim {dim} of {tuple(global_shape)} does not "
                             f"split into {parts} blocks")
        step = size // parts
        out[dim] = [idx * step, (idx + 1) * step]
    return out


def _me() -> int:
    from .group import get_rank

    return get_rank()


def _block(x: torch.Tensor, ranges) -> torch.Tensor:
    return x[tuple(slice(a, b) for a, b in ranges)]


def _mark(t: torch.Tensor, mesh, placements, global_shape) -> torch.Tensor:
    t.process_mesh = mesh
    t.placements = list(placements)
    t.global_shape = tuple(int(d) for d in global_shape)
    return t


def _partial_zero(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """`x` on the first rank of every Partial dimension, zeros elsewhere
    (so the sum over the dimension is `x`)."""
    coord = mesh.get_coord(_me())
    for m, p in enumerate(placements):
        if isinstance(p, Partial) and coord is not None and coord[m] != 0:
            return torch.zeros_like(x)
    return x


def shard_tensor(data, mesh: ProcessMesh, placements, dtype=None,
                 place=None, stop_gradient=None):
    """This rank's block of the global tensor `data` (every rank passes
    the same) under `placements` on `mesh`; see the module docstring."""
    if len(placements) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a mesh of "
                         f"{mesh.ndim} dims")
    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(
        data, dtype=dtype)
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if place is not None:
        t = t.to(place)
    ranges = block_ranges(mesh, placements, t.shape, _me())
    if ranges is None:
        local = t.new_empty((0,) * t.dim())
    else:
        local = _partial_zero(_block(t.detach(), ranges), mesh, placements)
    if isinstance(data, torch.nn.Parameter):
        data.data = local.contiguous().clone()
        out = data
    else:
        out = local.contiguous().clone()
        if stop_gradient is not None:
            out.requires_grad_(not stop_gradient)
    return _mark(out, mesh, placements, t.shape)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    from .communication import all_gather

    return torch.cat(all_gather(None, x.contiguous(), group), dim=dim)


def _unplace(x, mesh, placements, keep_shard=None):
    """`x`'s placements turned to Replicate one mesh dim at a time,
    innermost first (the gathers undo nested splits in order), except
    the mesh dims in `keep_shard`."""
    from ..parallel.mesh import ordered_psum

    cur = list(placements)
    for m in reversed(range(mesh.ndim)):
        if keep_shard is not None and m in keep_shard:
            continue
        p = cur[m]
        g = mesh.get_group(mesh.dim_names[m])
        if isinstance(p, Shard):
            x = _gather(x, p.dim, g)
        elif isinstance(p, Partial):
            x = ordered_psum(x.contiguous(), g)
        cur[m] = Replicate()
    return x, cur


def _place(x, mesh, cur, placements):
    """Replicate mesh dims of `x` cut or zeroed into `placements`,
    outermost first."""
    coord = mesh.get_coord(_me())
    for m, p in enumerate(placements):
        if cur[m] == p:
            continue
        if isinstance(p, Shard):
            n = mesh.shape[m]
            size = x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of size {size} does not "
                                 f"split over {n} ranks")
            step = size // n
            x = x.narrow(p.dim, coord[m] * step, step)
        elif isinstance(p, Partial) and coord[m] != 0:
            x = torch.zeros_like(x)
        cur[m] = p
    return x.contiguous()


def reshard(dist_tensor: torch.Tensor, mesh: ProcessMesh, placements):
    """`dist_tensor` moved to `placements` on `mesh`: a new tensor
    carrying them (see the module docstring)."""
    from .communication import _all_to_all_tiled

    src_mesh = getattr(dist_tensor, "process_mesh", None)
    src = getattr(dist_tensor, "placements", None)
    if src_mesh is None:
        raise ValueError("reshard takes a tensor made by shard_tensor")
    gshape = dist_tensor.global_shape
    x = dist_tensor.detach()
    if src_mesh != mesh:
        if not set(mesh.process_ids) <= set(src_mesh.process_ids):
            raise ValueError(f"reshard from {src_mesh} to {mesh}: the new "
                             "mesh holds ranks the old one does not")
        x, _ = _unplace(x, src_mesh, src)
        return _mark(_place(x, mesh, [Replicate()] * mesh.ndim,
                            placements), mesh, placements, gshape)
    # Shard(i) -> Shard(j) on a mesh dim that is the only one splitting i
    # and j: one all-to-all
    direct = set()
    for m, (a, b) in enumerate(zip(src, placements)):
        if isinstance(a, Shard) and isinstance(b, Shard) and a.dim != b.dim \
                and not any(isinstance(p, Shard) and p.dim in (a.dim, b.dim)
                            for k, p in enumerate(list(src) + list(placements))
                            if k % mesh.ndim != m):
            direct.add(m)
    for m in direct:
        g = mesh.get_group(mesh.dim_names[m])
        x = _all_to_all_tiled(x.contiguous(), placements[m].dim, src[m].dim,
                              g)
    # an unchanged mesh dim stays put unless it splits a tensor dim that a
    # changed one splits too (a nested split is undone and redone whole)
    touched = {p.dim for m in range(mesh.ndim) if m not in direct
               and src[m] != placements[m]
               for p in (src[m], placements[m]) if isinstance(p, Shard)}
    keep = {m for m in range(mesh.ndim) if src[m] == placements[m]
            and not (isinstance(src[m], Shard) and src[m].dim in touched)}
    keep |= direct
    x, cur = _unplace(x, mesh, src, keep_shard=keep)
    for m in direct:
        cur[m] = placements[m]
    return _mark(_place(x, mesh, cur, placements), mesh, placements, gshape)


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """`shard_fn(name, sublayer, mesh)` on every sublayer (by default each
    parameter marked replicated on the mesh); `input_fn(inputs, mesh)` and
    `output_fn(outputs, mesh)` hooked around the layer's forward."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in sublayer.parameters(recurse=False):
                shard_tensor(p, mesh, [Replicate()] * mesh.ndim)
    for name, sub in layer.named_modules():
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda mod, inputs: input_fn(inputs, process_mesh))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda mod, inputs, outputs: output_fn(outputs, process_mesh))
    return layer
