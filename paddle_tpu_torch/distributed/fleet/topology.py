"""Fleet's hybrid topology over `torch.distributed` ranks (counterpart of
paddle_tpu/distributed/fleet/topology.py:25-227).

`CommunicateTopology` is the reference's cartesian rank grid over the axes
["pp", "dp", "sharding", "sep", "mp"] (rank = row-major index of the
coordinate, mp fastest). `HybridCommunicateGroup` turns it into process
groups: for every axis, one `distributed.new_group` a list of
`get_comm_list(axis)`, every rank creating every group in the same order
(as `torch.distributed.new_group` requires), and keeps the one that holds
this rank. The reference builds a jax `Mesh` and names its axes; the port
builds only the groups. Without a joined world (one process), the groups
are built as descriptors over the grid (no process group behind them), so
the accessors answer for any `global_rank`.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

from ..group import Group, get_rank, get_world_size, is_initialized, new_group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]

_HYBRID_ORDER = ["pp", "dp", "sharding", "sep", "mp"]


class CommunicateTopology:
    def __init__(self,
                 hybrid_group_names: Sequence[str] = tuple(_HYBRID_ORDER),
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        if len(hybrid_group_names) != len(dims):
            raise ValueError(f"{len(hybrid_group_names)} axis names for "
                             f"{len(dims)} dims")
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world_size = 1
        for d in self._dims:
            self._world_size *= d
        coords = list(itertools.product(*(range(d) for d in self._dims)))
        self._coord_of = dict(enumerate(coords))
        self._rank_of = {c: r for r, c in self._coord_of.items()}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world_size

    def get_rank(self, **kwargs) -> int:
        return self._rank_of[tuple(kwargs[n] for n in self._parallel_names)]

    def get_coord(self, rank: int):
        return self._coord_of[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every rank whose coordinate on `axis_name` is `index`."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coord_of.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank lists that vary along `axis_name` with every other
        coordinate fixed: one group a combination of the other axes."""
        axis = self._parallel_names.index(axis_name)
        others = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for combo in itertools.product(*(range(d) for d in others)):
            group = []
            for k in range(self._dims[axis]):
                coord = list(combo)
                coord.insert(axis, k)
                group.append(self._rank_of[tuple(coord)])
            groups.append(group)
        return groups

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = list(self._coord_of[global_rank])
        for name, idx in kwargs.items():
            coord[self._parallel_names.index(name)] = idx
        return self._rank_of[tuple(coord)]


class HybridCommunicateGroup:
    """The axis groups of a topology, from this rank's side."""

    def __init__(self, topology: CommunicateTopology,
                 global_rank: Optional[int] = None):
        self._topo = topology
        self.nranks = topology.world_size()
        joined = is_initialized()
        if joined and get_world_size() != self.nranks:
            raise ValueError(
                f"the topology has {self.nranks} ranks but the world "
                f"{get_world_size()}")
        self.global_rank = get_rank() if global_rank is None \
            else int(global_rank)
        if joined and self.global_rank != get_rank():
            raise ValueError(f"global_rank {global_rank} is not this "
                             f"process's rank {get_rank()}")
        names = topology.get_hybrid_group_names()
        self._names = names
        self._dims = {n: topology.get_dim(n) for n in names}
        self._coord = topology.get_coord(self.global_rank)
        self._groups: Dict[str, Group] = {}
        for n in names:
            mine = None
            for ranks in topology.get_comm_list(n):
                # every rank builds every group, in the same order
                g = new_group(ranks) if joined else Group(
                    ranks.index(self.global_rank)
                    if self.global_rank in ranks else -1, ranks)
                if self.global_rank in ranks:
                    mine = g
            mine.axis_name = n
            self._groups[n] = mine

    # ------------------------------------------------------- paddle accessors
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        active = [n for n in self._names if self._dims[n] > 1]
        if not active:
            return "single"
        if active == ["dp"]:
            return "data"
        if "sharding" in active and set(active) <= {"dp", "sharding"}:
            return "sharding"
        if "pp" in active:
            return "pipeline"
        return "hybrid"

    def get_global_rank(self) -> int:
        return self.global_rank

    def _axis_rank(self, name: str) -> int:
        return self._coord[self._names.index(name)]

    def _axis_group(self, name: str) -> Group:
        return self._groups[name]

    # data parallel
    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_data_parallel_world_size(self) -> int:
        return self._dims["dp"]

    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["dp"].ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_model_parallel_world_size(self) -> int:
        return self._dims["mp"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["mp"].ranks[0]

    # pipeline parallel
    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_rank(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._dims["pp"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._dims["pp"] - 1

    # sharding (ZeRO)
    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sharding_parallel_world_size(self) -> int:
        return self._dims["sharding"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._groups["sharding"].ranks[0]

    # sep (segment / context parallel)
    def get_sep_parallel_rank(self) -> int:
        return self._axis_rank("sep")

    def get_sep_parallel_world_size(self) -> int:
        return self._dims["sep"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    # the pipeline's point-to-point partners ride the pp group
    def get_p2p_groups(self) -> Group:
        return self._groups["pp"]

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pp=stage_id, **kwargs)
