"""fleet for the port (counterpart of
paddle_tpu/distributed/fleet/__init__.py:29-134): `init` builds the
hybrid topology's process groups (`topology.HybridCommunicateGroup`) from
a `DistributedStrategy`; `distributed_model` wraps a `PipelineLayer` in
the pipeline engine and a model at pure data parallelism in
`DataParallel`; `distributed_optimizer` wraps an optimizer in
`HybridParallelOptimizer` (the hybrid global-norm clip and the ZeRO
bridge). `meta_parallel` holds the mp layers, the pipeline, the
GroupSharded facade, sequence parallelism, the SPMD pipeline and ring /
Ulysses attention, `utils` `fused_allreduce_gradients`,
`sequence_parallel_utils` and `recompute`. `recompute` (activation
recompute) is the module, not re-exported here, so that `fleet.recompute`
names it.

`init` takes the world from `distributed.get_world_size()` (the
launcher's world, which every rank joined first); where every degree is 1
the dp axis takes the whole world, as the reference's does. The process
groups are made by every rank in the same order, so every rank calls
`init` together.
"""
from __future__ import annotations

from typing import Optional

from .distributed_strategy import DistributedStrategy
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = [
    "init", "is_initialized", "DistributedStrategy", "CommunicateTopology",
    "HybridCommunicateGroup", "get_hybrid_communicate_group",
    "get_strategy", "distributed_model", "distributed_optimizer",
    "worker_index", "worker_num", "is_first_worker", "barrier_worker",
    "fleet",
]

_STATE = {"hcg": None, "strategy": None, "initialized": False}


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, log_level="INFO"):
    """Build the hybrid groups from `strategy.hybrid_configs`; returns the
    `HybridCommunicateGroup`."""
    from .. import group as G

    strategy = strategy or DistributedStrategy()
    h = strategy.hybrid_configs
    order = h.get("order", ["pp", "dp", "sharding", "sep", "mp"])
    dims = [int(h.get(f"{name}_degree", 1)) for name in order]
    if not G.is_initialized() and G._env_int(
            ("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1) > 1:
        G.init_parallel_env()
    world = G.get_world_size()
    product = 1
    for d in dims:
        product *= d
    if product == 1 and world > 1:
        # pure data parallel over the whole world, as the reference
        dims[order.index("dp")] = world
    elif product != world:
        raise ValueError(f"hybrid degrees {dict(zip(order, dims))} make "
                         f"{product} ranks, the world has {world}")
    topo = CommunicateTopology(order, dims)
    _STATE["hcg"] = HybridCommunicateGroup(topo)
    _STATE["strategy"] = strategy
    _STATE["initialized"] = True
    return _STATE["hcg"]


def is_initialized() -> bool:
    return _STATE["initialized"]


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _STATE["hcg"]


def get_strategy() -> Optional[DistributedStrategy]:
    return _STATE["strategy"]


def distributed_model(model):
    """The model as the HCG runs it: a `PipelineLayer` becomes the
    `PipelineParallel` engine when pp > 1; at pure data parallelism the
    model is wrapped in `DataParallel` over the dp group (buckets of the
    strategy's `fuse_grad_size_in_MB`, its `find_unused_parameters`), as
    Paddle's does; the mp layers shard themselves."""
    hcg = _STATE["hcg"]
    if hcg is None:
        raise RuntimeError("call fleet.init() first")
    if hcg.get_pipe_parallel_world_size() > 1:
        from .meta_parallel import PipelineParallel

        return PipelineParallel(model, hcg, _STATE["strategy"])
    if hcg.get_data_parallel_world_size() > 1 and \
            hcg.get_parallel_mode() == "data":
        from ..parallel import DataParallel

        s = _STATE["strategy"]
        return DataParallel(
            model, comm_buffer_size=s.fuse_grad_size_in_MB,
            find_unused_parameters=s.find_unused_parameters, hcg=hcg)
    return model


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer wrapped for hybrid parallelism: the hybrid global-norm
    clip and the ZeRO bridge (`HybridParallelOptimizer`)."""
    hcg = _STATE["hcg"]
    if hcg is None:
        return optimizer
    from .meta_parallel import HybridParallelOptimizer

    return HybridParallelOptimizer(optimizer, hcg,
                                   strategy or _STATE["strategy"])


def worker_index() -> int:
    from ..group import get_rank

    return get_rank()


def worker_num() -> int:
    from ..group import get_world_size

    return get_world_size()


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier_worker() -> None:
    from ..communication import barrier

    barrier()


class _Fleet:
    """`from paddle.distributed import fleet; fleet.init(...)`: the module
    doubles as the singleton object."""

    init = staticmethod(init)
    is_initialized = staticmethod(is_initialized)
    distributed_model = staticmethod(distributed_model)
    distributed_optimizer = staticmethod(distributed_optimizer)
    worker_index = staticmethod(worker_index)
    worker_num = staticmethod(worker_num)
    is_first_worker = staticmethod(is_first_worker)
    barrier_worker = staticmethod(barrier_worker)
    get_hybrid_communicate_group = staticmethod(get_hybrid_communicate_group)
    get_strategy = staticmethod(get_strategy)
    DistributedStrategy = DistributedStrategy


fleet = _Fleet()
