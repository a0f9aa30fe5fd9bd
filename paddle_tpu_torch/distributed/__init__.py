"""paddle.distributed for the port, over `torch.distributed` (counterpart
of paddle_tpu/distributed/__init__.py:8-38).

- `group` joins the world and picks the backend (NCCL when every rank has
  a card, else gloo); `env` reads the launcher's environment;
  `communication` holds the collectives, every sum in rank order; `spawn`
  starts a world of processes and `launch` is fleetrun, the launcher a
  user starts a job with (`python -m paddle_tpu_torch.distributed.launch
  --nproc_per_node N train.py`);
- `parallel` holds `DataParallel` (the bucketed gradient reducer) and
  `ParallelEnv`; `checkpoint` the sharded, resharding checkpoint with its
  asynchronous save; `auto_parallel` the process mesh, the placements,
  `shard_tensor` and `reshard`; `auto_parallel_engine` the `Engine`;
- `fleet` the hybrid topology and its meta-parallel layers (pipeline,
  mp layers, GroupSharded, ring / Ulysses attention, recompute),
  `sharding` the GroupSharded facade;
- the host-side services: `tcp_store` (the native store), `rpc`,
  `elastic`, `auto_tuner` and `fleet_executor`.

Every name resolves at first use (its module is imported then), so the
launcher and the host-side services start without importing torch.
"""
import importlib

# bound now (spawn.py imports no torch): the function shares its module's
# name, and a later import of the submodule must not rebind it
from .spawn import spawn

_SUBMODULES = ("auto_parallel", "auto_parallel_engine", "auto_tuner",
               "checkpoint", "communication", "elastic", "env", "fleet",
               "fleet_executor", "group", "launch", "parallel", "rpc",
               "sharding", "spawn", "tcp_store")

_NAMES = {
    "auto_parallel": ("Partial", "Placement", "ProcessMesh", "Replicate",
                      "Shard", "dtensor_from_fn", "get_mesh", "reshard",
                      "set_mesh", "shard_layer", "shard_tensor"),
    "auto_parallel_engine": ("Engine", "complete_param_shardings"),
    "checkpoint": ("load_state_dict", "save_state_dict", "wait_save"),
    "communication": ("P2POp", "Pending", "ReduceOp", "all_gather",
                      "all_gather_object", "all_reduce", "all_to_all",
                      "alltoall", "alltoall_single", "barrier",
                      "batch_isend_irecv", "broadcast",
                      "broadcast_object_list", "get_backend", "irecv",
                      "isend", "pmean", "recv", "reduce", "reduce_scatter",
                      "replicated", "ring_shift", "scatter",
                      "scatter_object_list", "send", "stream", "wait"),
    "fleet": ("DistributedStrategy",),
    "fleet_executor": ("FleetExecutor", "TaskNode"),
    "group": ("Group", "destroy_process_group", "get_group", "get_rank",
              "get_world_size", "init_parallel_env", "is_initialized",
              "new_group"),
    "parallel": ("DataParallel", "ParallelEnv"),
    "tcp_store": ("TCPStore",),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_HOME) + ["spawn"] + sorted(
    set(_SUBMODULES) - {"env", "group", "parallel", "spawn"})


def __getattr__(name):
    if name in _HOME:
        value = getattr(importlib.import_module(f".{_HOME[name]}", __name__),
                        name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME) | set(_SUBMODULES))
