"""The launcher's environment (counterpart of
paddle_tpu/distributed/env.py:1-89).

`fleetrun` (`distributed.launch`) starts each rank with Paddle's
variables: PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK,
PADDLE_TRAINER_ENDPOINTS, PADDLE_CURRENT_ENDPOINT, PADDLE_MASTER and
FLAGS_selected_gpus. `init_parallel_env()` (in `group`) joins the world
they describe through torch's `env://` rendezvous; where MASTER_ADDR /
MASTER_PORT are unset, `master_endpoint` supplies them from PADDLE_MASTER,
else from the first of PADDLE_TRAINER_ENDPOINTS (the coordinator the
reference hands `jax.distributed.initialize`, :44-47).

`get_rank` / `get_world_size` read the joined world, else the launcher's
variables, else a world of one. `device_index` is the card a rank works
on: the first of FLAGS_selected_gpus (the GPU counterpart of the
reference's FLAGS_selected_tpus), else the local rank modulo the card
count.
"""
from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

__all__ = ["master_endpoint", "set_master_from_env", "get_rank",
           "get_world_size", "get_local_rank", "device_index",
           "is_initialized"]


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _env_int(names, default=None) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def master_endpoint() -> Optional[str]:
    """The coordinator's "host:port": PADDLE_MASTER, else the first of
    PADDLE_TRAINER_ENDPOINTS, else None."""
    if os.environ.get("PADDLE_MASTER"):
        return os.environ["PADDLE_MASTER"]
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return eps.split(",")[0] if eps else None


def set_master_from_env() -> None:
    """MASTER_ADDR / MASTER_PORT from the coordinator, where unset."""
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return
    ep = master_endpoint()
    if ep:
        host, port = ep.rsplit(":", 1)
        os.environ.setdefault("MASTER_ADDR", host)
        os.environ.setdefault("MASTER_PORT", port)


def get_rank() -> int:
    """This process's rank: the joined world's, else PADDLE_TRAINER_ID /
    RANK, else 0."""
    if is_initialized():
        return dist.get_rank()
    return _env_int(("PADDLE_TRAINER_ID", "RANK"), 0)


def get_world_size() -> int:
    """The world's size: the joined world's, else PADDLE_TRAINERS_NUM /
    WORLD_SIZE, else 1."""
    if is_initialized():
        return dist.get_world_size()
    return _env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)


def get_local_rank() -> int:
    """This process's rank on its node: PADDLE_LOCAL_RANK / LOCAL_RANK,
    else the global rank."""
    return _env_int(("PADDLE_LOCAL_RANK", "LOCAL_RANK"), get_rank())


def device_index(count: int, rank: Optional[int] = None) -> int:
    """The card a rank works on among `count`: the first of
    FLAGS_selected_gpus, else its local rank (PADDLE_LOCAL_RANK, else
    `rank`, else the global rank) modulo `count`."""
    sel = os.environ.get("FLAGS_selected_gpus", "")
    if sel:
        return int(sel.split(",")[0]) % count
    local = _env_int(("PADDLE_LOCAL_RANK", "LOCAL_RANK"),
                     get_rank() if rank is None else rank)
    return local % count
