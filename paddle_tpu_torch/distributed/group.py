"""Process groups over `torch.distributed` (counterpart of
paddle_tpu/distributed/group.py and of `init_parallel_env`,
paddle_tpu/distributed/parallel.py).

The JAX package runs one program over a device mesh, and a group names a
mesh axis. Here every rank is a process, and a `Group` wraps a torch
process group. `init_parallel_env` joins the world and picks the backend
from it:

- NCCL when every rank has a card of its own (`device_count() >=
  world_size`); rank r works on `cuda:r`;
- gloo otherwise; rank r works on `cuda:(r % device_count())`, so on a
  one-card machine every rank shares `cuda:0`, or on the CPU when the
  caller asks for it (`device="cpu"`).

Gloo carries no CUDA tensor through the collectives this port uses, so
`communication` copies CUDA tensors to pinned host memory, runs the
collective there and copies the result back: that copy is the transport,
counted in `Group.staged_bytes`; every kernel still runs on the card.

Without a process group the world is one rank: `get_world_size()` is 1 and
`get_rank()` 0.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["Group", "init_parallel_env", "new_group", "get_group",
           "get_rank", "get_world_size", "is_initialized",
           "destroy_process_group"]


class Group:
    """An ordered set of ranks: this process's index in it (`rank`, -1 for
    a non-member), the global ranks (`ranks`), the torch process group
    (`pg`, None for the world), the backend and the device its tensors
    live on. `staged_bytes` counts the bytes copied between the card and
    pinned host memory to carry CUDA tensors over gloo."""

    def __init__(self, rank: int, ranks: Sequence[int], id: int = 0,
                 pg=None, backend: str = "gloo",
                 device: Optional[torch.device] = None):
        self.rank = rank
        self.ranks = list(ranks)
        self.id = id
        self.pg = pg
        self.backend = backend
        self.device = device if device is not None else torch.device("cpu")
        self.staged_bytes = 0

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    @property
    def stages_cuda(self) -> bool:
        """True when CUDA tensors cross this group through host memory."""
        return self.backend == "gloo"

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self) -> bool:
        return self.rank >= 0

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"backend={self.backend!r}, device={self.device})")


_DEFAULT: List[Optional[Group]] = [None]
_GROUPS = {}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _env_int(names, default=None):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def init_parallel_env(rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      init_method: Optional[str] = None, device=None,
                      timeout: float = 1800.0) -> Group:
    """Join the world as `rank` of `world_size` (default: the launcher's
    PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM, else RANK / WORLD_SIZE)
    through `init_method` (a `file://` or `tcp://` URL; default "env://",
    which reads MASTER_ADDR / MASTER_PORT). `device` is the card by default
    ('cpu' to run on the CPU); the backend follows the world as the module
    says. Collectives that wait longer than `timeout` seconds raise.
    Returns the default group."""
    if is_initialized():
        raise RuntimeError("init_parallel_env: this process already joined "
                           "a process group")
    rank = _env_int(("PADDLE_TRAINER_ID", "RANK"), 0) if rank is None \
        else int(rank)
    world_size = (_env_int(("PADDLE_TRAINERS_NUM", "WORLD_SIZE"), 1)
                  if world_size is None else int(world_size))
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", rank % count)
        torch.cuda.set_device(dev)
        if count >= world_size:
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size, timeout=datetime.timedelta(seconds=timeout))
    group = Group(rank, range(world_size), 0, None, backend, dev)
    _DEFAULT[0] = group
    _GROUPS[0] = group
    return group


def _default() -> Group:
    """The default group; the one-rank world when no group was joined."""
    if _DEFAULT[0] is not None:
        return _DEFAULT[0]
    if is_initialized():
        raise RuntimeError("a torch process group exists but was not joined "
                           "through init_parallel_env")
    return Group(0, [0])


def get_group(gid: int = 0) -> Optional[Group]:
    """The group with id `gid` (0: the default group)."""
    return _GROUPS.get(gid)


def new_group(ranks: Optional[Sequence[int]] = None) -> Group:
    """A group over `ranks` (all by default), on the world's backend.
    Every rank of the world must call it, members or not, in the same
    order."""
    world = _default()
    ranks = list(range(world.nranks)) if ranks is None else list(ranks)
    pg = dist.new_group(ranks) if is_initialized() else None
    gid = max(_GROUPS, default=0) + 1
    me = get_rank()
    group = Group(ranks.index(me) if me in ranks else -1, ranks, gid, pg,
                  world.backend, world.device)
    _GROUPS[gid] = group
    return group


def get_rank(group: Optional[Group] = None) -> int:
    """This process's rank in `group` (the world by default; 0 without a
    process group)."""
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else 0


def get_world_size(group: Optional[Group] = None) -> int:
    """The number of ranks of `group` (the world by default; 1 without a
    process group)."""
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() else 1


def destroy_process_group() -> None:
    """Leave the world (every group with it)."""
    if is_initialized():
        dist.destroy_process_group()
    _DEFAULT[0] = None
    _GROUPS.clear()
