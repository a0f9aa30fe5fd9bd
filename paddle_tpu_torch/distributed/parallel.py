"""`DataParallel` and `ParallelEnv` (counterpart of
paddle_tpu/distributed/parallel.py:29-110).

Under GSPMD the reference's wrapper issues no collective: XLA sums the
gradients inside the jitted step. Here every rank is a process, so the
wrapper reduces the gradients itself, as Paddle's Reducer does:

- the trainable parameters are packed into buckets in reverse parameter
  order (the order their gradients come in): the first bucket holds at
  most `last_comm_buffer_size` MB (the model's last parameters, so the
  first transport starts early), every other one `comm_buffer_size` MB;
  a bucket holds one dtype on one device;
- a bucket is launched when its last gradient has been accumulated
  (`register_post_accumulate_grad_hook`): its gradients flattened and
  put in flight as an ordered reduce-scatter (`parallel.mesh.
  start_ordered_psum_scatter`: an all-to-all hands each rank every
  rank's copy of its 1/n of the bucket), buckets strictly in index
  order, so every rank issues the same collectives in the same order;
- before `backward()` returns (an autograd engine callback), each bucket
  is waited on, its 1/n summed over the ranks in rank order and
  multiplied by `1 / nranks` (`fixed_order_sum`, then the one multiply
  of `parallel/zero.py`'s stage 0), the parts all-gathered and written
  back into `.grad`. The sum is elementwise, so this is the bits of
  summing whole copies, and `opt.step()` needs no extra call: a step is
  bit-identical to `ZeroTrainStep(stage=0)` on the same rows. A rank
  receives about 2 (n - 1) / n times the gradient bytes and holds about
  twice them in flight, whatever n (an all-gather of whole gradients
  would hold n times them).

`no_sync()` skips the reduction: gradients accumulate locally and the
next synced backward reduces their sum. A parameter that got no gradient
contributes zeros with `find_unused_parameters=True`; without it the
backward raises naming it (after waiting on the buckets in flight), so
no rank is left waiting in a collective.

The wrapped layer's parameters and buffers (BatchNorm's running
statistics among them) are broadcast from the group's first rank at
construction (Paddle's `sync_params_buffers`). The reducer works on the
registered torch tensors (`torch.nn.Module.named_parameters`), so a Paddle
`nn.Layer`, whose `parameters()` gives Paddle wrappers, is reduced like
any torch Module. `state_dict` / `set_state_dict` are the wrapped
layer's, without a `_layers.` prefix, so checkpoints of wrapped and bare
models share names. `data_sharding()` /
`param_sharding()` describe the dp axes: the batch's dim 0 split over
them, the parameters replicated.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List

import torch
from torch import nn

from . import env

__all__ = ["DataParallel", "ParallelEnv", "DpSharding", "reduce_gradients"]

_MB = 1 << 20


class ParallelEnv:
    """This process's place in the launcher's world (Paddle's env-var
    contract): rank, world size, local rank and the card it works on."""

    @property
    def rank(self) -> int:
        return env.get_rank()

    @property
    def world_size(self) -> int:
        return env.get_world_size()

    @property
    def local_rank(self) -> int:
        return env.get_local_rank()

    @property
    def device_id(self) -> int:
        """The first of FLAGS_selected_gpus, else the local rank modulo
        the card count (the local rank on a machine without a card)."""
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if count:
            return env.device_index(count)
        sel = os.environ.get("FLAGS_selected_gpus", "")
        return int(sel.split(",")[0]) if sel else self.local_rank

    @property
    def current_endpoint(self) -> str:
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    nranks = world_size


class DpSharding:
    """How a data-parallel wrapper places a tensor: `spec` has one entry a
    dimension (a tuple of dp axis names where it is split, else None),
    as the reference's PartitionSpec; `group` the ranks it spans."""

    def __init__(self, spec: tuple, axes: tuple, group):
        self.spec = spec
        self.axes = axes
        self.group = group

    def __repr__(self):
        return f"DpSharding(spec={self.spec}, axes={self.axes})"


def _dp_group_and_axes(group, hcg):
    from .group import _default

    if group is not None:
        return group, ("dp",)
    if hcg is not None:
        axes = tuple(n for n, size in (
            ("dp", hcg.get_data_parallel_world_size()),
            ("sharding", hcg.get_sharding_parallel_world_size()))
            if size > 1) or ("dp",)
        if axes == ("sharding",):
            return hcg.get_sharding_parallel_group(), axes
        return hcg.get_data_parallel_group(), axes
    return _default(), ("dp",)


class _Bucket:
    def __init__(self, params: List[nn.Parameter]):
        self.params = params
        self.ready = 0
        self.pending = None     # the reduce-scatter in flight


def _assign_buckets(params: List[nn.Parameter], first_cap: int,
                    cap: int) -> List[_Bucket]:
    """Reverse parameter order; a new bucket when the next parameter would
    pass the cap (the first bucket's `first_cap`), or changes dtype or
    device. A parameter larger than the cap gets a bucket of its own."""
    buckets, cur, size = [], [], 0
    for p in reversed(params):
        nbytes = p.numel() * p.element_size()
        limit = first_cap if not buckets else cap
        if cur and (size + nbytes > limit or p.dtype != cur[0].dtype
                    or p.device != cur[0].device):
            buckets.append(_Bucket(cur))
            cur, size = [], 0
        cur.append(p)
        size += nbytes
    if cur:
        buckets.append(_Bucket(cur))
    return buckets


def _flat_grads(params) -> torch.Tensor:
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])


def _write_back(params, flat: torch.Tensor) -> None:
    off = 0
    for p in params:
        n = p.numel()
        part = flat[off:off + n].view_as(p)
        if p.grad is None:
            p.grad = part.clone()
        else:
            p.grad.copy_(part)
        off += n


def _start_sum(params, group):
    """The bucket's flat gradients (zeros to a multiple of n) put in
    flight as an ordered reduce-scatter."""
    from ..parallel.mesh import start_ordered_psum_scatter

    flat = _flat_grads(params)
    pad = -flat.numel() % group.nranks
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return start_ordered_psum_scatter(flat, group)


def _finish_sums(buckets, group) -> None:
    """Each bucket's reduce-scatter waited on in order, its part scaled by
    `1 / nranks` and all-gathered (all in flight together), then the
    whole written back into `.grad`."""
    from .communication import all_gather

    gathers = []
    for b in buckets:
        part = b.pending.wait() * (1.0 / group.nranks)
        b.pending = None        # its buffers go now
        gathers.append(all_gather(None, part, group, async_op=True))
    for b, work in zip(buckets, gathers):
        _write_back(b.params, torch.cat(work.wait()))


def reduce_gradients(params, group) -> None:
    """Every parameter's `.grad` summed over `group` in rank order and
    multiplied by `1 / nranks`, in place (a missing gradient counts as
    zeros); one reduce-scatter and all-gather a (dtype, device) bucket.
    Every rank of the group calls it with the same parameters."""
    params = [p for p in params if p.requires_grad]
    if group is None or group.nranks == 1 or not params:
        return
    buckets = _assign_buckets(params, 1 << 62, 1 << 62)
    for b in buckets:
        b.pending = _start_sum(b.params, group)
    _finish_sums(buckets, group)


class DataParallel(nn.Module):
    """paddle.DataParallel: `layers` run on this rank's rows, gradients
    reduced over the dp group as the module docstring says. The group is
    `group`, else the hcg's data-parallel group (its sharding group at
    pure sharding), else the world."""

    def __init__(self, layers: nn.Module, strategy=None,
                 comm_buffer_size: int = 25, last_comm_buffer_size: int = 1,
                 find_unused_parameters: bool = False, group=None, hcg=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.group, self._dp_axes = _dp_group_and_axes(group, hcg)
        self.nranks = self.group.nranks
        self._sync = True
        self._queued = False
        self._ready = set()     # the parameters whose gradient came in
        self._hooks = []
        self._buckets: List[_Bucket] = []
        if self.nranks > 1:
            self._sync_params()
            params = [p for _, p in nn.Module.named_parameters(layers)
                      if p.requires_grad]
            self._buckets = _assign_buckets(
                params, int(last_comm_buffer_size * _MB),
                int(comm_buffer_size * _MB))
            self._bucket_of: Dict[int, int] = {}
            for i, b in enumerate(self._buckets):
                for p in b.params:
                    self._bucket_of[id(p)] = i
                    self._hooks.append(
                        p.register_post_accumulate_grad_hook(self._on_grad))
        self._next = 0

    @torch.no_grad()
    def _sync_params(self) -> None:
        from .communication import broadcast

        layers = self._layers
        for _, t in list(nn.Module.named_parameters(layers)) + list(
                nn.Module.named_buffers(layers)):
            broadcast(t.data, self.group.ranks[0], self.group)

    # ---------------------------------------------------- the reducer
    def _on_grad(self, p: torch.Tensor) -> None:
        if not self._sync:
            return
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        self._ready.add(id(p))
        b = self._buckets[self._bucket_of[id(p)]]
        b.ready += 1
        self._launch_ready()

    def _launch(self, b: _Bucket) -> None:
        b.pending = _start_sum(b.params, self.group)

    def _launch_ready(self) -> None:
        while (self._next < len(self._buckets)
               and self._buckets[self._next].ready
               == len(self._buckets[self._next].params)):
            self._launch(self._buckets[self._next])
            self._next += 1

    @torch.no_grad()
    def _finish(self) -> None:
        missing = self._buckets[self._next:]
        try:
            if missing and not self.find_unused_parameters:
                for b in self._buckets[:self._next]:
                    b.pending.wait()
                names = {id(p): n for n, p in
                         nn.Module.named_parameters(self._layers)}
                lost = [names.get(id(p), "?") for b in missing
                        for p in b.params if id(p) not in self._ready]
                raise RuntimeError(
                    f"DataParallel: parameter(s) {lost[:8]} received no "
                    "gradient in this backward; pass "
                    "find_unused_parameters=True to reduce zeros for "
                    "them (every rank must take part in every bucket)")
            for b in missing:
                self._launch(b)
            self._next = len(self._buckets)
            _finish_sums(self._buckets, self.group)
        finally:
            for b in self._buckets:
                b.ready = 0
                b.pending = None
            self._next = 0
            self._queued = False
            self._ready.clear()

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate locally in the block; the next synced
        backward reduces their sum."""
        prev = self._sync
        self._sync = False
        try:
            yield
        finally:
            self._sync = prev

    # -------------------------------------------------------- surface
    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def data_sharding(self) -> DpSharding:
        """The batch: dim 0 split over the dp axes (one axis by its name,
        several as a tuple, as PartitionSpec normalizes them)."""
        axes = self._dp_axes
        return DpSharding((axes[0] if len(axes) == 1 else axes,), axes,
                          self.group)

    def param_sharding(self) -> DpSharding:
        """The parameters: replicated on every rank of the group."""
        return DpSharding((), self._dp_axes, self.group)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        return None

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        own = getattr(self._layers, "set_state_dict", None)
        if own is not None:     # a Paddle Layer
            return own(state_dict, *args, **kwargs)
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    load_state_dict = set_state_dict
