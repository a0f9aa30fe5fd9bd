"""Tensor-parallel (Megatron) layers and the named RNG streams (counterpart
of paddle_tpu/distributed/fleet/meta_parallel/parallel_layers.py:61-227).

The reference keeps one logical parameter with a `dist_spec` and lets
GSPMD insert the collectives. Here every rank of the mp group is a process
that holds its own shard, and the layers issue their collectives
explicitly, as Megatron and upstream Paddle do:

- `VocabParallelEmbedding`: the rank's rows of the vocabulary; ids outside
  them look up row 0 and are zeroed, and the outputs are summed over mp
  (each token has one non-zero term, so the sum is exact);
- `ColumnParallelLinear`: the rank's rows of the (out, in) weight and of
  the bias; `copy_to_tp_region` in front, and with `gather_output` the
  outputs gathered along the last dimension;
- `RowParallelLinear`: the rank's columns of the weight; the input split
  along its last dimension unless `input_is_parallel`, the partial
  products summed over mp, the (replicated) bias added after the sum;
- `ParallelCrossEntropy`: vocab-parallel cross entropy, the max (exact in
  any order), the sum of exponentials and the target logit each reduced
  over mp; its backward needs no collective.

Every mp sum runs in rank order (`parallel.mesh.ordered_psum` under
`copy_to_tp_region` / `reduce_from_tp_region`), so a run gives the same
bits every time. The mp group is the layer's `mp_group`, else the group of
the fleet topology (`fleet.init`), else none: on one rank each layer is
its dense counterpart. A sharded parameter carries `is_distributed = True`
and `split_axis` (the dimension of the port's layout it is split along),
with `mp_rank` / `mp_size`; `shard_of(name, full)` cuts this rank's part
of a full tensor, which is how weights built or loaded whole reach a
shard, and `bind_mp_group(model, group)` cuts a model built whole (the
auto-parallel Engine's partitioner).

Parameters are drawn whole (Xavier-normal for weights, as the reference,
from PyTorch's default generator on the layer's device; zero biases) and
cut, so every rank drawing from the same seed holds the slices of one
dense layer.

`RNGStatesTracker` keeps named `torch.Generator`s (the port draws dropout
from explicit generators): `model_parallel_random_seed(seed)` adds
"global_seed" (the same stream on every mp rank: dropout of replicated
activations) and "model-parallel-rng" (seed + 2718 + the mp rank: dropout
of head-sharded activations, which must differ between ranks).
"""
from __future__ import annotations

import contextlib
import zlib
from typing import Dict, Optional

import torch
from torch import nn

from ....device import resolve_device
from ....nn import functional as F
from ....parallel.mesh import (copy_to_tp_region, gather_dim,
                               gather_from_tp_region, ordered_psum,
                               reduce_from_tp_region, scatter_to_tp_region)

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "RNGStatesTracker", "get_rng_state_tracker",
    "model_parallel_random_seed", "mp_shardings", "mp_full_parameters",
    "bind_mp_group",
]


def mp_group_of(mp_group=None):
    """`mp_group`, else the fleet topology's mp group, else None (one
    rank)."""
    if mp_group is None:
        from .. import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        mp_group = hcg.get_model_parallel_group() if hcg is not None \
            else None
    return mp_group if mp_group is not None and mp_group.nranks > 1 \
        else None


class _MPLayer(nn.Module):
    """The mp group, this rank's place in it, and sharded parameters."""

    def _setup(self, mp_group):
        self.group = mp_group_of(mp_group)
        self.mp_size = self.group.nranks if self.group is not None else 1
        self.mp_rank = self.group.rank if self.group is not None else 0

    def _cut(self, full: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        if axis is None or self.mp_size == 1:
            return full
        if full.shape[axis] % self.mp_size:
            raise ValueError(f"dim {axis} of {tuple(full.shape)} does not "
                             f"split over mp={self.mp_size}")
        n = full.shape[axis] // self.mp_size
        return full.narrow(axis, self.mp_rank * n, n).contiguous()

    def _param(self, shape, axis, device, dtype, bias=False) -> nn.Parameter:
        full = torch.empty(shape, device=resolve_device(device),
                           dtype=dtype or torch.float32)
        with torch.no_grad():
            if bias:
                full.zero_()
            else:
                nn.init.xavier_normal_(full)
        p = nn.Parameter(self._cut(full, axis))
        self._mark(p, axis)
        return p

    def _mark(self, p: torch.Tensor, axis: Optional[int]) -> None:
        """The placement a parameter carries (what the checkpoint and
        the hybrid clip read): its split dimension, whether it is split,
        and this rank's place in the mp group."""
        p.split_axis = axis
        p.is_distributed = axis is not None and self.mp_size > 1
        p.mp_rank = self.mp_rank
        p.mp_size = self.mp_size

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the full tensor of parameter `name`."""
        return self._cut(full, getattr(self, name).split_axis)


class VocabParallelEmbedding(_MPLayer):
    """Embedding with the vocabulary split over mp (rows of the weight)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._setup(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self._param((num_embeddings, embedding_dim), 0, device,
                                  dtype)
        self.vocab_start = self.mp_rank * self.weight.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return F.embedding(ids, self.weight)
        rows = self.weight.shape[0]
        outside = (ids < self.vocab_start) | (ids >= self.vocab_start + rows)
        local = (ids - self.vocab_start).masked_fill(outside, 0)
        out = F.embedding(local, self.weight).masked_fill(
            outside[..., None], 0.0)
        return reduce_from_tp_region(out, self.group)


class ColumnParallelLinear(_MPLayer):
    """Linear with the OUTPUT features split over mp (Megatron column)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 mp_group=None, fuse_matmul_bias: bool = False, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._setup(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = self._param((out_features, in_features), 0, device,
                                  dtype)
        self.bias = (self._param((out_features,), 0, device, dtype, True)
                     if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(copy_to_tp_region(x, self.group), self.weight,
                       self.bias)
        if self.gather_output:
            out = gather_from_tp_region(out, self.group)
        return out


class RowParallelLinear(_MPLayer):
    """Linear with the INPUT features split over mp (Megatron row): the
    partial products summed over mp, then the bias."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 mp_group=None, fuse_matmul_bias: bool = False, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._setup(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self._param((out_features, in_features), 1, device,
                                  dtype)
        # added after the reduction: replicated
        self.bias = (self._param((out_features,), None, device, dtype, True)
                     if has_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = scatter_to_tp_region(x, self.group)
        out = reduce_from_tp_region(F.linear(x, self.weight), self.group)
        if self.bias is not None:
            out = F.add(out, self.bias)
        return out


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, label, group, start, ignore_index):
        from ...communication import ReduceOp, all_reduce

        x = logits.float()
        vmax = x.max(dim=-1).values
        if group is not None:
            all_reduce(vmax, ReduceOp.MAX, group)
        x = x - vmax[..., None]
        ex = torch.exp(x)
        total = ex.sum(dim=-1)
        rows = x.shape[-1]
        inside = (label >= start) & (label < start + rows)
        idx = (label - start).clamp(0, rows - 1)
        target = torch.where(inside, x.gather(-1, idx[..., None])[..., 0],
                             0.0)
        if group is not None:
            total = ordered_psum(total, group)
            target = ordered_psum(target, group)
        keep = label != ignore_index
        loss = torch.where(keep, torch.log(total) - target, 0.0)
        ctx.save_for_backward(ex / total[..., None], idx, inside, keep)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        soft, idx, inside, keep = ctx.saved_tensors
        grad = soft.scatter_add(-1, idx[..., None],
                                -inside.to(soft.dtype)[..., None])
        grad = grad * torch.where(keep, g, 0.0)[..., None]
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Cross entropy over vocab-split logits: `(…, vocab / mp)` logits and
    labels shaped like their leading dims (or with a trailing 1), the loss
    a token shaped like the labels (0 at `ignore_index`)."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        group = mp_group_of(mp_group)
        self.group = group
        self.mp_rank = group.rank if group is not None else 0
        self.ignore_index = ignore_index

    def forward(self, input: torch.Tensor, label: torch.Tensor
                ) -> torch.Tensor:
        lab = label.reshape(input.shape[:-1])
        start = self.mp_rank * input.shape[-1]
        loss = _VocabParallelCE.apply(input, lab, self.group, start,
                                      self.ignore_index)
        return loss.reshape(label.shape)


@torch.no_grad()
def bind_mp_group(model: nn.Module, group) -> None:
    """Every mp layer of `model` built whole (no mp group: each holds the
    dense parameters) cut to this rank's part over `group`, in place: the
    parameters keep their objects and names and take this rank's slice
    (GPT's fused QKV through the interleaved (mp, 3, heads / mp, hd)
    layout first), and the layers issue their collectives over `group`
    from then on. A layer already split over a group of `group`'s size is
    left as it is; one split otherwise raises. A one-rank `group` (or
    None) leaves the model dense."""
    from ....serving.tp import interleave_qkv

    n = group.nranks if group is not None else 1
    for mod in model.modules():
        if not isinstance(mod, _MPLayer) or mod.mp_size == n:
            continue
        if mod.mp_size != 1:
            raise ValueError(f"{type(mod).__name__} is split over mp="
                             f"{mod.mp_size}; cannot bind it to {n} ranks")
        mod._setup(group)
        for p in mod.parameters(recurse=False):
            axis = p.split_axis
            full = p.data
            heads = getattr(mod, "interleave_heads", None)
            if heads is not None and axis is not None:
                full = interleave_qkv(full, heads, n)
            p.data = mod._cut(full, axis)
            mod._mark(p, axis)
        if isinstance(mod, VocabParallelEmbedding):
            mod.vocab_start = mod.mp_rank * mod.weight.shape[0]


def mp_shardings(layer: nn.Module) -> Dict[str, tuple]:
    """Every parameter's partition spec in the port's layout: a tuple with
    one entry a dimension, "mp" where the parameter is split."""
    out = {}
    for name, p in layer.named_parameters():
        axis = getattr(p, "split_axis", None)
        out[name] = tuple("mp" if d == axis else None for d in range(p.dim()))
    return out


def mp_full_parameters(model: nn.Module, grads: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Every parameter of `model` (or its gradient) as the whole tensor:
    the mp layers' parts gathered along their split dimension, GPT's QKV
    put back from its interleaved layout (a collective over each layer's
    mp group: every rank of it calls this)."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            t = (p.grad if grads else p).detach()
            if t is None:
                continue
            axis = getattr(p, "split_axis", None)
            if isinstance(mod, _MPLayer) and axis is not None and \
                    mod.group is not None:
                t = gather_dim(t, axis, mod.group)
                heads = getattr(mod, "interleave_heads", None)
                if heads is not None:
                    n = mod.mp_size
                    t = t.reshape(n, 3, heads // n, -1, *t.shape[1:]
                                  ).transpose(0, 1).reshape(t.shape)
            out[f"{mname}.{pname}" if mname else pname] = t
    return out


class RNGStatesTracker:
    """Named RNG streams for tensor-parallel dropout: `torch.Generator`s
    by name, on `device` (default: the port's default device) unless
    `add` names another."""

    def __init__(self, device=None):
        self._states: Dict[str, torch.Generator] = {}
        self.device = device

    def add(self, name: str, seed: int, device=None) -> torch.Generator:
        if name in self._states:
            raise ValueError(f"state {name!r} already exists")
        gen = torch.Generator(device=resolve_device(
            device if device is not None else self.device))
        gen.manual_seed(int(seed))
        self._states[name] = gen
        return gen

    def get_states_tracker(self) -> Dict[str, torch.Generator]:
        return dict(self._states)

    def set_states_tracker(self, states) -> None:
        self._states = dict(states)

    def generator(self, name: str) -> torch.Generator:
        """The stream `name` (added by `add` or
        `model_parallel_random_seed`)."""
        if name not in self._states:
            raise KeyError(f"no RNG stream {name!r}: call "
                           "model_parallel_random_seed(seed) (or add it) "
                           "first")
        return self._states[name]

    @contextlib.contextmanager
    def rng_state(self, name: str = "model-parallel-rng"):
        """The stream `name` for the block (made from a hash of the name
        on first use, as the reference's, one that every process agrees
        on); yields the generator."""
        if name not in self._states:
            self.add(name, zlib.crc32(name.encode()) % (2 ** 31))
        yield self._states[name]


_RNG_STATE_TRACKER = [RNGStatesTracker()]


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER[0]


def model_parallel_random_seed(seed: int = 0, device=None) -> None:
    """A new tracker with "global_seed" (`seed`, the same on every mp
    rank) and "model-parallel-rng" (`seed` + 2718 + this rank's mp index),
    on `device` (default: the port's default device)."""
    group = mp_group_of(None)
    rank = group.rank if group is not None else 0
    tracker = RNGStatesTracker(device)
    tracker.add("global_seed", seed)
    tracker.add("model-parallel-rng", seed + 2718 + rank)
    _RNG_STATE_TRACKER[0] = tracker
