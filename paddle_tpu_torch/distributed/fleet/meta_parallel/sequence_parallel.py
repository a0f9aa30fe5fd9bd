"""Megatron-style sequence parallelism (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/sequence_parallel.py:28-131).

The reference writes the layout changes as sharding constraints and lets
GSPMD pick the collectives. Here they are explicit autograd Functions over
the mp group (the layers' `mp_group`, else fleet's), along a sequence
axis (`axis`: 0 in paddle's [s, b, h], 1 in [b, s, h]), as upstream
Paddle's sequence_parallel_utils:

- `ScatterOp`: this rank's slice forward, all-gather backward;
- `GatherOp`: all-gather forward, this rank's slice backward;
- `AllGatherOp`: all-gather forward, reduce-scatter backward;
- `ReduceScatterOp`: reduce-scatter forward, all-gather backward.

Every sum runs in rank order (`parallel.mesh`). A parameter of a
sequence-parallel region (the row layer's bias, LayerNorms) sees only this
rank's slice of the sequence, so its gradient is partial:
`register_sequence_parallel_allreduce_hooks` sums it over mp.
"""
from __future__ import annotations

import torch

from ....nn import torch_functional as F
from ....parallel.mesh import gather_dim, ordered_psum, split_dim
from .parallel_layers import _MPLayer, mp_group_of

__all__ = [
    "ScatterOp", "GatherOp", "AllGatherOp", "ReduceScatterOp",
    "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
    "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks",
]


def _reduce_scatter(x, axis, group):
    return split_dim(ordered_psum(x.contiguous(), group), axis, group)


class _SeqOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, group, fwd, bwd):
        ctx.axis, ctx.group, ctx.bwd = axis, group, bwd
        return fwd(x, axis, group)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g, ctx.axis, ctx.group), None, None, None, None


def _op(fwd, bwd):
    class Op:
        @staticmethod
        def apply(x: torch.Tensor, axis: int = 0, group=None):
            g = mp_group_of(group)
            if g is None:
                return x
            return _SeqOp.apply(x, axis % x.dim(), g, fwd, bwd)

    return Op


ScatterOp = _op(split_dim, gather_dim)
ScatterOp.__doc__ = "Split the sequence axis over mp (gather backward)."
GatherOp = _op(gather_dim, split_dim)
GatherOp.__doc__ = "Gather the sequence axis (split backward)."
AllGatherOp = _op(gather_dim, _reduce_scatter)
AllGatherOp.__doc__ = ("Gather the sequence axis; the backward sums the "
                       "partial gradients and keeps this rank's slice.")
ReduceScatterOp = _op(_reduce_scatter, gather_dim)
ReduceScatterOp.__doc__ = ("Sum the partials over mp and keep this rank's "
                           "slice of the sequence (gather backward).")


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True
    return param


def register_sequence_parallel_allreduce_hooks(
        model, accumulation_steps=1, fuse_sequence_parallel_allreduce=False):
    """Sum the gradient of every parameter marked sequence-parallel over
    the mp group (rank order), each time it is computed."""
    group = mp_group_of(None)
    if group is None:
        return None
    for p in model.parameters():
        if getattr(p, "sequence_parallel", False):
            p.register_hook(lambda g: ordered_psum(g.contiguous(), group))
    return None


class ColumnSequenceParallelLinear(_MPLayer):
    """The sequence gathered (its gradient reduce-scattered), then a
    column-parallel product; the output stays split over mp unless
    `gather_output`. Input (b, s / mp, in)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._setup(mp_group)
        self.gather_output = gather_output
        self.weight = self._param((out_features, in_features), 0, device,
                                  dtype)
        self.bias = (self._param((out_features,), 0, device, dtype, True)
                     if has_bias else None)

    def forward(self, x):
        x = AllGatherOp.apply(x, 1, self.group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output and self.group is not None:
            from ....parallel.mesh import gather_from_tp_region

            out = gather_from_tp_region(out, self.group)
        return out


class RowSequenceParallelLinear(_MPLayer):
    """A row-parallel product, its partials summed over mp and scattered
    along the sequence, then the bias (a sequence-parallel parameter).
    Input (b, s, in / mp), output (b, s / mp, out)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self._setup(mp_group)
        self.weight = self._param((out_features, in_features), 1, device,
                                  dtype)
        self.bias = None
        if has_bias:
            self.bias = mark_as_sequence_parallel_parameter(
                self._param((out_features,), None, device, dtype, True))

    def forward(self, x):
        out = ReduceScatterOp.apply(F.linear(x, self.weight), 1, self.group)
        if self.bias is not None:
            out = F.add(out, self.bias)
        return out
