"""The SPMD collective pipeline: GPipe over the stage ranks of a pp group
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/
spmd_pipeline.py:50-122).

The reference is one program inside `shard_map`: each stage's params are
a slice of a stacked leading dimension, a tick computes every stage and
`ppermute` hands each activation on, and `jax.grad` derives the backward.
Here each rank of the group is one stage holding its own parameters (a
port cannot stack a stage's modules as an array dimension), and the
hand-off is `distributed.send` / `recv`:

- forward: micro-batch m enters stage 0, each stage sends its output to
  the next; the last stage's outputs are broadcast to every rank (a sum in
  rank order over the group with zeros on the other stages, as the
  reference's masked `psum`), so every rank can compute the loss;
- backward (an autograd Function): micro-batches in order, each stage
  recomputes its forward (the reference's rematerialization), takes the
  gradient from the next stage (the last stage from the output's
  gradient), sends its input's gradient to the previous one; the
  gradient of the replicated input `x_mb` is stage 0's, summed over the
  group so every rank holds it.

`stage_fn(params, x) -> y` with `y.shape == x.shape` (homogeneous stages).
With a data-parallel group, each dp rank pipelines its rows, the outputs
are gathered back, and the stage parameters' gradients summed over dp.
"""
from __future__ import annotations

from typing import Dict

import torch

from ... import communication as C
from ....parallel.mesh import (copy_to_tp_region, gather_dim, ordered_psum,
                               split_dim)

__all__ = ["spmd_pipeline", "make_spmd_pipeline_fn"]


def _pp_group(group):
    if group is None:
        from .. import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        group = hcg.get_pipe_parallel_group() if hcg is not None else None
    return group if group is not None and group.nranks > 1 else None


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, names, group, x_mb, *params):
        s, n = (group.rank, group.nranks) if group is not None else (0, 1)
        p = dict(zip(names, params))
        ins, outs = [], []
        for m in range(x_mb.shape[0]):
            x = x_mb[m] if s == 0 else C.recv(torch.empty_like(x_mb[m]),
                                              s - 1, group)
            y = stage_fn(p, x)
            if s < n - 1:
                C.send(y.contiguous(), s + 1, group)
            ins.append(x)
            outs.append(y)
        out = torch.stack(outs) if s == n - 1 else torch.zeros_like(x_mb)
        if group is not None:
            out = ordered_psum(out, group)
        ctx.stage_fn, ctx.names, ctx.group, ctx.ins = stage_fn, names, \
            group, ins
        ctx.save_for_backward(*params)
        return out

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        s, n = (group.rank, group.nranks) if group is not None else (0, 1)
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in ctx.saved_tensors]
        wrt = [p for p in leaves if p.requires_grad]
        sums = [torch.zeros_like(p) for p in wrt]
        gx_all = torch.zeros_like(g)
        for m, x_in in enumerate(ctx.ins):
            gy = g[m] if s == n - 1 else C.recv(torch.empty_like(g[m]),
                                               s + 1, group)
            with torch.enable_grad():
                x = x_in.detach().requires_grad_(True)
                y = ctx.stage_fn(dict(zip(ctx.names, leaves)), x)
                got = torch.autograd.grad(y, [x] + wrt, gy,
                                          allow_unused=True)
            for i, gp in enumerate(got[1:]):
                if gp is not None:
                    sums[i] = sums[i] + gp
            if s > 0:
                C.send(got[0].contiguous(), s - 1, group)
            else:
                gx_all[m] = got[0]
        if group is not None:
            gx_all = ordered_psum(gx_all, group)
        grads = iter(sums)
        return (None, None, None, gx_all,
                *(next(grads) if p.requires_grad else None for p in leaves))


def spmd_pipeline(stage_fn, stage_params: Dict[str, torch.Tensor], x_mb,
                  *, num_stages: int, group=None):
    """`num_stages` stages over micro-batches `x_mb` (M, mb, ...), this
    rank's stage holding `stage_params`: returns the last stage's (M, mb,
    ...) outputs on every rank. Differentiable in `x_mb` and the
    parameters."""
    g = _pp_group(group)
    n = g.nranks if g is not None else 1
    if n != num_stages:
        raise ValueError(f"num_stages={num_stages} over a group of {n} "
                         "ranks: each rank is one stage")
    names = list(stage_params)
    return _GPipe.apply(stage_fn, names, g, x_mb,
                        *(stage_params[k] for k in names))


class _Rows(torch.autograd.Function):
    """This data rank's rows forward (`take`) and all rows backward, or
    the reverse (`gather`)."""

    @staticmethod
    def forward(ctx, x, group, take):
        ctx.group, ctx.take = group, take
        return split_dim(x, 0, group) if take else gather_dim(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        return (gather_dim(g, 0, ctx.group) if ctx.take
                else split_dim(g, 0, ctx.group)), None, None


def make_spmd_pipeline_fn(stage_fn, group=None, *, num_stages: int,
                          num_micro: int, data_group=None):
    """`fn(stage_params, x) -> y`: the batch split into `num_micro`
    micro-batches and pipelined over the pp `group` (each dp rank of
    `data_group` takes its rows), outputs in batch layout."""
    g = _pp_group(group)
    dg = data_group if data_group is not None and data_group.nranks > 1 \
        else None

    def fn(stage_params, x):
        if dg is not None:
            x = _Rows.apply(x, dg, True)
            # replicated over dp: the gradient summed in rank order
            stage_params = {k: copy_to_tp_region(v, dg)
                            for k, v in stage_params.items()}
        b = x.shape[0]
        if b % num_micro:
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{num_micro} micro-batches")
        x_mb = x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))
        y = spmd_pipeline(stage_fn, stage_params, x_mb,
                          num_stages=num_stages, group=g)
        y = y.reshape((b,) + tuple(x.shape[1:]))
        return _Rows.apply(y, dg, False) if dg is not None else y

    return fn
