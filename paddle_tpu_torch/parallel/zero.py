"""ZeRO-sharded data-parallel training over `torch.distributed`
(counterpart of paddle_tpu/parallel/zero.py:1-1300).

Each rank is a process of a `distributed.Group` and runs the same call
with the GLOBAL batch, taking its own 1/dp of the rows (what `shard_map`
gives each shard in the reference). Instead of every rank holding the
whole optimizer state and applying the same update, the update itself is
sharded (arxiv 2004.13336):

    reduce-scatter grads -> the optimizer's update on this rank's 1/dp
    flat slice -> all-gather the updated slices

- **stage 0**: every gradient all-reduced in a fixed order, the whole
  update on every rank (the baseline);
- **stage 1** (ZeRO-1, paddle's "os"): the same all-reduced gradient, the
  update on this rank's slice only: optimizer bytes a rank drop to 1/dp;
- **stage 2** (ZeRO-2, "os_g"): the gradient is reduce-scattered, so the
  full summed gradient never exists in the update.

**Bit-parity at fp32, by construction.** Every stage sums gradients in
rank order (`mesh.ordered_psum`, `mesh.ordered_psum_scatter`, whose slice
is bit-identical to slicing the ordered sum), and the update is the
optimizer's own elementwise `functional_step`, so updating a slice and
gathering equals updating the whole. ZeRO-1 / 2 equal stage 0 bit for
bit at every dp, as long as the loss's own backward gives the same bits
every run: on CUDA, PyTorch's default embedding backward sums a row that
many tokens share in a run-dependent order, and
`torch.use_deterministic_algorithms(True)` selects its deterministic form.
Across dp degrees the batch sum changes order, so no bit parity is
claimed there.

**State layout and degree-blind checkpoints.** Under sharding each slot
shaped like its parameter is held as this rank's (chunk,) slice of the
parameter's flat, zero-padded to dp * chunk (chunk = ceil(numel / dp));
0-d slots (NAdam's momentum product) stay whole. `save_optimizer_state`
gathers the full logical tensors (a collective: every rank calls it) and
`load_optimizer_state` slices them for any dp: save at dp 4, restore at
dp 2.

**Buckets and overlap.** With `bucket_bytes`, the per-leaf gradients are
packed into fixed-byte flat buckets in a shard-major layout (each leaf's
padded flat shaped (dp, chunk), concatenated along chunk), so one
reduce-scatter of a bucket hands rank i the concatenation of every
member's slice i, each element summed in the same order as per leaf. With
`overlap=True` the buckets ride `mesh.ring_pipeline` with work handles
(`async_op=True`): bucket j+1's transport is in flight before bucket j's
reduce and update, and bucket j's all-gather stays in flight under bucket
j+1's update. The schedule moves bytes earlier and never reorders a sum,
so overlapped fp32 equals serial fp32 bit for bit.

**Mixed precision** (`param_dtype="bf16"`): working weights (and the
gradients on the wire) are bf16, the optimizer state carries fp32 master
weights (the optimizer's `multi_precision` slot, in the same sharded
layout) and the update runs in fp32 against them. The loss is multiplied
by a power-of-two scale held on the device (`opt_state["__scaler__"]`);
the update unscales in fp32; a count of non-finite local gradients,
summed over the ranks in rank order, decides on the device whether the
step stands: a non-finite step keeps the old parameters and state and
halves the scale, `scale_growth_interval` good steps double it (within
[1, 2^24]). No host read. The dp sums run in bf16, so bf16 is a bounded-
error mode: no stage parity is claimed there.

**Tensor parallelism** (`tp > 1` with `param_specs`, reference
:553-584 and its TP composition from :585): a spec names the dimension a
parameter is split along over the tp axis (`("tp", None)`, or fleet's
"mp"; `parallel.mesh.tp_dim_spec`). `init_state` takes the full logical
parameters and keeps this rank's tp part; the dp machinery then slices
each part's TP-LOCAL flat, so dp x tp compose with no special case. The
ranks of `group` are laid out dp-major (rank = d * tp + t, the
reference's mesh order) and the step makes its dp and tp groups from it,
or takes them from the caller (`group` the dp group, `tp_group` the tp
group, as fleet's `HybridParallelOptimizer.zero_train_step` passes). The
loss function runs under `mesh.tp_scope(tp_group)`: the Megatron region
helpers (`copy_to_tp_region`, `reduce_from_tp_region`) find their group
there. The checkpoint's full logical state is the tp parts gathered along
their split dimension, so it restores at any (dp, tp).

**The GroupSharded surface** (reference :1319-1514): `GroupShardedStage2`
and `GroupShardedOptimizerStage2` are stages 1 / 2 in the eager style
(`loss.backward()`, `opt.step()`) over this module's update functions;
`GroupShardedStage3` keeps each parameter as this rank's flat (chunk,)
slice, gathers it on use in the forward (and again in the backward: the
autograd graph keeps a token, not the gathered tensor) and
reduce-scatters its gradient in rank order, so its update equals stage
0's bit for bit. `offload=True` keeps the optimizer slots in host memory
(pinned when there is a card) and brings them to the device for the
update. `group_sharded_parallel(level="os" | "os_g" | "p_g_os")` and
`save_group_sharded_model` are the entry points.

**Refused**, with the reference's messages: stage 3 of `ZeroTrainStep`
(that is `GroupShardedStage3`); `grad_clip` (a clip over a slice would
use the slice's norm); the whole-tensor rules Lamb and LBFGS; a batch
that dp x grad_accum does not divide; bucket_bytes / overlap at stage 0.

**Observability** (opt-in, `telemetry=` / `enable_telemetry=True`, which
import `observability.training` lazily): every health number of a step
(loss, gradient / parameter / update norms, non-finite counts, the loss
scale and the skipped flag) is computed on the device into one vector
and read in one device-to-host copy. The probes `collective_seconds`,
`shard_step_seconds`, `comm_seconds` and `measure_overlap_fraction` are
collectives too: every rank calls them together.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mesh import (TP_AXIS, fixed_order_sum, gather_dim, ordered_psum,
                   ordered_psum_scatter, ring_pipeline, start_all_gather,
                   start_ordered_psum_scatter, tp_dim_spec, tp_scope)

__all__ = [
    "ZeroTrainStep", "zero_train_step", "model_loss",
    "build_bucket_layout",
    "save_optimizer_state", "load_optimizer_state",
    "GroupShardedStage2", "GroupShardedStage3",
    "GroupShardedOptimizerStage2", "group_sharded_parallel",
    "save_group_sharded_model",
]

# whole-tensor update rules: a 1/dp slice changes their math
_NON_ELEMENTWISE = ("Lamb", "LBFGS")
# the opt-state entry holding the loss scaler's scalars under bf16
_SCALER_KEY = "__scaler__"
_SCALE_BACKOFF = 0.5
_SCALE_GROWTH = 2.0
_SCALE_MIN = 1.0
_SCALE_MAX = 2.0 ** 24


def model_loss(model, criterion=None):
    """A `loss_fn(params, x, y) -> scalar` over a module through
    `torch.func.functional_call`, mean squared error by default. The mean
    is over the LOCAL rows: the step averages the ranks' losses."""
    from torch.func import functional_call

    def loss_fn(params, x, y):
        out = functional_call(model, params, (x,))
        if criterion is None:
            return torch.mean((out - y) ** 2)
        return criterion(out, y)

    return loss_fn


def _pad_flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flattened and zero-padded to length n. The padding is update-
    neutral for every elementwise rule (pad parameters and gradients are
    0)."""
    flat = x.reshape(-1)
    if flat.numel() == n:
        return flat
    return torch.nn.functional.pad(flat, (0, n - flat.numel()))


# ------------------------------------------------------------ buckets
def build_bucket_layout(names: Sequence[str], chunks: Dict[str, int],
                        itemsize: int, dp: int,
                        bucket_bytes: Optional[int]) -> List[Dict]:
    """Greedy fixed-byte bucketing of the padded per-leaf flats (the
    reference's function, line for line). Leaves in parameter order; a
    leaf's footprint is dp * chunk * itemsize bytes; a new bucket starts
    when the next leaf would pass `bucket_bytes`, and a leaf larger than
    the cap gets a bucket of its own (leaves are never split).
    `bucket_bytes=None` gives one bucket a leaf. Returns one dict a
    bucket: `names`, `offs` (each member's offset in the bucket's per-rank
    slice) and `width` (that slice's length)."""
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    cap = None
    if bucket_bytes is not None:
        cap = int(bucket_bytes)
        if cap <= 0:
            raise ValueError(
                f"bucket_bytes must be > 0 (or None), got {bucket_bytes}")
    groups: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for k in names:
        nbytes = dp * int(chunks[k]) * int(itemsize)
        if cur and (cap is None or cur_bytes + nbytes > cap):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(k)
        cur_bytes += nbytes
    if cur:
        groups.append(cur)
    out = []
    for member_names in groups:
        offs: Dict[str, int] = {}
        width = 0
        for k in member_names:
            offs[k] = width
            width += int(chunks[k])
        out.append({"names": tuple(member_names), "offs": offs,
                    "width": width})
    return out


def _pack_bucket(ctx, bucket, grads) -> torch.Tensor:
    """One bucket's gradients in the shard-major flat: each leaf's padded
    flat as (dp, chunk), concatenated along chunk, flattened."""
    rows = [_pad_flat(grads[k], ctx.dp * ctx._chunks[k])
            .reshape(ctx.dp, ctx._chunks[k]) for k in bucket["names"]]
    packed = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
    return packed.reshape(-1)


# ----------------------------------------------------------- step bodies
def _accumulated_grads(ctx, params, batch, scale=None):
    """This rank's loss and gradients, averaged over `ctx.grad_accum`
    micro-batches of its rows (summed in order). With `scale` (bf16) the
    loss is multiplied by it before the backward; the loss returned is
    unscaled and the gradients stay scaled and unaveraged (the update
    folds 1 / (dp * grad_accum * scale) into one fp32 multiply)."""
    names = list(params)
    k = ctx.grad_accum
    per = batch[0].shape[0] // k
    loss_sum, gsum = None, None
    for j in range(k):
        micro = batch if k == 1 else tuple(
            b[j * per:(j + 1) * per] if split else b
            for b, split in zip(batch, ctx._row_split))
        leaves = {n: params[n].detach().requires_grad_(
            params[n].is_floating_point()) for n in names}
        with torch.enable_grad(), tp_scope(ctx.tp_group):
            loss = ctx.loss_fn(leaves, *micro)
            target = loss if scale is None else loss * scale
            wrt = [leaves[n] for n in names if leaves[n].requires_grad]
            got = iter(torch.autograd.grad(target, wrt, allow_unused=True))
        grads = {}
        for n in names:
            g = next(got) if leaves[n].requires_grad else None
            grads[n] = torch.zeros_like(params[n]) if g is None else g
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        gsum = grads if gsum is None else {n: gsum[n] + grads[n]
                                           for n in names}
    if k == 1:
        return loss_sum, gsum
    inv = 1.0 / k
    if scale is not None:
        return loss_sum * inv, gsum
    return loss_sum * inv, {n: g * inv for n, g in gsum.items()}


def _unscale_shard(ctx, shard, scale):
    """A reduced gradient (or slice) made ready for the update: times 1/dp
    at fp32; in bf16 mode cast to fp32, then times 1 / (dp * grad_accum)
    and the inverse loss scale in one fp32 multiply."""
    if scale is None:
        return shard * (1.0 / ctx.dp)
    inv = 1.0 / (ctx.dp * ctx.grad_accum)
    return shard.float() * (inv / scale)


def _grad_nonfinite(ctx, grads) -> torch.Tensor:
    """The count of non-finite elements of this rank's (scaled, not yet
    reduced) gradients, summed over the ranks in rank order: the scaler's
    skip signal, taken before any sum mixes ranks."""
    total = torch.stack([(~torch.isfinite(g)).sum().float()
                         for g in grads.values()]).sum()
    return ordered_psum(total.reshape(1), ctx.group)[0]


def _scaler_next(ctx, scaler, finite):
    """One transition of the loss scale, on the device."""
    scale, good = scaler["scale"], scaler["good_steps"]
    good1 = good + 1.0
    grown = finite & (good1 >= float(ctx.scale_growth_interval))
    up = torch.clamp(scale * _SCALE_GROWTH, max=_SCALE_MAX)
    down = torch.clamp(scale * _SCALE_BACKOFF, min=_SCALE_MIN)
    new_scale = torch.where(finite, torch.where(grown, up, scale), down)
    new_good = torch.where(finite, torch.where(grown, torch.zeros_like(good),
                                               good1), torch.zeros_like(good))
    return {"scale": new_scale, "good_steps": new_good}


def _replicated_update(ctx, params, grads, state, lr, t, scale=None):
    """Stage 0: every gradient all-reduced in rank order, the whole update
    on every rank. Returns (new params, new state, telemetry aux)."""
    if scale is None:
        g = {k: ordered_psum(grads[k], ctx.group) * (1.0 / ctx.dp)
             for k in grads}
    else:
        g = {k: _unscale_shard(ctx, ordered_psum(grads[k], ctx.group),
                               scale) for k in grads}
    new_p, new_s = ctx.optimizer.functional_step(
        params, g, {k: state[k] for k in params}, lr, t)
    aux = None
    if ctx._telemetry is not None:
        aux = ctx._trmod.grad_leaf_stats(ctx, g, dp_reduce=False)
    return new_p, new_s, aux


def _gather_leaf(ctx, name, piece) -> torch.Tensor:
    """The full parameter from every rank's updated (chunk,) slice."""
    full = torch.cat(ctx._all_gather(piece))
    return full[:ctx._sizes[name]].reshape(ctx._shapes[name])


def _sharded_update(ctx, params, grads, state, lr, t, scale=None):
    """ZeRO-1 / 2 per leaf: this rank's slice of the parameter and of the
    reduced gradient (stage 1: sliced from the all-reduced gradient; stage
    2: reduce-scattered), the update on the slices, then each parameter
    gathered back."""
    i = ctx.rank
    sliced_p, sliced_g, local_state = {}, {}, {}
    for k in params:
        chunk = ctx._chunks[k]
        padded = ctx.dp * chunk
        if ctx.stage >= 2:
            gs = ordered_psum_scatter(_pad_flat(grads[k], padded), ctx.group)
        else:
            gs = _pad_flat(ordered_psum(grads[k], ctx.group),
                           padded)[i * chunk:(i + 1) * chunk]
        sliced_g[k] = _unscale_shard(ctx, gs, scale)
        sliced_p[k] = _pad_flat(params[k], padded)[i * chunk:(i + 1) * chunk]
        local_state[k] = state[k]
    new_slices, new_state = ctx.optimizer.functional_step(
        sliced_p, sliced_g, local_state, lr, t)
    new_params = {k: _gather_leaf(ctx, k, new_slices[k]) for k in params}
    aux = None
    if ctx._telemetry is not None:
        aux = ctx._trmod.grad_leaf_stats(ctx, sliced_g, dp_reduce=True)
    return new_params, new_state, aux


def _slice_local(ctx, params, state, bucket, shard, sliced_p, sliced_g,
                 local_state):
    """One bucket's reduced slice split back into per-leaf (chunk,)
    gradients at the layout's offsets, with this rank's parameter slice
    and state of each member."""
    i = ctx.rank
    for k in bucket["names"]:
        off, chunk = bucket["offs"][k], ctx._chunks[k]
        sliced_g[k] = shard[off:off + chunk]
        sliced_p[k] = _pad_flat(params[k], ctx.dp * chunk)[
            i * chunk:(i + 1) * chunk]
        local_state[k] = state[k]


def _unpack_gathered(ctx, bucket, gathered, new_params):
    """(dp, width) gathered bucket -> its members' full parameters."""
    for k in bucket["names"]:
        off, chunk = bucket["offs"][k], ctx._chunks[k]
        full = gathered[:, off:off + chunk].reshape(-1)
        new_params[k] = full[:ctx._sizes[k]].reshape(ctx._shapes[k])


def _cat_bucket(bucket, slices):
    names = bucket["names"]
    return (torch.cat([slices[k] for k in names]) if len(names) > 1
            else slices[names[0]])


def _bucketed_update(ctx, params, grads, state, lr, t, scale=None):
    """ZeRO-1 / 2 over buckets, serial: one reduce-scatter (stage 2) or
    all-reduce and slice (stage 1) a bucket, one update over all leaves,
    one all-gather a bucket."""
    i = ctx.rank
    sliced_p, sliced_g, local_state = {}, {}, {}
    for bucket in ctx._buckets:
        width = bucket["width"]
        flat = _pack_bucket(ctx, bucket, grads)
        if ctx.stage >= 2:
            shard = ordered_psum_scatter(flat, ctx.group)
        else:
            shard = ordered_psum(flat, ctx.group)[i * width:(i + 1) * width]
        _slice_local(ctx, params, state, bucket,
                     _unscale_shard(ctx, shard, scale), sliced_p, sliced_g,
                     local_state)
    new_slices, new_state = ctx.optimizer.functional_step(
        sliced_p, sliced_g, local_state, lr, t)
    new_params = {}
    for bucket in ctx._buckets:
        gathered = torch.stack(ctx._all_gather(_cat_bucket(bucket,
                                                           new_slices)))
        _unpack_gathered(ctx, bucket, gathered, new_params)
    aux = None
    if ctx._telemetry is not None:
        aux = ctx._trmod.grad_leaf_stats(ctx, sliced_g, dp_reduce=True)
    return new_params, new_state, aux


def _overlapped_update(ctx, params, grads, state, lr, t, scale=None):
    """ZeRO-1 / 2 over buckets with the transport in flight: bucket j+1's
    reduce-scatter (or all-gather, stage 1) starts before bucket j is
    reduced and updated, and bucket j's all-gather of updated slices stays
    in flight under bucket j+1's update. Same sums, same bits as
    `_bucketed_update`."""
    i = ctx.rank
    buckets = ctx._buckets
    gathered: List = [None] * len(buckets)
    new_state: Dict = {}
    stat_slices: Dict = {}

    def transport(bucket):
        flat = _pack_bucket(ctx, bucket, grads)
        if ctx.stage >= 2:
            return start_ordered_psum_scatter(flat, ctx.group)
        return start_all_gather(flat, ctx.group), bucket["width"]

    def reduce(moved):
        if ctx.stage >= 2:
            return moved.wait()
        work, width = moved
        full = fixed_order_sum(list(work.wait().unbind(0)))
        return full[i * width:(i + 1) * width]

    def consume(j, shard):
        bucket = buckets[j]
        sliced_p, sliced_g, local_state = {}, {}, {}
        _slice_local(ctx, params, state, bucket,
                     _unscale_shard(ctx, shard, scale), sliced_p, sliced_g,
                     local_state)
        new_sl, new_st = ctx.optimizer.functional_step(
            sliced_p, sliced_g, local_state, lr, t)
        new_state.update(new_st)
        stat_slices.update(sliced_g)
        gathered[j] = start_all_gather(_cat_bucket(bucket, new_sl),
                                       ctx.group)

    ring_pipeline(buckets, transport, reduce, consume)
    new_params: Dict = {}
    for j, bucket in enumerate(buckets):
        _unpack_gathered(ctx, bucket, gathered[j].wait(), new_params)
    aux = None
    if ctx._telemetry is not None:
        aux = ctx._trmod.grad_leaf_stats(
            ctx, {k: stat_slices[k] for k in params}, dp_reduce=True)
    return new_params, new_state, aux


def _carve(group, tp: int):
    """(this rank's dp group, its tp group) of a group laid out dp-major
    (rank = d * tp + t). Every rank of the world makes every group, in
    the same order."""
    from ..distributed.group import new_group

    if group.nranks % tp:
        raise ValueError(f"a group of {group.nranks} ranks does not split "
                         f"into tp={tp}")
    dp = group.nranks // tp
    me = group.ranks[group.rank] if group.rank >= 0 else None
    mine = {}
    for kind, lists in (
            ("dp", [[group.ranks[d * tp + t] for d in range(dp)]
                    for t in range(tp)]),
            ("tp", [[group.ranks[d * tp + t] for t in range(tp)]
                    for d in range(dp)])):
        for ranks in lists:
            g = new_group(ranks)
            if me in ranks:
                mine[kind] = g
    return mine["dp"], mine["tp"]


# ------------------------------------------------------------ the step
def _timed(fn, dev, trials: int) -> List[float]:
    """Host-clock seconds of `fn()` per trial, the card synchronized
    around each."""
    out = []
    for _ in range(trials):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t0)
    return out


class ZeroTrainStep:
    """One train step `(params, opt_state, batch, lr, t) -> (loss, params,
    opt_state)` over the ranks of a `distributed.Group`, the optimizer
    update sharded over them per `stage` (see the module docstring). Build
    once per (model, optimizer, group); `init_state` builds the parameters
    and state, the instance is the step. Every rank calls every method
    together (each is a collective)."""

    def __init__(self, model, optimizer, loss_fn=None, *, criterion=None,
                 dp: Optional[int] = None, tp: int = 1, stage: int = 1,
                 param_specs=None, batch_specs: Optional[Sequence] = None,
                 grad_accum: int = 1, group=None, tp_group=None,
                 bucket_bytes: Optional[int] = None, overlap: bool = False,
                 param_dtype: Optional[str] = None,
                 loss_scale: float = 2.0 ** 15,
                 scale_growth_interval: int = 200,
                 telemetry=None, enable_telemetry: bool = False):
        from ..distributed.group import _default

        if stage not in (0, 1, 2):
            raise ValueError(
                f"stage must be 0 (replicated baseline), 1 (ZeRO-1) or 2 "
                f"(ZeRO-2); got {stage} — stage 3 (param sharding) is the "
                "GroupSharded surface (level='p_g_os')")
        opt_name = type(optimizer).__name__
        if opt_name in _NON_ELEMENTWISE:
            raise NotImplementedError(
                f"{opt_name} applies whole-tensor update rules; the "
                "dp-sliced update would change its math. Use an "
                "elementwise optimizer (SGD/Momentum/Adam/AdamW/...)")
        if getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError(
                "grad_clip inside the sharded update would clip by the "
                "SLICE norm, not the global norm; clip before the step or "
                "use the GSPMD GroupSharded surface with "
                "HybridParallelClipGrad")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = (loss_fn if loss_fn is not None
                        else model_loss(model, criterion))
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.param_specs = dict(param_specs or {})
        group = group if group is not None else _default()
        self.tp_group = None
        if self.tp > 1:
            if tp_group is None:
                group, tp_group = _carve(group, self.tp)
            if tp_group.nranks != self.tp:
                raise ValueError(f"tp={self.tp} but the tp group has "
                                 f"{tp_group.nranks} ranks")
            self.tp_group = tp_group
        self.group = group
        self.rank = self.group.rank
        self.tp_rank = self.tp_group.rank if self.tp_group is not None else 0
        self.dp = int(dp) if dp is not None else self.group.nranks
        if self.dp != self.group.nranks:
            raise ValueError(f"dp={self.dp} but the group has "
                             f"{self.group.nranks} ranks: dp is the group's "
                             "size")
        self.stage = int(stage)
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.batch_specs = (tuple(batch_specs) if batch_specs is not None
                            else None)
        if self.grad_accum > 1 and self.batch_specs is not None and any(
                s != "dp" for s in self.batch_specs):
            raise ValueError(
                "grad_accum > 1 splits every batch leaf along its local "
                "rows, so all batch_specs must be 'dp'")
        self._sharded = self.stage >= 1 and self.dp > 1
        if bucket_bytes is not None and int(bucket_bytes) <= 0:
            raise ValueError(
                f"bucket_bytes must be > 0 (or None), got {bucket_bytes}")
        if self.stage == 0 and (overlap or bucket_bytes is not None):
            raise ValueError(
                "bucket_bytes/overlap schedule the SHARDED collectives; "
                "stage 0 has none — use stage 1 or 2")
        self.bucket_bytes = (int(bucket_bytes) if bucket_bytes is not None
                             else None)
        self.overlap = bool(overlap)
        self._bucketed = self._sharded and (self.bucket_bytes is not None
                                            or self.overlap)
        self._overlap = self._sharded and self.overlap
        if param_dtype in (None, "float32", "fp32", "f32"):
            self._param_dtype = None
        elif param_dtype in ("bf16", "bfloat16"):
            self._param_dtype = torch.bfloat16
        else:
            raise ValueError(
                f"param_dtype must be None/'float32' or 'bf16', "
                f"got {param_dtype!r}")
        self.loss_scale = float(loss_scale)
        self.scale_growth_interval = int(scale_growth_interval)
        if self._param_dtype is not None:
            if self.loss_scale < 1.0:
                raise ValueError(
                    f"loss_scale must be >= 1, got {loss_scale}")
            if self.scale_growth_interval < 1:
                raise ValueError(
                    "scale_growth_interval must be >= 1, got "
                    f"{scale_growth_interval}")
            # the optimizer's master slot is the fp32 master-weight store
            self.optimizer._multi_precision = True
        self._buckets: List[Dict] = []
        self._overlap_fraction: Optional[float] = None
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._full_shapes: Dict[str, Tuple[int, ...]] = {}
        self._spec_dim: Dict[str, Optional[int]] = {}
        self._sizes: Dict[str, int] = {}
        self._chunks: Dict[str, int] = {}
        self._row_split: Tuple[bool, ...] = ()
        self.device = None
        self._telemetry = None
        self._trmod = None
        if telemetry is not None or enable_telemetry:
            from ..observability import training as _trmod

            self._trmod = _trmod
            self._telemetry = (telemetry if telemetry is not None
                               else _trmod.TrainingTelemetry())
            self._telemetry.bind(dp=self.dp, tp=self.tp, stage=self.stage,
                                 device_ids=list(range(self.dp)))

    # ---------------------------------------------------------- helpers
    def _all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        from ..distributed.communication import all_gather

        return all_gather(None, x, self.group)

    def _tp_dim(self, name: str) -> Optional[int]:
        spec = self.param_specs.get(name)
        dim = tp_dim_spec(spec, TP_AXIS)
        return dim if dim is not None else tp_dim_spec(spec, "mp")

    def _tp_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's tp part of a full logical tensor of parameter
        `name` (the whole tensor when it is not split, or 0-d)."""
        dim = self._spec_dim.get(name)
        if self.tp == 1 or dim is None or full.dim() == 0:
            return full
        if full.shape[dim] % self.tp:
            raise ValueError(f"{name}: dim {dim} of {tuple(full.shape)} "
                             f"does not split over tp={self.tp}")
        n = full.shape[dim] // self.tp
        return full.narrow(dim, self.tp_rank * n, n)

    def _tp_whole(self, name: str, part: torch.Tensor) -> torch.Tensor:
        """The full logical tensor from every tp rank's part (a collective
        over the tp group)."""
        dim = self._spec_dim.get(name)
        if self.tp == 1 or dim is None or part.dim() == 0:
            return part
        return gather_dim(part, dim, self.tp_group)

    def full_params(self, params: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """The full logical parameters from this step's tp parts (a
        collective over the tp group; the parts themselves when tp is
        1)."""
        return {k: self._tp_whole(k, v) for k, v in params.items()}

    def _record_geometry(self, params: Dict[str, torch.Tensor]) -> None:
        for name, arr in params.items():
            self._full_shapes[name] = tuple(arr.shape)
            self._spec_dim[name] = self._tp_dim(name)
            arr = self._tp_part(name, arr)
            self._shapes[name] = tuple(arr.shape)
            self._sizes[name] = max(arr.numel(), 1)
            self._chunks[name] = max(math.ceil(self._sizes[name] / self.dp),
                                     1)
        if self._bucketed:
            itemsize = 2 if self._param_dtype is not None else 4
            self._buckets = build_bucket_layout(
                list(params), self._chunks, itemsize, self.dp,
                self.bucket_bytes)

    def _is_sharded_slot(self, name: str, arr: torch.Tensor) -> bool:
        if not self._sharded or arr.dim() == 0:
            return False
        if tuple(arr.shape) != self._shapes[name]:
            raise NotImplementedError(
                f"slot of shape {tuple(arr.shape)} for parameter {name!r} "
                f"{self._shapes[name]}: the sharded layout holds slots "
                "shaped like their parameter (or 0-d)")
        return True

    # -------------------------------------------------------- placement
    def init_state(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """The step's parameters (a dict of tensors of their own, in the
        working type; this rank's tp parts) and optimizer state (sharded
        per stage) from `params` (default: the model's), full logical
        tensors on every rank."""
        if params is None:
            params = {n: p.detach() for n, p in self.model.named_parameters()}
        params = {k: torch.as_tensor(v) for k, v in params.items()}
        self.device = next(iter(params.values())).device
        self._record_geometry(params)
        params = {k: self._tp_part(k, v) for k, v in params.items()}
        work = {k: (v.to(self._param_dtype) if self._param_dtype is not None
                    and v.is_floating_point() else v).detach().clone()
                for k, v in params.items()}
        host = self.optimizer.functional_state(work)
        if self.tp > 1:
            # the host form is full logical: each slot's tp parts gathered
            host = {k: {s: self._tp_whole(k, v) for s, v in acc.items()}
                    for k, acc in host.items()}
        if self._param_dtype is not None:
            for k, v in params.items():
                if "master_weight" in host.get(k, {}):
                    # the master from the ORIGINAL fp32 value, not the
                    # bf16 round trip
                    host[k]["master_weight"] = self._tp_whole(
                        k, v.detach().float().clone())
            host[_SCALER_KEY] = {
                "scale": torch.tensor(self.loss_scale, dtype=torch.float32),
                "good_steps": torch.tensor(0.0, dtype=torch.float32)}
        return work, self.load_optimizer_state(host)

    def load_optimizer_state(self, host_state):
        """Full logical state (any device, saved at any dp or tp) -> this
        rank's state for this (dp, tp, stage)."""
        if not self._shapes:
            raise RuntimeError(
                "call init_state() (or pass params to it) before "
                "load_optimizer_state — the engine needs param geometry")
        out = {}
        for name, acc in host_state.items():
            slots = {}
            for slot, arr in acc.items():
                arr = torch.as_tensor(arr).to(self.device)
                if name != _SCALER_KEY:
                    arr = self._tp_part(name, arr)
                if name != _SCALER_KEY and self._is_sharded_slot(name, arr):
                    chunk = self._chunks[name]
                    arr = _pad_flat(arr, self.dp * chunk)[
                        self.rank * chunk:(self.rank + 1) * chunk]
                slots[slot] = arr.clone()
            out[name] = slots
        return out

    def save_optimizer_state(self, opt_state):
        """This rank's state -> full logical CPU tensors, restorable at any
        dp or tp by `load_optimizer_state` (every rank calls it: it
        gathers)."""
        out = {}
        for name, acc in opt_state.items():
            slots = {}
            for slot, arr in acc.items():
                if name != _SCALER_KEY and self._sharded and arr.dim() >= 1:
                    arr = _gather_leaf(self, name, arr)
                if name != _SCALER_KEY:
                    arr = self._tp_whole(name, arr)
                slots[slot] = arr.detach().cpu().clone()
            out[name] = slots
        return out

    # ------------------------------------------------------------ step
    def _local_rows(self, batch):
        rows = batch[0].shape[0]
        if rows % (self.dp * self.grad_accum):
            raise ValueError(
                f"a batch of {rows} rows does not split over dp={self.dp} "
                f"x grad_accum={self.grad_accum}")
        specs = (self.batch_specs if self.batch_specs is not None
                 else ("dp",) * len(batch))
        if len(specs) != len(batch):
            raise ValueError(f"batch has {len(batch)} leaves but "
                             f"batch_specs has {len(specs)}")
        self._row_split = tuple(s == "dp" for s in specs)
        per = rows // self.dp
        lo = self.rank * per
        out = []
        for b, split in zip(batch, self._row_split):
            b = b[lo:lo + per] if split else b
            if self._param_dtype is not None and b.is_floating_point():
                b = b.to(self._param_dtype)
            out.append(b)
        return tuple(out), rows

    def _run(self, params, opt_state, local, lr, t):
        """One step on this rank's rows: (loss, params, state, health)."""
        scale = None
        scaled = self._param_dtype is not None
        if scaled:
            scaler = opt_state[_SCALER_KEY]
            scale = scaler["scale"]
        loss, grads = _accumulated_grads(self, params, local, scale)
        loss = ordered_psum(loss.float().reshape(1), self.group)[0] * (
            1.0 / self.dp)
        finite = None
        if scaled:
            finite = _grad_nonfinite(self, grads) == 0.0
        if not self._sharded:
            update_fn = _replicated_update
        elif self._overlap:
            update_fn = _overlapped_update
        elif self._bucketed:
            update_fn = _bucketed_update
        else:
            update_fn = _sharded_update
        new_p, new_s, aux = update_fn(self, params, grads, opt_state,
                                      float(lr), int(t), scale=scale)
        extras = None
        if scaled:
            # a non-finite step keeps the old parameters and state
            new_p = {k: torch.where(finite, v, params[k])
                     for k, v in new_p.items()}
            new_s = {k: {slot: torch.where(finite, v, opt_state[k][slot])
                         for slot, v in acc.items()}
                     for k, acc in new_s.items()}
            new_s[_SCALER_KEY] = _scaler_next(self, scaler, finite)
            extras = (new_s[_SCALER_KEY]["scale"],
                      1.0 - finite.float())
        health = None
        if self._telemetry is not None:
            health = self._trmod.pack_health(self, loss, params, new_p, aux,
                                             extras=extras)
        return loss, new_p, new_s, health

    @torch.no_grad()
    def __call__(self, params, opt_state, batch, lr, t):
        """One step. `batch` is a tuple of GLOBAL tensors (rows split over
        the ranks per batch_specs), `lr` a float, `t` the 1-based step
        count. The loss comes back as a device tensor; with telemetry on,
        as the host float the one drain read (and the call may raise
        `TrainingDiverged`)."""
        tele = self._telemetry
        if tele is None:
            local, _ = self._local_rows(tuple(batch))
            loss, new_p, new_s, _ = self._run(params, opt_state, local, lr, t)
            return loss, new_p, new_s
        t_in = tele.clock()
        local, rows = self._local_rows(tuple(batch))
        t0 = tele.clock()
        loss, new_p, new_s, health = self._run(params, opt_state, local, lr,
                                               t)
        t1 = tele.clock()
        tokens = (tele.tokens_per_step if tele.tokens_per_step is not None
                  else int(rows))
        host_loss = tele.record_step(
            health, step=int(t), tokens=tokens,
            batch_build_s=t0 - t_in, dispatch_s=t1 - t0)
        return host_loss, new_p, new_s

    # -------------------------------------------------------- probes
    @staticmethod
    def bytes_per_chip(tree) -> int:
        """Bytes this rank holds of a (nested dict) tree of tensors — the
        1/dp measurement for the optimizer-state claim."""
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        if isinstance(tree, dict):
            return sum(ZeroTrainStep.bytes_per_chip(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(ZeroTrainStep.bytes_per_chip(v) for v in tree)
        return 0

    def optimizer_state_bytes_per_chip(self, opt_state) -> int:
        return self.bytes_per_chip(opt_state)

    def _dev(self) -> torch.device:
        return self.device if self.device is not None else self.group.device

    def collective_seconds(self, samples: int = 3, rows: int = 1,
                           width: int = 1024) -> List[float]:
        """Host-clock seconds of one fixed-order all-reduce
        (`ordered_psum`) of a (rows, width) fp32 buffer, per sample (the
        card synchronized around each), after one warm-up; published as
        `parallel_dp_collective_seconds`."""
        from ..observability import global_registry

        dev = self._dev()
        x = torch.zeros((rows, width), dtype=torch.float32, device=dev)
        ordered_psum(x, self.group)
        out = _timed(lambda: ordered_psum(x, self.group), dev,
                     max(int(samples), 1))
        hist = global_registry().histogram(
            "parallel_dp_collective_seconds",
            "fixed-order dp all-reduce probe (ZeroTrainStep)")
        for s in out:
            hist.observe(s)
        return out

    def shard_step_seconds(self, samples: int = 3, rows: int = 128,
                           width: int = 128,
                           best_of: int = 3) -> Dict[str, float]:
        """The straggler probe: a warmed best-of-N matmul micro-step on
        each rank's device (CUDA events on a card, the host clock else),
        gathered so every rank returns every rank's best; published as
        `training_shard_step_seconds{shard=}`."""
        from ..observability import training as trmod

        dev = self._dev()
        x = torch.ones((rows, width), dtype=torch.float32, device=dev)

        def once():
            return (x @ x.T).sum()

        def trial():
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                once()
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / 1e3
            t0 = time.perf_counter()
            once()
            return time.perf_counter() - t0

        once()
        once()
        best = [trmod.probe_best_of([trial() for _ in
                                     range(max(int(best_of), 1))])
                for _ in range(max(int(samples), 1))]
        mine = torch.tensor([trmod.probe_best_of(best)] + best,
                            dtype=torch.float64)
        every = self._all_gather(mine)
        out: Dict[str, float] = {}
        for shard, row in enumerate(every):
            vals = [float(v) for v in row.tolist()]
            if self._telemetry is not None:
                for s in vals[1:]:
                    self._telemetry.observe_shard_step(str(shard), s)
            else:
                from ..observability import global_registry

                hist = global_registry().histogram(
                    "training_shard_step_seconds",
                    "warmed best-of-N per-dp-shard step-time probe",
                    labels={"shard": str(shard)})
                for s in vals[1:]:
                    hist.observe(s)
            out[str(shard)] = vals[0]
        return out

    def comm_seconds(self, samples: int = 3, elems: int = 65536,
                     best_of: int = 3) -> Dict[str, float]:
        """Warmed best-of-N host-clock seconds of the two ZeRO wire
        operations at this dp: the fixed-order reduce-scatter of a
        (dp * elems,) fp32 flat and the all-gather of an (elems,) slice;
        published as `training_comm_seconds{collective=}`."""
        from ..observability import training as trmod

        dev = self._dev()
        x = torch.zeros((self.dp * elems,), dtype=torch.float32, device=dev)
        s = torch.zeros((elems,), dtype=torch.float32, device=dev)
        ops = (("reduce_scatter",
                lambda: ordered_psum_scatter(x, self.group)),
               ("all_gather", lambda: self._all_gather(s)))
        out: Dict[str, float] = {}
        for name, fn in ops:
            fn()
            fn()
            best = [trmod.probe_best_of(_timed(fn, dev,
                                               max(int(best_of), 1)))
                    for _ in range(max(int(samples), 1))]
            if self._telemetry is not None:
                for sec in best:
                    self._telemetry.observe_comm(name, sec)
            else:
                from ..observability import global_registry

                hist = global_registry().histogram(
                    "training_comm_seconds",
                    "warmed best-of-N ZeRO collective probe "
                    "(reduce-scatter / all-gather wall seconds)",
                    labels={"collective": name})
                for sec in best:
                    hist.observe(sec)
            out[name] = trmod.probe_best_of(best)
        return out

    def measure_overlap_fraction(self, samples: int = 3,
                                 best_of: int = 3) -> float:
        """The fraction of the bucket collectives' wall that the pipeline
        hides behind update arithmetic, over the recorded bucket layout:
        (a) the collectives alone, (b) transport -> reduce -> update ->
        gather one bucket at a time, (c) the `ring_pipeline` schedule of
        the overlapped step; fraction = clip((b - c) / a, 0, 1), each a
        warmed best-of-N host-clock time. An Adam-shaped elementwise
        stand-in plays the update (the probe times schedules, not the
        optimizer). Stored, and pushed into telemetry when bound."""
        from ..observability import training as trmod

        if not self._buckets:
            raise RuntimeError(
                "no bucket layout — call init_state() first on a "
                "bucketed/overlap engine (stage >= 1, dp > 1 with "
                "bucket_bytes or overlap set)")
        dev = self._dev()
        dtype = (self._param_dtype if self._param_dtype is not None
                 else torch.float32)
        flats = [torch.ones((self.dp * b["width"],), dtype=dtype,
                            device=dev) for b in self._buckets]

        def surrogate(shard):
            m = shard * 0.9 + shard * 0.1
            v = shard * shard
            return shard - 0.01 * m / (torch.sqrt(v) + 1e-8)

        def coll():
            for flat in flats:
                red = start_ordered_psum_scatter(flat, self.group).wait()
                start_all_gather(red, self.group).wait()

        def serial():
            for flat in flats:
                red = start_ordered_psum_scatter(flat, self.group).wait()
                upd = surrogate(red.float()).to(dtype)
                start_all_gather(upd, self.group).wait()

        def overlapped():
            gathers = []

            def consume(j, red):
                upd = surrogate(red.float()).to(dtype)
                gathers.append(start_all_gather(upd, self.group))

            ring_pipeline(flats,
                          lambda f: start_ordered_psum_scatter(f,
                                                               self.group),
                          lambda h: h.wait(), consume)
            for g in gathers:
                g.wait()

        trials = max(int(samples) * max(int(best_of), 1), 1)
        times = []
        for fn in (coll, serial, overlapped):
            fn()
            fn()
            times.append(trmod.probe_best_of(_timed(fn, dev, trials)))
        t_coll, t_serial, t_overlap = times
        frac = 0.0
        if t_coll > 0.0:
            frac = float(min(max((t_serial - t_overlap) / t_coll, 0.0),
                             1.0))
        self._overlap_fraction = frac
        if self._telemetry is not None:
            self._telemetry.set_overlap_fraction(frac)
        return frac

    def describe(self) -> Dict[str, object]:
        return {
            "dp": self.dp,
            "tp": self.tp,
            "stage": self.stage,
            "grad_accum": self.grad_accum,
            "devices": list(range(self.dp)),
            "backend": self.group.backend,
            "params": len(self._shapes),
            "chunk_elems": sum(self._chunks.values()),
            "param_dtype": ("bf16" if self._param_dtype is not None
                            else "fp32"),
            "bucket_bytes": self.bucket_bytes,
            "overlap": self.overlap,
            "buckets": len(self._buckets),
            "overlap_fraction": self._overlap_fraction,
            "staged_bytes": self.group.staged_bytes,
            "telemetry": (self._telemetry.summary()
                          if self._telemetry is not None else None),
        }


def zero_train_step(model, optimizer, loss_fn=None, *, stage: int = 1,
                    **kwargs) -> ZeroTrainStep:
    """The function form of `ZeroTrainStep`: `step = zero_train_step(model,
    opt, stage=1); params, st = step.init_state(); loss, params, st =
    step(params, st, (x, y), lr, t)`."""
    return ZeroTrainStep(model, optimizer, loss_fn, stage=stage, **kwargs)


def save_optimizer_state(step: ZeroTrainStep, opt_state):
    """Module-level form of the degree-blind save."""
    return step.save_optimizer_state(opt_state)


def load_optimizer_state(step: ZeroTrainStep, host_state):
    return step.load_optimizer_state(host_state)


# ------------------------------------------- the GroupSharded surface
def _sharding_group(group, hcg):
    from ..distributed.group import _default

    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return hcg.get_sharding_parallel_group()
    return group if group is not None else _default()


def _host_slots(state, offload: bool):
    """The optimizer slots moved to host memory (pinned when a card is
    there) under offload, else as they are."""
    if not offload:
        return state
    pin = torch.cuda.is_available()
    return {k: {s: (v.detach().to("cpu").pin_memory() if pin
                    else v.detach().to("cpu"))
                for s, v in acc.items()} for k, acc in state.items()}


class _Gather(torch.autograd.Function):
    """A stage-3 parameter's full value from every rank's (chunk,) slice;
    the gradient reduce-scattered back in rank order."""

    @staticmethod
    def forward(ctx, piece, group, size, shape):
        ctx.group = group
        return _gathered(piece, group, size, shape)

    @staticmethod
    def backward(ctx, g):
        n = ctx.group.nranks
        flat = _pad_flat(g.contiguous(), n * ((g.numel() + n - 1) // n))
        return ordered_psum_scatter(flat, ctx.group), None, None, None


def _gathered(piece, group, size, shape):
    from ..distributed.communication import all_gather

    return torch.cat(all_gather(None, piece.detach(), group))[:size].reshape(
        shape)


class _ShardedBase(torch.nn.Module):
    """The wrapped model over the sharding group (the topology's sharding
    group, else `group`, else the world)."""

    stage = None
    _shard_params = False

    def __init__(self, layer, optimizer=None, group=None,
                 sync_buffers: bool = False, device: str = "gpu",
                 segment_size: int = 2 ** 20, offload: bool = False,
                 hcg=None, **kwargs):
        super().__init__()
        self._layers = layer
        self._optimizer = optimizer
        self.offload = offload
        self.group = _sharding_group(group, hcg)
        self._full: Dict[str, Tuple[Tuple[int, ...], int]] = {}
        if self._shard_params:
            self._shard()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def zero_train_step(self, loss_fn=None, criterion=None,
                        **kwargs) -> ZeroTrainStep:
        """The functional ZeRO step for this wrapper's model and optimizer
        at dp = the sharding group's size (stages 1 / 2 only: stage 3 is
        this wrapper's own eager step)."""
        if self.stage >= 3:
            raise NotImplementedError(
                "stage 3 (p_g_os) shards the parameters themselves: train "
                "it through the wrapper (loss.backward(), opt.step()); the "
                "functional ZeroTrainStep covers stages 1/2")
        return ZeroTrainStep(self._layers, self._optimizer, loss_fn,
                             criterion=criterion, group=self.group,
                             stage=self.stage, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        out = self._layers.load_state_dict(sd, *a, **k)
        if self._shard_params:
            self._shard()
        return out

    def get_all_parameters(self, convert2cpu: bool = False):
        """The full parameters (stage 3: gathered from every rank's slices,
        a collective); the model's own for stages 1 / 2."""
        if not self._shard_params:
            return list(self._layers.parameters())
        out = []
        for name, p in self._layers.named_parameters():
            shape, size = self._full[name]
            full = _gathered(p, self.group, size, shape)
            out.append(full.cpu() if convert2cpu else full)
        return out


class GroupShardedStage2(_ShardedBase):
    stage = 2
    _shard_params = False


class GroupShardedStage3(_ShardedBase):
    """Each parameter held as this rank's flat (chunk,) slice; the forward
    runs the model on gathered parameters (`torch.func.functional_call`)."""

    stage = 3
    _shard_params = True

    @torch.no_grad()
    def _shard(self):
        n, i = self.group.nranks, self.group.rank
        for mod in self._layers.modules():
            for name, p in list(mod._parameters.items()):
                if p is None or getattr(p, "_zero3", False):
                    continue
                chunk = max((p.numel() + n - 1) // n, 1)
                piece = torch.nn.Parameter(
                    _pad_flat(p.detach(), n * chunk)[i * chunk:(i + 1) * chunk]
                    .clone(), requires_grad=p.requires_grad)
                piece._zero3 = True
                piece._full = (tuple(p.shape), p.numel())
                mod._parameters[name] = piece
        self._full = {name: p._full
                      for name, p in self._layers.named_parameters()}

    def forward(self, *inputs, **kwargs):
        from torch.func import functional_call

        group = self.group
        full = {}
        for name, p in self._layers.named_parameters():
            shape, size = self._full[name]
            full[name] = _Gather.apply(p, group, size, shape)
        if not torch.is_grad_enabled():
            return functional_call(self._layers, full, inputs, kwargs)
        # the backward keeps a token for a gathered parameter (or a view
        # of it) and gathers it again when it needs the values
        storages = {t.untyped_storage().data_ptr(): name
                    for name, t in full.items()}
        pieces = dict(self._layers.named_parameters())

        def pack(t):
            name = storages.get(t.untyped_storage().data_ptr())
            if name is None:
                return t
            return (name, t.size(), t.stride(), t.storage_offset())

        def unpack(saved):
            if isinstance(saved, torch.Tensor):
                return saved
            name, size, stride, offset = saved
            shape, n = self._full[name]
            base = _gathered(pieces[name], group, n, shape)
            return base.as_strided(size, stride, offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return functional_call(self._layers, full, inputs, kwargs)


class GroupShardedOptimizerStage2:
    """The optimizer side: `step()` runs the sharded update of the
    wrapper's stage over the sharding group, through this module's
    update functions (stage 1 / 2: `_sharded_update` on the full
    parameters and their local gradients; stage 3: the optimizer's rule on
    the slices, whose gradients arrive reduce-scattered)."""

    def __init__(self, params, optim, group=None, offload: bool = False,
                 device: str = "gpu", stage: int = 2, **kwargs):
        from ..distributed.group import _default

        self._optim = optim
        self._params = list(params)
        self.offload = offload
        self.group = group if group is not None else _default()
        self.stage = int(stage)
        self._names = [str(i) for i in range(len(self._params))]
        self._engine = None
        self._state = None

    def __getattr__(self, name):
        return getattr(self._optim, name)

    def _build(self):
        live = {k: p.detach() for k, p in zip(self._names, self._params)}
        if self.stage >= 3:
            self._state = self._optim.functional_state(live)
        else:
            self._engine = ZeroTrainStep(None, self._optim, lambda *a: None,
                                         stage=self.stage, group=self.group)
            _, self._state = self._engine.init_state(live)
        self._state = _host_slots(self._state, self.offload)

    @torch.no_grad()
    def step(self):
        if self._state is None:
            self._build()
        opt = self._optim
        opt._step_count += 1
        lr, t = float(opt.get_lr()), opt._step_count
        params = {k: p.detach() for k, p in zip(self._names, self._params)}
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in zip(self._names, self._params)}
        dev = self._params[0].device
        state = ({k: {s: v.to(dev, non_blocking=True) for s, v in
                      acc.items()} for k, acc in self._state.items()}
                 if self.offload else self._state)
        if self.stage >= 3:
            inv = 1.0 / self.group.nranks
            new_p, new_s = opt.functional_step(
                params, {k: g * inv for k, g in grads.items()}, state, lr, t)
        else:
            new_p, new_s, _ = _sharded_update(self._engine, params, grads,
                                              state, lr, t)
        for k, p in zip(self._names, self._params):
            p.copy_(new_p[k])
        if self.offload:
            for k, acc in new_s.items():
                for s, v in acc.items():
                    self._state[k][s].copy_(v)
        else:
            self._state = new_s

    def clear_grad(self, set_to_zero: bool = True):
        for p in self._params:
            if p.grad is not None:
                if set_to_zero:
                    p.grad.zero_()
                else:
                    p.grad = None

    def minimize(self, loss, *a, **k):
        loss.backward()
        self.step()

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (device or host)."""
        if self._state is None:
            return 0
        return ZeroTrainStep.bytes_per_chip(self._state)


def group_sharded_parallel(model, optimizer, level: str = "p_g_os",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False, buffer_max_size=2 ** 23,
                           segment_size=2 ** 20, sync_comm: bool = False,
                           dp_group=None, exclude_layer=None):
    """paddle.distributed.sharding.group_sharded_parallel: level 'os'
    (stage 1), 'os_g' (stage 2) or 'p_g_os' (stage 3). Returns (model,
    optimizer[, scaler]); every rank of the sharding group calls it."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(
            f"group_sharded_parallel level must be 'os' (ZeRO-1), 'os_g' "
            f"(ZeRO-2) or 'p_g_os' (ZeRO-3); got {level!r}")
    if level == "p_g_os":
        wrapped = GroupShardedStage3(model, optimizer=optimizer, group=group,
                                     offload=offload)
    else:
        wrapped = GroupShardedStage2(model, optimizer=optimizer, group=group,
                                     offload=offload)
        wrapped.stage = 1 if level == "os" else 2
    opt = GroupShardedOptimizerStage2(list(wrapped.parameters()), optimizer,
                                      group=wrapped.group, offload=offload,
                                      stage=wrapped.stage)
    if scaler is not None:
        return wrapped, opt, scaler
    return wrapped, opt


def save_group_sharded_model(model, output, optimizer=None):
    """The full parameters (gathered: every rank calls it) saved by rank 0
    of the group to `output + ".pdparams"`, and the optimizer's state dict
    to `output + ".pdopt"`."""
    names = [n for n, _ in model.named_parameters()]
    full = (model.get_all_parameters(convert2cpu=True)
            if hasattr(model, "get_all_parameters")
            else [p.detach().cpu() for p in model.parameters()])
    group = getattr(model, "group", None)
    if group is None or group.rank == 0:
        torch.save(dict(zip(names, full)), str(output) + ".pdparams")
        if optimizer is not None:
            inner = getattr(optimizer, "_optim", optimizer)
            torch.save(inner.state_dict(), str(output) + ".pdopt")
