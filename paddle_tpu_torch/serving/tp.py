"""Tensor-parallel serving: Megatron-sharded LLaMA and GPT over a group of
devices, driven in lockstep by one host thread (port of
paddle_tpu/serving/tp.py).

- **Weights** (Megatron-LM): the QKV, gate / up and GPT's ffn_in
  projections are column-parallel (each shard owns whole heads, a slice
  of the output dim), the O, down and GPT's ffn_out projections are
  row-parallel (a slice of the input dim, so each shard's product is a
  partial sum). The port's Linear weights are (out, in), the transpose of
  the reference's (in, out): column-parallel weights shard dim 0 here and
  row-parallel ones dim 1. GPT's fused `qkv` output dim, laid out (3,
  heads, hd), is interleaved to (tp, 3, heads/tp, hd) first, so that a
  contiguous slice is one shard's own [q | k | v] (`interleave_qkv`). The
  bias of a row-parallel Linear is added once, after the reduction.
- **Execution**: the reference runs one SPMD program over a `shard_map`
  sub-mesh; the port has no counterpart, and its `distributed` process
  groups (one process a rank) do not fit an engine a caller builds,
  snapshots, restores onto another degree and hands to a cluster. So one
  host thread drives every shard: each decoder layer runs its attention
  half on every shard's device, one fixed-order all-reduce follows
  (`parallel.mesh.ordered_allreduce`, or the int8 `quant.
  quantized_allreduce`), then the MLP half and a second all-reduce, two a
  layer as in the reference. The residual stream, the norms and the
  reduced values are replicated on every distinct device of the group
  and hold the same bits there. The embedding, the final norm, the LM
  head and sampling run once, on the engine's device (the model's; the
  reference runs them on every shard over logits that are already
  replicated, so the tokens and key state are the same). The runners
  (`LlamaTPRunner`, `GPTTPRunner`) have the model's call signature and
  take the sharded cache's views, one per-layer view list a shard, so the
  engine's dispatch code changes only in which model and which views it
  passes.
- **Shards**: each shard holds a skeleton of the model's decoder stack
  (the port's own `LlamaDecoderLayer` / `GPTBlock`, built on the meta
  device, head counts divided by tp) whose projections are bound to that
  shard's weight slices, copied onto its device; the skeleton's own
  weights are never materialised. Norms and the row-parallel biases are
  shared replicas, one a device.
- **Devices**: `devices=None` takes the first tp cards when the model is
  on CUDA (and raises when there are fewer) and tp CPU shards when it is
  on the CPU. An explicit list is sorted by (type, index) and may name one
  card more than once: one H100 then holds every shard, and nothing moves
  between devices.
- **KV pools** are sharded by kv head (`PagedKVCache.shard_pools`); page
  tables, the allocator, the prefix cache and the scheduler stay single.

Nothing in this module is imported unless `ServingEngine(tp_size>1)`.
The reference's jit keys and compile counts have no counterpart in an
eager port.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..ops.rope import rope_tables
from ..parallel.mesh import device_order, distinct, ordered_allreduce

__all__ = ["TPContext", "validate_tp_config", "tp_device_order",
           "interleave_qkv", "LlamaTPRunner", "GPTTPRunner",
           "SerialReduce"]


def tp_device_order(devices=None) -> List[torch.device]:
    """The canonical order of a tensor-parallel group
    (`parallel.mesh.device_order`): sorted by (type, index)."""
    return device_order(devices)


def validate_tp_config(cfg, tp_size: int) -> None:
    """Divisibility contract of Megatron sharding for this config:
    `kv_heads % tp == 0` is the GQA rule (a KV head's pool slab lives on
    exactly one shard with every query head of its group)."""
    heads = cfg.num_attention_heads
    kv = getattr(cfg, "num_key_value_heads", heads)
    inter = cfg.intermediate_size
    if tp_size < 2:
        raise ValueError(f"tp_size must be >= 2 for a TPContext "
                         f"(got {tp_size}); tp_size=1 is the plain engine")
    if heads % tp_size:
        raise ValueError(f"num_attention_heads ({heads}) must be divisible "
                         f"by tp_size ({tp_size})")
    if kv % tp_size:
        raise ValueError(
            f"num_key_value_heads ({kv}) must be divisible by tp_size "
            f"({tp_size}): each TP shard owns whole KV heads (GQA groups "
            "never straddle shards)")
    if inter % tp_size:
        raise ValueError(f"intermediate_size ({inter}) must be divisible by "
                         f"tp_size ({tp_size})")


def interleave_qkv(t: torch.Tensor, heads: int, tp: int) -> torch.Tensor:
    """GPT's fused-QKV weight (3h, in) or bias (3h,), output dim laid out
    (3, heads, hd), reordered to (tp, 3, heads/tp, hd): a contiguous
    1/tp of the result is one shard's own (3, heads/tp, hd) block."""
    rest = t.shape[1:]
    x = t.reshape(3, tp, heads // tp, -1, *rest)
    return x.transpose(0, 1).reshape(t.shape)


def _slice(t: torch.Tensor, dim: int, i: int, tp: int,
           dev: torch.device) -> torch.Tensor:
    """Shard i's 1/tp of `t` along `dim`, as its own contiguous tensor on
    `dev`."""
    n = t.shape[dim] // tp
    part = t.detach().narrow(dim, i * n, n)
    return torch.empty(part.shape, dtype=t.dtype, device=dev).copy_(part)


def _bind(linear: nn.Linear, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> None:
    linear.weight = nn.Parameter(weight, requires_grad=False)
    linear.out_features, linear.in_features = weight.shape
    linear.bias = (None if bias is None
                   else nn.Parameter(bias, requires_grad=False))


def _replica(module: nn.Module, dev: torch.device) -> nn.Module:
    """`module` itself when its weights live on `dev`, else a copy there."""
    if next(module.parameters()).device == dev:
        return module
    return copy.deepcopy(module).to(dev)


def _on(dev: torch.device):
    """Make `dev` the current CUDA device (the hand-written kernels launch
    on the current device); nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _to(x, dev: torch.device):
    """A step input on `dev`: host ints stay ints, tensors are copied."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=True)
    return x


def synchronize(devices: Sequence[torch.device]) -> None:
    for dev in distinct(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class SerialReduce:
    """The serial reduction step of a TP layer: all-reduce the shards'
    partials (fixed shard order, or the block-scaled int8 form), add the
    replicated bias after the reduction, add the result to the residual
    stream and apply the next norm, on each device that needs it. The
    overlapped engine (serving/overlap.py) swaps in a chunked pipeline
    with the same arithmetic."""

    def __init__(self, shard_devices: Sequence[torch.device],
                 quantized: bool, lead: Optional[torch.device] = None):
        self.shard_devices = tuple(shard_devices)
        self.quantized = bool(quantized)
        # the group's cards and the engine's (`lead`): several of them
        # mean a device switch around every hand-written kernel
        self._multi = len(distinct(self.shard_devices
                                   + ((lead,) if lead else ()))) > 1
        # allreduce(partials, targets) -> {device: the reduced value}
        if self.quantized:
            from .quant import quantized_allreduce

            self.allreduce = quantized_allreduce
        else:
            self.allreduce = ordered_allreduce

    def _on(self, dev):
        """`_on(dev)` when the work spans several devices; on one device
        the runner has entered it already."""
        return _on(dev) if self._multi else contextlib.nullcontext()

    def add_norm(self, partials, bias, resid, norms):
        """partials: one (b, s, h) partial a shard; bias: device -> bias
        or None; resid: device -> residual stream; norms: device -> the
        norm to apply next, whose keys are the devices to produce.
        Returns (residual, normed), dicts over the keys of `norms`:
        resid + (reduced + bias) and its norm."""
        red = self.allreduce(partials, list(norms))
        xs, ns = {}, {}
        for dev, norm in norms.items():
            y = red[dev] if bias is None else red[dev] + bias[dev]
            xs[dev] = _resident(resid, dev) + y
            with self._on(dev):
                ns[dev] = norm(xs[dev])
        return xs, ns


def _resident(resid, dev):
    """The residual stream on `dev`: its own copy, or a copy of another
    device's (the engine's device when it is outside the group)."""
    if dev in resid:
        return resid[dev]
    return next(iter(resid.values())).to(dev, non_blocking=True)


class _TPRunner:
    """What both families share: the shard devices, the reduction step,
    the per-device step inputs and the lockstep loop over shards."""

    def __init__(self, ctx: "TPContext", reduce):
        self.reduce = reduce
        self.shard_devices = ctx.devices
        self.devs = distinct(ctx.devices)
        self.lead = ctx.lead
        # one device for the group and the engine: enter it once a forward
        every = distinct(self.devs + [self.lead])
        self._single = every[0] if len(every) == 1 else None

    def _shard_on(self, dev):
        return contextlib.nullcontext() if self._single else _on(dev)

    def _check(self, caches):
        if caches is None or len(caches) != len(self.shard_devices):
            raise ValueError(
                f"a tensor-parallel forward takes one per-layer view list a "
                f"shard ({len(self.shard_devices)}), from the sharded "
                "cache's layer_views")

    def __call__(self, *args, **kw):
        if self._single is None:
            return self._forward(*args, **kw)
        with _on(self._single):
            return self._forward(*args, **kw)


class LlamaTPRunner(_TPRunner):
    """LLaMA's cache forward over tensor-parallel shards:
    `runner(input_ids, caches=views, start_pos=...)`, `views` holding one
    per-layer view list a shard, returns (logits, caches), like
    `LlamaForCausalLM`."""

    def __init__(self, ctx: "TPContext", model, reduce):
        super().__init__(ctx, reduce)
        from ..models.llama import LlamaDecoderLayer

        self.model = model
        cfg = model.llama.config
        self.cfg = cfg
        tp = ctx.tp_size
        dtype = model.lm_head.weight.dtype
        norms = {dev: [(_replica(layer.input_layernorm, dev),
                        _replica(layer.post_attention_layernorm, dev))
                       for layer in model.llama.layers]
                 for dev in self.devs}
        self.final_norm = model.llama.norm
        shards = []
        for i, dev in enumerate(self.shard_devices):
            stack = nn.ModuleList()
            for layer, (ln_in, ln_post) in zip(model.llama.layers,
                                               norms[dev]):
                sk = LlamaDecoderLayer(cfg, device="meta", dtype=dtype)
                att, full = sk.self_attn, layer.self_attn
                att.num_heads //= tp
                att.num_kv_heads //= tp
                for name in ("q_proj", "k_proj", "v_proj"):
                    _bind(getattr(att, name), _slice(
                        getattr(full, name).weight, 0, i, tp, dev))
                _bind(att.o_proj, _slice(full.o_proj.weight, 1, i, tp, dev))
                for name in ("gate_proj", "up_proj"):
                    _bind(getattr(sk.mlp, name), _slice(
                        getattr(layer.mlp, name).weight, 0, i, tp, dev))
                _bind(sk.mlp.down_proj,
                      _slice(layer.mlp.down_proj.weight, 1, i, tp, dev))
                sk.input_layernorm, sk.post_attention_layernorm = (ln_in,
                                                                   ln_post)
                stack.append(sk)
            shards.append(stack.eval())
        self.shards = nn.ModuleList(shards)
        self._first = {dev: self.shard_devices.index(dev)
                       for dev in self.devs}

    def _norms(self, layer: int, which: str):
        return {dev: getattr(self.shards[i][layer], which)
                for dev, i in self._first.items()}

    def _forward(self, input_ids, caches=None, start_pos=0):
        self._check(caches)
        model, cfg = self.model, self.cfg
        s = input_ids.shape[1]
        x = F.embedding(input_ids, model.llama.embed_tokens.weight)
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        sp = {dev: _to(start_pos, dev) for dev in self.devs}
        rope = {dev: rope_tables(s, head_dim, cfg.rope_theta, sp[dev], dev)
                for dev in self.devs}
        resid = {dev: x.to(dev, non_blocking=True) for dev in self.devs}
        normed = {}
        for dev, norm in self._norms(0, "input_layernorm").items():
            with _on(dev):
                normed[dev] = norm(resid[dev])
        n_layers = len(model.llama.layers)
        for li in range(n_layers):
            parts = []
            for i, dev in enumerate(self.shard_devices):
                with self._shard_on(dev):
                    a, _ = self.shards[i][li].self_attn(
                        normed[dev], caches[i][li], sp[dev], rope[dev])
                parts.append(a)
            resid, normed = self.reduce.add_norm(
                parts, None, resid,
                self._norms(li, "post_attention_layernorm"))
            parts = []
            for i, dev in enumerate(self.shard_devices):
                with self._shard_on(dev):
                    parts.append(self.shards[i][li].mlp(normed[dev]))
            nxt = (self._norms(li + 1, "input_layernorm")
                   if li + 1 < n_layers else {self.lead: self.final_norm})
            resid, normed = self.reduce.add_norm(parts, None, resid, nxt)
        return model.lm_head(normed[self.lead]), caches


class GPTTPRunner(_TPRunner):
    """GPT's cache forward over tensor-parallel shards:
    `runner(input_ids, caches=views, start_pos=...)`, `views` holding one
    per-layer view list a shard, returns (logits, caches), like
    `GPTForCausalLM`."""

    def __init__(self, ctx: "TPContext", model, reduce):
        super().__init__(ctx, reduce)
        from ..models.gpt import GPTBlock

        self.model = model
        gpt = model.gpt
        cfg = gpt.config
        tp = ctx.tp_size
        heads = cfg.num_attention_heads
        dtype = gpt.wte.weight.dtype
        norms = {dev: [(_replica(blk.ln1, dev), _replica(blk.ln2, dev))
                       for blk in gpt.blocks] for dev in self.devs}
        # the row-parallel Linears' biases, replicated and added once,
        # after the reduction
        self.out_bias = [{dev: blk.attn.out.bias.detach().to(dev)
                          for dev in self.devs} for blk in gpt.blocks]
        self.ffn_bias = [{dev: blk.ffn_out.bias.detach().to(dev)
                          for dev in self.devs} for blk in gpt.blocks]
        qkv = [(interleave_qkv(blk.attn.qkv.weight.detach(), heads, tp),
                interleave_qkv(blk.attn.qkv.bias.detach(), heads, tp))
               for blk in gpt.blocks]
        shards = []
        for i, dev in enumerate(self.shard_devices):
            stack = nn.ModuleList()
            for blk, (w, b), (ln1, ln2) in zip(gpt.blocks, qkv, norms[dev]):
                sk = GPTBlock(cfg, device="meta", dtype=dtype)
                sk.attn.num_heads //= tp
                _bind(sk.attn.qkv, _slice(w, 0, i, tp, dev),
                      _slice(b, 0, i, tp, dev))
                _bind(sk.attn.out, _slice(blk.attn.out.weight, 1, i, tp, dev))
                _bind(sk.ffn_in, _slice(blk.ffn_in.weight, 0, i, tp, dev),
                      _slice(blk.ffn_in.bias, 0, i, tp, dev))
                _bind(sk.ffn_out, _slice(blk.ffn_out.weight, 1, i, tp, dev))
                sk.ln1, sk.ln2 = ln1, ln2
                stack.append(sk)
            shards.append(stack.eval())
        del qkv
        self.shards = nn.ModuleList(shards)
        self._first = {dev: self.shard_devices.index(dev)
                       for dev in self.devs}

    def _norms(self, layer: int, which: str):
        return {dev: getattr(self.shards[i][layer], which)
                for dev, i in self._first.items()}

    def _forward(self, input_ids, position_ids=None, caches=None,
                 start_pos=0):
        self._check(caches)
        gpt = self.model.gpt
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = gpt._positions(s, caches, start_pos,
                                          input_ids.device)
        position_ids = position_ids.clamp(
            0, gpt.config.max_position_embeddings - 1)
        x = gpt.dropout(F.embedding(input_ids, gpt.wte.weight)
                        + F.embedding(position_ids, gpt.wpe.weight))
        sp = {dev: _to(start_pos, dev) for dev in self.devs}
        resid = {dev: x.to(dev, non_blocking=True) for dev in self.devs}
        normed = {}
        for dev, norm in self._norms(0, "ln1").items():
            with _on(dev):
                normed[dev] = norm(resid[dev])
        n_layers = len(gpt.blocks)
        for li in range(n_layers):
            parts = []
            for i, dev in enumerate(self.shard_devices):
                with self._shard_on(dev):
                    a, _ = self.shards[i][li].attn(normed[dev],
                                                   caches[i][li], sp[dev])
                parts.append(a)
            resid, normed = self.reduce.add_norm(
                parts, self.out_bias[li], resid, self._norms(li, "ln2"))
            parts = []
            for i, dev in enumerate(self.shard_devices):
                blk = self.shards[i][li]
                with self._shard_on(dev):
                    parts.append(blk.ffn_out(F.gelu(blk.ffn_in(normed[dev]))))
            nxt = (self._norms(li + 1, "ln1") if li + 1 < n_layers
                   else {self.lead: gpt.ln_f})
            resid, normed = self.reduce.add_norm(parts, self.ffn_bias[li],
                                                 resid, nxt)
        return F.matmul(normed[self.lead], gpt.wte.weight,
                        transpose_y=True), caches


class TPContext:
    """Everything `ServingEngine(tp_size=N)` needs: the shard devices, the
    sharded model (`runner`), the reduction it runs (serial, or the
    overlapped pipeline of serving/overlap.py), the collective probe and
    `describe()`. Built once an engine."""

    def __init__(self, model, tp_size: int, devices=None,
                 quantized_allreduce: bool = False, overlap: bool = False,
                 overlap_chunks: int = 2):
        from ..models.generation import _config_of

        self.tp_size = int(tp_size)
        self.quantized_allreduce = bool(quantized_allreduce)
        # one chunk IS the serial schedule: chunks=1 turns overlap off, so
        # the serial reduction runs and serving.overlap is never imported
        self.overlap_chunks = int(overlap_chunks)
        if self.overlap_chunks < 1:
            raise ValueError(
                f"overlap_chunks must be >= 1, got {overlap_chunks}")
        self.overlap = bool(overlap) and self.overlap_chunks > 1
        self.cfg = _config_of(model)
        validate_tp_config(self.cfg, self.tp_size)
        if hasattr(model, "llama"):
            self.family, runner_cls = "llama", LlamaTPRunner
        elif hasattr(model, "gpt"):
            self.family, runner_cls = "gpt", GPTTPRunner
        else:
            raise ValueError(
                "tensor-parallel serving defines Megatron sharding for the "
                f"LLaMA / GPT decoder families; got {type(model).__name__}")
        self.lead = next(model.parameters()).device
        self.devices = tuple(self._resolve(devices))
        if self.overlap:
            from .overlap import OverlapPlan

            reduce = OverlapPlan(self.devices, self.overlap_chunks,
                                 self.quantized_allreduce, self.lead)
        else:
            reduce = SerialReduce(self.devices, self.quantized_allreduce,
                                  self.lead)
        self.reduce = reduce
        self.runner = runner_cls(self, model, reduce)
        # the hidden share of the collective wall, measured once at
        # construction (serving/overlap.py); None on serial engines
        self.overlap_fraction: Optional[float] = None
        if self.overlap:
            from .overlap import measure_overlap_fraction

            self.overlap_fraction = measure_overlap_fraction(
                self.devices, self.cfg.hidden_size, self.overlap_chunks,
                self.quantized_allreduce,
                dtype=next(model.parameters()).dtype)

    def _resolve(self, devices) -> List[torch.device]:
        tp, lead = self.tp_size, self.lead
        if devices is None:
            if lead.type == "cuda":
                devs = [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
            else:
                devs = [torch.device("cpu")] * tp
        else:
            devs = []
            for d in devices:
                dev = resolve_device(d)
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                devs.append(dev)
        devs = tp_device_order(devs)
        if len(devs) < tp:
            raise ValueError(f"tp_size={tp} needs that many devices, got "
                             f"{len(devs)}")
        devs = devs[:tp]
        if any(d.type != lead.type for d in devs):
            raise ValueError(
                f"tensor-parallel devices {[str(d) for d in devs]} must be "
                f"of the model's device type ({lead.type})")
        return devs

    # -------------------------------------------------------- observability
    @staticmethod
    def probe_best_of(trials: Sequence[float]) -> float:
        """One probe sample from its timing trials: the minimum (the floor
        of repeated identical calls is the collective plus steady-state
        dispatch; the rest is host noise). Never grows as trials are
        added."""
        return min(trials)

    def collective_seconds(self, samples: int = 3, rows: int = 1,
                           best_of: int = 3) -> List[float]:
        """Measured wall seconds of one all-reduce on this group: the
        engine's reduction (fixed order, or block-scaled int8) of a (rows,
        hidden) fp32 partial a shard, the payload of one decode step's
        residual all-reduce (the model runs 2 x layers of them a step).
        Each sample is the best of `best_of` timed calls after two warm-up
        calls; every call ends in a synchronize of the group's cards, so
        the time includes one call's host overhead."""
        h = self.cfg.hidden_size
        parts = [torch.full((rows, h), 0.5, dtype=torch.float32, device=dev)
                 for dev in self.devices]
        targets = distinct(self.devices)

        def call():
            self.reduce.allreduce(parts, targets)
            synchronize(self.devices)

        call()
        call()
        out = []
        for _ in range(max(int(samples), 1)):
            trials = []
            for _ in range(max(int(best_of), 1)):
                t0 = time.perf_counter()
                call()
                trials.append(time.perf_counter() - t0)
            out.append(self.probe_best_of(trials))
        return out

    def describe(self) -> Dict[str, object]:
        """The deployment's shape for stats(): what is per shard and what
        is replicated."""
        cfg = self.cfg
        kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        return {
            "tp_size": self.tp_size,
            "quantized_allreduce": self.quantized_allreduce,
            "overlap": self.overlap,
            "overlap_chunks": self.overlap_chunks if self.overlap else 1,
            "overlap_fraction": self.overlap_fraction,
            "devices": [str(d) for d in self.devices],
            "kv_heads_per_shard": kv // self.tp_size,
            "heads_per_shard": cfg.num_attention_heads // self.tp_size,
            "replicated": ["page_tables", "allocator", "scheduler",
                           "sampling", "logits", "key_state"],
        }
