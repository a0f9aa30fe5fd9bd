"""ServingEngine: continuous-batching generation over a paged KV cache
(ported from paddle_tpu/serving/engine.py).

The engine multiplexes a request stream onto a decoder model that follows
the `forward(input_ids, caches=..., start_pos=...)` cache protocol
(models/llama.py), passing one `PagedLayerCache` view per layer:

- prefill: one request per step, its prompt padded up to the smallest
  prompt bucket, the first token sampled on the device;
- decode: a block of `decode_horizon` model steps per dispatch - model
  step, sampling, EOS/budget masking and position advance all on the
  device - returning a (b, horizon) token block. Rows that finish
  mid-block emit PAD and park their write position at the table-overflow
  slot (routed to the null page), so the host syncs once per block;
- host/device overlap: block k+1 is dispatched from block k's device-side
  carries BEFORE block k's tokens are pulled to the host. Each block's
  tokens start their copy to pinned host memory as soon as the block is
  enqueued, and the drain waits on that copy's event alone, so Python
  bookkeeping and scheduling run while the card computes;
- chunked prefill (`enable_chunked_prefill=True`): prompts run in
  page-aligned chunks of `prefill_chunk_tokens`, scheduled beside the
  running decoders under a per-step token budget. With the ragged step
  (`enable_ragged_step=True`, the default) a step that carries chunk work
  is ONE flat (1, T) forward over every row's tokens through the ragged
  attention kernel, then the decode body for horizon-1 iterations over
  the decode rows; without it, the decode block runs and each chunk is
  its own prefill call at its offset ("mixed" steps);
- quantized KV pools (`kv_dtype="int8"` / `"fp8"`): K/V quantized once at
  page-write time with per-slot fp32 scales (serving.quant);
- prefix caching (`enable_prefix_caching=True`, serving.prefix_cache):
  admission reuses the longest cached full-page prefix of a prompt, and
  the prefill runs only the suffix, at the cached offset, attending over
  the shared pages through the page table; every prefilled prompt's full
  pages enter the radix tree;
- speculative decoding (`spec_config=SpecConfig(...)`, serving.spec,
  imported only then): drafts proposed on the host from the request's own
  stream (n-gram) or the prefix cache's tree, verified in (b, 1 + L)
  windows on the device with rejection sampling. A speculative block
  drains before the next step is scheduled, so its worst-case page charge
  is reverted to what was accepted before the next block is charged.

PyTorch runs eagerly, so there are no compiled executables to bound; the
KV pools are CUDA tensors written in place (`serving.attention`).

Sampling (`serving.sampling`). Greedy (temperature 0) is exact argmax.
Otherwise a request's n-th sampled token uses Gumbel noise that is a
counter-based function of (request seed, n, vocab index) computed on the
device, so a stream depends neither on the decode horizon nor on the
batch it rode in, survives preemption, and is the same chunked or
unchunked: an intermediate chunk draws nothing and a final chunk samples
at the request's next draw index.
Under speculation the draw index still advances by exactly the tokens
emitted. The JAX engine's threefry bits are not reproduced.

Resilience (serving.resilience): a bounded waiting queue with queue-wait
shedding (`max_waiting`, `max_queue_wait_s`), per-request deadlines
(`add_request(deadline_s=)`), and a seeded `FaultInjector` whose sites
guard every dispatch and drain (`_guarded_call`): a transient fault is
retried once after `retry_backoff_s`, a persistent one quarantines exactly
the implicated requests (status "failed", error recorded, pages released),
a fatal one leaves the engine for the supervisor. An engine without an
injector, deadlines or a queue-wait bound runs none of it beyond `None`
checks.

Recovery (serving.recovery, imported only by the methods that need it):
`journal=` / `attach_journal` records every submitted request and every
token at the moment `step()` returns it, so `snapshot()` / `restore()`
re-admit each unfinished request as prompt + delivered tokens, resuming at
its draw index; `EngineSupervisor` drives that on fatal faults, a step
watchdog and fault storms.

Observability (paddle_tpu_torch.observability, .profiler): with metrics on,
`ServingObs` holds every registry handle plus a `LifecycleTracker` whose
per-request points and spans (`serving.request[<rid>].<stage>`) fold into
an armed profiler window; each dispatch and drain runs inside a
`RecordEvent` (`serving.prefill`, `serving.prefill_chunk`,
`serving.ragged_step`, `serving.decode_block`, `serving.spec_block`,
`serving.host_drain`). `slo_classes=` adds per-class TTFT / TPOT targets,
goodput and windowed attainment (`add_request(slo_class=)`);
`flight_recorder=` keeps a bounded ring of control-plane events
(schedule, dispatch, drain, fault, quarantine, preempt, terminal, adopt)
that `build_postmortem` / `dump_postmortem` bundle, and `postmortem_dir=`
dumps one on every quarantine. Tokens reach the host a step after their
block is dispatched, through a pinned copy and an event: first-token
points, TTFT and TPOT are stamped there, at the drain, never behind an
added device sync. Each layer is a `None` check when off.

Tensor parallelism (`tp_size>1`, serving.tp, imported only then): the
model's decoder stack is Megatron-sharded over `devices` (one card may
hold every shard) and the KV pools by kv head, one host thread driving
the shards in lockstep through a TP runner with the model's call
signature; the scheduler, allocator, page tables, prefix cache and
sampling stay single. `tp_quantized_allreduce=True` moves the layer
reductions as block-scaled int8 (serving.quant); `tp_overlap=True` with
`tp_overlap_chunks>1` pipelines them over row chunks (serving.overlap,
imported only then) with the serial engine's arithmetic. Snapshots carry
no device state, so a snapshot restores at any tp degree.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, same_device
from ..observability import Histogram, LifecycleTracker, MetricsRegistry
from ..observability.flight_recorder import (
    build_postmortem as _build_bundle, dump_postmortem as _dump_bundle)
from ..observability.slo import SloTracker
from ..profiler import RecordEvent
from .attention import advance_positions
from .kv_cache import (KV_DTYPES, PagedKVCache, host_to_device,
                       overflow_position, pages_for)
from .prefix_cache import PrefixCache
from .ragged import build_ragged_inputs, token_buckets
from .resilience import (TERMINAL_STATUSES, describe_fault, is_fatal,
                         is_transient)
from .sampling import PAD_TOKEN, sample_batch
from .scheduler import (Request, SamplingParams, Scheduler,
                        reserve_request_ids)

__all__ = ["ServingEngine", "ServingObs", "PAD_TOKEN"]



def _default_buckets(max_seq_len: int) -> Tuple[int, ...]:
    """Power-of-two prompt buckets up to max_seq_len (always included)."""
    buckets = []
    b = 16
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq_len)
    return tuple(buckets)


def _start_host_copy(t: torch.Tensor):
    """Begin copying `t` to the host without waiting: (host tensor, CUDA
    event to wait on, or None when `t` is already on the CPU)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def _pull(rec: dict) -> np.ndarray:
    """A block record's tokens on the host: wait for its copy's event,
    then read the pinned buffer."""
    if rec["event"] is not None:
        rec["event"].synchronize()
    return rec["host"].numpy()


class ServingObs:
    """Every observability handle the serving hot path touches, resolved
    ONCE against the engine's MetricsRegistry, plus the per-request
    LifecycleTracker. The scheduler receives this same object and calls
    the small hooks below at queue transitions. With
    `enable_metrics=False` the engine holds None instead and does no
    metrics work at all."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.lifecycle = LifecycleTracker()
        c, g, h = registry.counter, registry.gauge, registry.histogram
        self.prefill_steps = c("serving_prefill_steps_total",
                               "prefill dispatches")
        self.prefill_chunks = c("serving_prefill_chunks_total",
                                "chunked-prefill chunk dispatches")
        self.decode_steps = c("serving_decode_steps_total",
                              "decode-block dispatches")
        self.ragged_steps = c("serving_ragged_steps_total",
                              "flat ragged mixed-step dispatches (one flat "
                              "forward carrying the step's decode rows AND "
                              "prefill chunks)")
        self.tokens = c("serving_tokens_generated_total",
                        "tokens emitted to the host")
        self.host_syncs = c("serving_host_syncs_total",
                            "device->host sync points")
        self.dispatches = c("serving_dispatches_total",
                            "prefill and decode-block dispatches")
        self.preemptions = c("serving_preemptions_total",
                             "requests preempted and requeued")
        self.parked_total = c("serving_requests_parked_total",
                        "preemption-storm guard trips (victim requeued at "
                        "the back of the queue)")
        self.prefill_seconds = c("serving_prefill_seconds_total",
                                 "wall time in prefill dispatch+sync")
        self.decode_seconds = c(
            "serving_decode_seconds_total",
            "decode wall time (async-overlap deduplicated)")
        self.ttft = h("serving_ttft_seconds",
                      "request arrival to first token on the host")
        self.inter_token = h(
            "serving_inter_token_seconds",
            "per-token gap between host-visible emissions (a decode "
            "block's gap is spread evenly over its tokens)")
        # the head-of-line metric chunked prefill exists to shrink: the
        # wall gap between consecutive decode dispatches while some
        # running request is decode-ready
        self.decode_stall = h(
            "serving_decode_stall_seconds",
            "gap between consecutive decode-block dispatches while "
            "requests are running")
        # wall time per step by phase: schedule (policy + page
        # reservation), assemble (host-side batch packing), dispatch
        # (enqueueing the block's work; asynchronous, so NOT device time)
        # and drain (the one host sync pulling a block's tokens back)
        self.step_phase = {
            phase: h("serving_step_phase_seconds",
                     "per-step wall time by phase", labels={"phase": phase})
            for phase in ("schedule", "assemble", "dispatch", "drain")}
        # dispatch-to-drain wall of each block: how long its work stayed on
        # the device side of the overlap (host wall, not device time)
        self.device_residency = h(
            "serving_device_residency_seconds",
            "dispatch-to-drain wall per block: how long work was "
            "resident on the device side of the async overlap")
        self.queue_waiting = g("serving_queue_depth", "scheduler queue depth",
                               labels={"state": "waiting"})
        self.queue_running = g("serving_queue_depth", "scheduler queue depth",
                               labels={"state": "running"})
        self.free_pages = g("serving_kv_free_pages",
                            "allocatable KV pages right now")
        self.kv_util = g("serving_kv_page_utilization",
                         "fraction of allocatable KV pages in use")
        # resilience: one series per non-finished terminal status, and the
        # dispatch / drain sites retried after a transient fault
        self.terminated = {
            status: c("serving_requests_terminated_total",
                      "requests reaching a non-finished terminal status",
                      labels={"status": status})
            for status in ("cancelled", "expired", "failed", "shed")}
        self.retries = c("serving_transient_retries_total",
                         "dispatch/drain sites retried after a transient "
                         "fault")
        # tensor-parallel handles, bound by bind_tp() only when the engine
        # runs with tp_size > 1
        self.tp_collective = None
        self.tp_free_pages = None
        # speculative decoding handles, bound by bind_spec() only when the
        # engine runs with spec_config
        self.spec_drafted = None
        self.spec_accepted = None
        self.spec_wasted = None
        self.spec_target_steps = None
        self.spec_tokens_per_step = None

    def bind_kv_pool(self, kv_dtype: str, pool_bytes: int,
                     fp32_pool_bytes: int,
                     rms_error: Optional[float] = None) -> None:
        """KV-pool capacity gauges: pool bytes (data + scale slabs) by
        storage format, plus, for quantized pools, the capacity ratio
        against an equal-page fp32 pool and the construction-time
        quantization-error probe."""
        r = self.registry
        r.gauge("serving_kv_pool_bytes",
                "bytes held by the paged KV pools (data + scale slabs)",
                labels={"kv_dtype": kv_dtype}).set(pool_bytes)
        if rms_error is not None:
            r.gauge("serving_kv_capacity_ratio",
                    "fp32 pool bytes / this pool's bytes at equal page "
                    "count").set(fp32_pool_bytes / pool_bytes)
            r.gauge("serving_kv_quant_rms_error",
                    "quantize->dequantize RMS relative error, one-shot "
                    "construction-time probe on gaussian K/V"
                    ).set(rms_error)

    def bind_tp(self, tp_size: int, overlap: bool = False) -> None:
        """Tensor-parallel handles: the measured all-reduce wall histogram
        (labelled overlap on / off, so the serial and the pipelined wall
        never mix), one free-page gauge a shard (page accounting is single,
        so every shard reads the same number; the label keeps per-shard
        dashboards well formed), and a `tp=N` tag on every emitted
        lifecycle span name."""
        r = self.registry
        self.tp_collective = r.histogram(
            "serving_tp_collective_seconds",
            "measured all-reduce wall seconds on the engine's tp group "
            "(decode-step payload shape)",
            labels={"overlap": "on" if overlap else "off"})
        self.tp_free_pages = [
            r.gauge("serving_kv_pages_free",
                    "free KV pages per tensor-parallel shard",
                    labels={"shard": str(i)})
            for i in range(tp_size)]
        self.lifecycle.tag = f"tp={tp_size}"

    def bind_spec(self) -> None:
        """Speculative-decoding counters: drafted / accepted / wasted
        draft tokens, the target-model passes their accept rate divides
        into, and the tokens-per-target-step histogram (1.0 is plain
        decoding), one sample per request per drained block."""
        c = self.registry.counter
        self.spec_drafted = c("serving_spec_drafted_tokens_total",
                              "draft tokens submitted to verification")
        self.spec_accepted = c("serving_spec_accepted_tokens_total",
                               "draft tokens accepted by rejection sampling")
        self.spec_wasted = c("serving_spec_wasted_tokens_total",
                             "draft tokens rejected (verified, not emitted)")
        self.spec_target_steps = c(
            "serving_spec_target_steps_total",
            "target-model verify passes over speculative rows")
        self.spec_tokens_per_step = self.registry.histogram(
            "serving_spec_tokens_per_target_step",
            "tokens emitted per target-model pass, one sample per request "
            "per drained speculative block")

    def spec_drained(self, d_cnt: int, a_cnt: int, s_cnt: int,
                     emitted: int) -> None:
        self.spec_drafted.inc(d_cnt)
        self.spec_accepted.inc(a_cnt)
        self.spec_wasted.inc(d_cnt - a_cnt)
        self.spec_target_steps.inc(s_cnt)
        if s_cnt:
            self.spec_tokens_per_step.observe(emitted / s_cnt)

    # --------------------------------------------------- scheduler hooks
    def enqueued(self, req: Request) -> None:
        self.lifecycle.point(req.request_id, "enqueued", req.arrival_t)

    def admitted(self, req: Request) -> None:
        self.lifecycle.point(req.request_id, "admitted")

    def preempted(self, req: Request) -> None:
        self.preemptions.inc()
        now = time.perf_counter()
        self.lifecycle.point(req.request_id, "preempted", now)
        self.lifecycle.point(req.request_id, "requeued", now)

    def finished(self, req: Request) -> None:
        self.lifecycle.point(req.request_id, "finished", req.finish_t)

    def terminal(self, req: Request, status: str) -> None:
        """A request reached cancelled / expired / failed / shed: count it
        and stamp the lifecycle, so chrome traces and `trace_summary
        --requests` show how the request ended."""
        self.terminated[status].inc()
        self.lifecycle.point(req.request_id, status, req.finish_t)

    def parked(self, req: Request) -> None:
        self.parked_total.inc()
        self.lifecycle.point(req.request_id, "parked")

    def sample_queues(self, waiting: int, running: int, allocator) -> None:
        self.queue_waiting.set(waiting)
        self.queue_running.set(running)
        free = allocator.num_free
        total = allocator.num_allocatable
        self.free_pages.set(free)
        self.kv_util.set(1.0 - free / total if total else 0.0)
        if self.tp_free_pages is not None:
            for shard_gauge in self.tp_free_pages:
                shard_gauge.set(free)


# the reference's legacy spelling of unquantized pools (`cache_dtype`)
_CACHE_DTYPES = {torch.float32: "fp32", torch.bfloat16: "bf16",
                 "float32": "fp32", "bfloat16": "bf16"}


class ServingEngine:
    def __init__(self, model, *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 kv_dtype: str = "fp32",
                 decode_horizon: int = 8,
                 enable_chunked_prefill: bool = False,
                 prefill_chunk_tokens: int = 256,
                 max_num_batched_tokens: Optional[int] = None,
                 enable_ragged_step: bool = True,
                 enable_metrics: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 max_waiting: Optional[int] = None,
                 max_queue_wait_s: Optional[float] = None,
                 max_preemptions: Optional[int] = 8,
                 fault_injector=None,
                 retry_backoff_s: float = 0.02,
                 journal=None,
                 device=None,
                 cache_dtype=None,
                 enable_prefix_caching: bool = False,
                 spec_config=None,
                 tp_size: int = 1,
                 devices: Optional[Sequence] = None,
                 tp_quantized_allreduce: bool = False,
                 tp_overlap: bool = False,
                 tp_overlap_chunks: int = 2,
                 slo_classes: Optional[Sequence] = None,
                 slo_refresh_every: int = 64,
                 flight_recorder=None,
                 postmortem_dir: Optional[str] = None):
        from ..models.generation import _config_of

        kv_dtype = {"float32": "fp32", "bfloat16": "bf16"}.get(
            kv_dtype, kv_dtype)
        if cache_dtype is not None:
            # the reference's rule: a non-default cache_dtype sets the
            # pool format unless kv_dtype names another one
            legacy = _CACHE_DTYPES.get(cache_dtype)
            if legacy is None:
                raise ValueError(
                    f"unsupported cache_dtype {cache_dtype!r}: pools take "
                    "float32/bfloat16, or use kv_dtype='int8'/'fp8'")
            if kv_dtype == "fp32" and legacy != "fp32":
                kv_dtype = legacy
            elif legacy != "fp32" and kv_dtype != legacy:
                raise ValueError(
                    f"conflicting cache_dtype={cache_dtype!r} and "
                    f"kv_dtype={kv_dtype!r}: pick one knob")
        if kv_dtype not in KV_DTYPES and kv_dtype not in ("int8", "fp8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}: expected one "
                             "of 'fp32', 'bf16', 'int8', 'fp8'")
        self.device = resolve_device(device)
        param = next(iter(model.parameters()))
        if not same_device(param.device, self.device):
            raise ValueError(f"model lives on {param.device}, engine asked "
                             f"for {self.device}: move one of them")
        self.model = model
        model.eval()
        cfg = _config_of(model)
        self.kv_dtype = kv_dtype
        # tensor parallelism, with the reference's validation: the int8
        # all-reduce and the overlap replace a reduction tp_size=1 lacks
        self.tp_quantized_allreduce = bool(tp_quantized_allreduce)
        if self.tp_quantized_allreduce and int(tp_size) < 2:
            raise ValueError(
                "tp_quantized_allreduce replaces the row-parallel psum and "
                "needs tp_size >= 2 (tp_size=1 has no collective)")
        self.tp_overlap = bool(tp_overlap)
        self.tp_overlap_chunks = int(tp_overlap_chunks)
        if self.tp_overlap:
            if int(tp_size) < 2:
                raise ValueError(
                    "tp_overlap pipelines the row-parallel all-reduce and "
                    "needs tp_size >= 2 (tp_size=1 has no collective to "
                    "hide)")
            if self.tp_overlap_chunks < 1:
                raise ValueError(f"tp_overlap_chunks must be >= 1, got "
                                 f"{tp_overlap_chunks}")
        self.tp_size = int(tp_size)
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {tp_size}")
        if self.tp_size > 1:
            # the import stays inside the branch: a tp_size=1 engine runs
            # no tensor-parallel code
            from .tp import TPContext

            self._tp = TPContext(
                model, self.tp_size, devices=devices,
                quantized_allreduce=self.tp_quantized_allreduce,
                overlap=self.tp_overlap,
                overlap_chunks=self.tp_overlap_chunks)
        else:
            self._tp = None
        # what the dispatch code calls: the model, or its TP runner
        self._fwd = model if self._tp is None else self._tp.runner
        self.page_size = page_size
        self.max_batch_size = max_batch_size
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings
        self.max_pages_per_seq = pages_for(self.max_seq_len, page_size)
        self.decode_horizon = int(decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        # speculative decoding: the module is imported inside this branch
        # only, so a spec-off engine runs no speculative code at all
        if spec_config is not None:
            from . import spec as _spec_module

            self._spec = _spec_module
            self.spec_config = spec_config.validate()
        else:
            self._spec = None
            self.spec_config = None
        self._spec_lookahead = (self.spec_config.lookahead
                                if self.spec_config is not None else 0)
        # chunked prefill: page-aligned chunks co-scheduled with decode
        # under a per-step token budget. The chunk width must be a
        # positive multiple of page_size (chunk starts stay page-aligned)
        # and the budget must fit one chunk, or prefill never progresses
        self.enable_chunked_prefill = bool(enable_chunked_prefill)
        if self.enable_chunked_prefill:
            self.prefill_chunk_tokens = int(prefill_chunk_tokens)
            if self.prefill_chunk_tokens < page_size or \
                    self.prefill_chunk_tokens % page_size:
                raise ValueError(
                    f"prefill_chunk_tokens ({prefill_chunk_tokens}) must "
                    f"be a positive multiple of page_size ({page_size})")
            if max_num_batched_tokens is None:
                # one full chunk always fits beside a full decode batch
                # (decoders charge a block's worst case, horizon x
                # (1 + lookahead) under speculation)
                max_num_batched_tokens = (self.prefill_chunk_tokens
                                          + max_batch_size
                                          * self.decode_horizon
                                          * (1 + self._spec_lookahead))
            self.max_num_batched_tokens = int(max_num_batched_tokens)
            if self.max_num_batched_tokens < self.prefill_chunk_tokens:
                raise ValueError(
                    f"max_num_batched_tokens ({max_num_batched_tokens}) "
                    "must be >= prefill_chunk_tokens "
                    f"({self.prefill_chunk_tokens})")
            # ragged mixed steps (on by default under chunking): a step
            # with chunk work is ONE flat forward, padded to a token bucket
            self.enable_ragged_step = bool(enable_ragged_step)
            self.token_buckets = (
                token_buckets(max_batch_size, self.max_num_batched_tokens)
                if self.enable_ragged_step else None)
        else:
            self.prefill_chunk_tokens = None
            self.max_num_batched_tokens = None
            self.enable_ragged_step = False
            self.token_buckets = None
        if num_pages is None:
            # worst case every slot runs a full-length sequence, +1 null
            num_pages = max_batch_size * self.max_pages_per_seq + 1
        self.cache = PagedKVCache.for_model(model, num_pages, page_size,
                                            kv_dtype=self.kv_dtype)
        if self._tp is not None:
            self.cache.shard_pools(self._tp.devices)
        self.metrics = metrics if metrics is not None else (
            MetricsRegistry() if enable_metrics else None)
        self._obs = (ServingObs(self.metrics)
                     if self.metrics is not None else None)
        if self._obs is not None and self._tp is not None:
            self._obs.bind_tp(self.tp_size, overlap=self._tp.overlap)
            # this group's all-reduce wall, measured once here (a probe a
            # step would time the device queue, not the collective)
            for dt in self._tp.collective_seconds(
                    samples=3, rows=self.max_batch_size):
                self._obs.tp_collective.observe(dt)
        if self.metrics is not None:
            self.cache.allocator.bind_metrics(self.metrics)
            c = self.cache
            rms = None
            if c.quantized:
                from .quant import measure_roundtrip_error

                rms = measure_roundtrip_error(c.quant_spec, c.head_dim)
            self._obs.bind_kv_pool(c.kv_dtype, c.pool_bytes,
                                   self._fp32_pool_bytes(), rms)
            if self.spec_config is not None:
                self._obs.bind_spec()
        # SLO accounting: per-class TTFT / TPOT targets feeding windowed
        # attainment gauges and a goodput counter. It lives in the metrics
        # registry, so it needs one; with no classes the engine holds None
        # and runs no SLO code
        if slo_classes:
            if self.metrics is None:
                raise ValueError(
                    "slo_classes requires metrics (SLO accounting lives "
                    "in the registry); drop enable_metrics=False")
            self._slo = SloTracker(self.metrics, slo_classes,
                                   refresh_every=slo_refresh_every)
        else:
            self._slo = None
        # flight recorder: a bounded ring of control-plane events, None =
        # no recorder code runs. Independent of metrics
        self._recorder = flight_recorder
        # where quarantine post-mortem bundles land; None = bundles only
        # on an explicit dump_postmortem(directory=...)
        self._postmortem_dir = postmortem_dir
        self.last_postmortem_path: Optional[str] = None
        # automatic prefix caching: prefilled prompts leave their full
        # pages in a radix tree, and a later prompt sharing a page-aligned
        # prefix reuses them and prefills only its suffix
        self.prefix_cache = (PrefixCache(self.cache.allocator, page_size,
                                         metrics=self.metrics)
                             if enable_prefix_caching else None)
        # resilience: queue-wait shedding, deadlines, transient retry and
        # seeded fault injection, each a None / empty check when unused
        self._max_queue_wait_s = (float(max_queue_wait_s)
                                  if max_queue_wait_s is not None else None)
        self.retry_backoff_s = float(retry_backoff_s)
        self._faults = fault_injector
        # recovery: the exactly-once delivery ledger, appended when step()
        # RETURNS tokens (serving.recovery); None costs one check a step
        self._journal = journal
        # every fault _guarded_call or the device_lost gate observed,
        # transient or not: the supervisor's fault-storm window reads its
        # deltas (a plain int, so it works with metrics off)
        self.fault_events = 0
        # live request ids carrying a deadline; the expiry sweep runs only
        # while this is non-empty or max_queue_wait_s is set
        self._deadlined: set = set()
        if fault_injector is not None:
            self.cache.allocator.bind_faults(fault_injector)
            if self.prefix_cache is not None:
                self.prefix_cache.bind_faults(fault_injector)
        self.prefill_buckets = tuple(sorted(
            prefill_buckets or _default_buckets(self.max_seq_len)))
        if self.prefill_buckets[-1] < self.max_seq_len:
            raise ValueError("prefill_buckets must cover max_seq_len "
                             "(preempted requests re-prefill at their "
                             "full current length)")
        self.scheduler = Scheduler(self.cache.allocator, page_size,
                                   max_batch_size, self.max_pages_per_seq,
                                   prefix_cache=self.prefix_cache,
                                   decode_horizon=self.decode_horizon,
                                   drain_hook=self._drain_for_scheduler,
                                   obs=self._obs,
                                   recorder=flight_recorder,
                                   max_waiting=max_waiting,
                                   max_preemptions=max_preemptions,
                                   # chunked prefill takes any folded
                                   # length: no bucket ceiling to guard
                                   max_prefill_tokens=(
                                       None if self.enable_chunked_prefill
                                       else self.prefill_buckets[-1]),
                                   prefill_chunk_tokens=(
                                       self.prefill_chunk_tokens),
                                   max_num_batched_tokens=(
                                       self.max_num_batched_tokens),
                                   ragged_steps=self.enable_ragged_step,
                                   spec_lookahead=self._spec_lookahead)
        self.requests: Dict[int, Request] = {}
        # per-request sampling state: the seed, and how many tokens the
        # request has sampled so far (its next draw index)
        self._seeds: Dict[int, int] = {}
        self._draws: Dict[int, int] = {}
        # the dispatched-but-undrained decode block (overlap depth 1)
        self._pending: Optional[dict] = None
        # events produced when the scheduler's drain_hook fires inside
        # schedule(); step() returns them ahead of its own
        self._spill: List[Tuple[int, int]] = []
        self._last_drain_t = 0.0
        # perf_counter of the latest decode dispatch, cleared whenever no
        # running request is decode-ready, so the decode-stall histogram
        # only sees gaps while some request was being served
        self._last_decode_dispatch_t: Optional[float] = None

    def _fp32_pool_bytes(self) -> int:
        c = self.cache
        return (c.num_layers * c.num_pages * c.page_size * 2
                * c.num_kv_heads * c.head_dim * 4)

    # ----------------------------------------------------------- request API
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, seed: Optional[int] = None,
                    eos_token_id: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    slo_class: Optional[str] = None) -> int:
        """Queue one prompt; returns a request id. Non-blocking: the
        request runs as `step()`/`stream()` turn the crank. All validation
        happens up front, so a rejected request leaves no trace. Raises
        `EngineOverloaded` when the bounded waiting queue is full.
        `deadline_s` bounds the request's total latency from arrival: past
        it a waiting request expires before admission and a running one
        at the next block boundary (status "expired" either way).
        `slo_class` opts the request into per-class SLO accounting; it
        must name a class registered through `slo_classes=`."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0 (got {deadline_s})")
        if slo_class is not None and (
                self._slo is None or not self._slo.has_class(slo_class)):
            raise ValueError(
                f"unknown SLO class {slo_class!r}; register it via "
                "ServingEngine(slo_classes=[SloClass(...)])")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"{self.max_seq_len}")
        if not self.enable_chunked_prefill \
                and len(prompt) > self.prefill_buckets[-1]:
            # chunked prefill has no bucket ceiling: any prompt under
            # max_seq_len runs chunk by chunk
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=SamplingParams(temperature, top_k, top_p,
                                              seed),
                      eos_token_id=eos_token_id, slo_class=slo_class)
        if deadline_s is not None:
            req.deadline_t = req.arrival_t + deadline_s
        self.scheduler.add(req)       # may raise: register only after
        self.requests[req.request_id] = req
        if deadline_s is not None:
            self._deadlined.add(req.request_id)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        self._seeds[req.request_id] = int(seed)
        self._draws[req.request_id] = 0
        if self._journal is not None:
            # the EFFECTIVE seed (drawn above when the caller passed None)
            # and a wall-clock deadline go in the ledger: a rebuild
            # continues from both
            now_wall = time.time()
            self._journal.submit(
                request_id=req.request_id, prompt=prompt,
                max_new_tokens=max_new_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, seed=int(seed),
                eos_token_id=eos_token_id,
                deadline_wall=(now_wall + deadline_s
                               if deadline_s is not None else None),
                arrival_wall=now_wall)
        return req.request_id

    def output(self, request_id: int) -> List[int]:
        """prompt + generated tokens so far (a preempted request's prompt
        absorbs its generated tokens, so this is always the full
        sequence)."""
        req = self.requests[request_id]
        return list(req.prompt) + list(req.generated)

    def status(self, request_id: int) -> Tuple[str, Optional[str]]:
        """(status, error) for one request; error is set only for status
        "failed" (the isolated failure, as text)."""
        req = self.requests[request_id]
        return req.status, req.error

    def cancel(self, request_id: int) -> bool:
        """Cancel a waiting or running request. A request with tokens in
        the pending decode block is drained first, so already-sampled
        tokens surface through the next `step()` and no dispatched work
        still writes into released pages. Returns True if the request was
        live and is now "cancelled"."""
        req = self.requests.get(request_id)
        if req is None or req.status in TERMINAL_STATUSES:
            return False
        if self._pending is not None \
                and request_id in self._pending["rids"]:
            self._spill.extend(self._drain_pending())
            if req.status in TERMINAL_STATUSES:
                return False      # the drained tokens finished it
        return self._finalize(req, "cancelled")

    # ----------------------------------------------------------- resilience
    def _finalize(self, req: Request, status: str,
                  error: Optional[str] = None) -> bool:
        """Terminal transition through the scheduler (queues, refcounted
        page release) plus the engine's deadline bookkeeping. Every
        failure-side ending passes here, so the journal records it here
        and a replay never resurrects a request that already ended."""
        done = self.scheduler.finalize(req, status, error=error)
        if done and self._journal is not None \
                and self._journal.known(req.request_id):
            self._journal.terminal(req.request_id, status, error)
        if self._deadlined:
            self._deadlined.discard(req.request_id)
        return done

    def _expire_and_shed(self) -> None:
        """Deadline / queue-wait sweep at the top of a step (a block
        boundary), run only while armed: waiting requests past their
        deadline expire and ones waiting longer than `max_queue_wait_s`
        are shed before admission spends pages on them; running requests
        past their deadline expire after any in-flight block drains."""
        now = time.perf_counter()
        for req in list(self.scheduler.waiting):
            if req.deadline_t is not None and now >= req.deadline_t:
                self._finalize(req, "expired")
            elif self._max_queue_wait_s is not None and \
                    now - req.arrival_t >= self._max_queue_wait_s:
                self._finalize(req, "shed")
        expired = [r for r in self.scheduler.running
                   if r.deadline_t is not None and now >= r.deadline_t]
        if expired:
            if self._pending is not None:
                # surface the in-flight tokens before the pages go
                self._spill.extend(self._drain_pending())
            for req in expired:
                if req.status == "running":   # the drain may finish it
                    self._finalize(req, "expired")

    def _guarded_call(self, site: str, fn):
        """Failure isolation for one dispatch or drain site: consults the
        fault injector (when bound), retries a TRANSIENT fault once after
        `retry_backoff_s`, and otherwise hands the exception back for the
        caller to quarantine. A FATAL fault is re-raised untouched for the
        supervisor. Every fault seen here bumps `fault_events`. Returns
        (result, None) on success and (None, exc) on isolation. An
        injected fault fires before `fn` runs, so a retried site computes
        nothing twice."""
        fi = self._faults
        try:
            if fi is not None:
                fi.check(site)
            return fn(), None
        except Exception as e:  # noqa: BLE001 (the isolation boundary)
            self.fault_events += 1
            if self._recorder is not None:
                self._recorder.record("fault", site=site, error=str(e),
                                      **describe_fault(e))
            if is_fatal(e):
                raise
            if not is_transient(e):
                return None, e
            if self._obs is not None:
                self._obs.retries.inc()
            if self.retry_backoff_s > 0:
                time.sleep(self.retry_backoff_s)
            try:
                if fi is not None:
                    fi.check(site)
                return fn(), None
            except Exception as e2:  # noqa: BLE001
                self.fault_events += 1
                if self._recorder is not None:
                    self._recorder.record("fault", site=site, retry=True,
                                          error=str(e2),
                                          **describe_fault(e2))
                if is_fatal(e2):
                    raise
                return None, e2

    def _quarantine(self, reqs: Sequence[Request], exc: BaseException,
                    site: str) -> None:
        """Isolate a failed dispatch or drain to exactly the implicated
        requests: status "failed" with the error recorded, pages released
        through the refcounts, the allocator and scheduler re-audited. A
        pending record that carries any of them is dropped BEFORE their
        pages are freed (its carries are suspect; a block still in flight
        on the stream writes before any later dispatch reuses a page)."""
        err = f"{site}: {type(exc).__name__}: {exc}"
        rids = {r.request_id for r in reqs}
        if self._recorder is not None:
            self._recorder.record("quarantine", site=site, error=err,
                                  rids=sorted(rids))
        if self._pending is not None \
                and rids & set(self._pending["rids"]):
            rec, self._pending = self._pending, None
            for i, r in enumerate(rec["reqs"]):
                r.inflight = max(r.inflight - rec["incr"][i], 0)
        for req in reqs:
            if req.status not in TERMINAL_STATUSES:
                self._finalize(req, "failed", error=err)
        self.scheduler.check_consistency()
        if self._postmortem_dir is not None:
            # a quarantine is a casualty worth forensics even though the
            # engine survives; the dump itself must never take it down
            try:
                self.dump_postmortem(f"quarantine-{site}")
            except Exception:  # noqa: BLE001 (forensics must not kill)
                pass

    # ---------------------------------------------------------------- steps
    def step(self) -> List[Tuple[int, int]]:
        """One scheduler decision + at most one dispatch. Returns the
        (request_id, token) pairs that reached the host this step: a
        decode block's tokens surface one step AFTER its dispatch. This is
        also the recovery boundary: the injector's `device_lost` site
        fires here (fatal by default, left for the supervisor), and the
        returned events are journaled here, at the moment they become
        visible to the caller."""
        fi = self._faults
        if fi is not None:
            try:
                fi.check("device_lost")
            except Exception as e:
                self.fault_events += 1
                if self._recorder is not None:
                    self._recorder.record("fault", site="device_lost",
                                          error=str(e), **describe_fault(e))
                raise
        events = self._step_impl()
        if self._journal is not None and events:
            self._journal_delivery(events)
        if self._slo is not None:
            self._slo.step_tick()
        return events

    def _step_impl(self) -> List[Tuple[int, int]]:
        if self._deadlined or self._max_queue_wait_s is not None:
            self._expire_and_shed()            # may spill drained tokens
        if not any(r.prefill_done for r in self.scheduler.running):
            # decode-stall gaps only count while some request continuously
            # wanted decode steps: a wave boundary, or a stretch where
            # every running request is mid-prefill, resets the clock
            self._last_decode_dispatch_t = None
        if self._pending is not None and "windows" in self._pending:
            # a speculative record's drain reverts its worst-case page
            # charge, so it runs BEFORE schedule() charges the next block:
            # draining after would pop pages the next block's table needs
            # and sink its K/V writes into the null page. It costs nothing:
            # a speculative block never chains on device carries
            self._spill.extend(self._drain_pending())
        t_sched = time.perf_counter()
        decision = self.scheduler.schedule()   # drain_hook may spill here
        if self._obs is not None:
            self._obs.step_phase["schedule"].observe(
                time.perf_counter() - t_sched)
        if self._recorder is not None:
            self._recorder.record(
                "schedule", decision=decision.kind,
                prefill=(decision.prefill.request_id
                         if decision.prefill is not None else None),
                decode=len(decision.decode), chunks=len(decision.chunks))
        spilled, self._spill = self._spill, []
        if decision.kind == "prefill":
            return spilled + self._prefill(decision.prefill)
        if decision.kind == "decode":
            return spilled + self._decode_path(decision.decode)
        if decision.kind == "ragged":
            return spilled + self._ragged_step(decision)
        if decision.kind == "mixed":
            return spilled + self._mixed_step(decision)
        return spilled + self._drain_pending()

    def _mixed_step(self, decision) -> List[Tuple[int, int]]:
        """One chained chunked-prefill step: the decode block dispatches
        FIRST (its drain overlaps the chunks' device time), then each
        scheduled chunk runs as its own prefill at its offset, on the
        same stream. Intermediate chunks sync nothing."""
        events: List[Tuple[int, int]] = []
        if decision.decode:
            events.extend(self._decode_path(decision.decode))
        elif self._pending is not None:
            events.extend(self._drain_pending())
        for task in decision.chunks:
            if task.req.status != "running":
                continue    # finalized mid-step (cancel, expiry, fault)
            if task.start != task.req.num_computed_tokens:
                # stale extent: the request was preempted (and possibly
                # re-admitted) after this task was queued
                continue
            events.extend(self._chunk_prefill(task))
        return events

    def _journal_delivery(self, events: List[Tuple[int, int]]) -> None:
        """Append just-returned events to the journal: called where tokens
        become visible to a `step()` / `stream()` caller, never at drain
        time (a drained but unreturned token must stay recomputable, not
        re-deliverable). Consecutive same-request runs land as one record;
        a request whose stream just completed gets its `finished` record
        after its tokens."""
        j = self._journal
        t_wall = time.time()
        i = 0
        while i < len(events):
            rid = events[i][0]
            k = i + 1
            while k < len(events) and events[k][0] == rid:
                k += 1
            if j.known(rid):
                j.tokens(rid, [t for _, t in events[i:k]], t_wall=t_wall)
            i = k
        for rid in dict.fromkeys(r for r, _ in events):
            if j.known(rid) and self.requests[rid].status == "finished":
                j.terminal(rid, "finished")

    def drain_all(self) -> List[Tuple[int, int]]:
        """Flush everything already computed out to the caller: spilled
        events plus the pending block, journaled like a step's return."""
        spilled, self._spill = self._spill, []
        events = spilled + self._drain_pending()
        if self._journal is not None and events:
            self._journal_delivery(events)
        return events

    def stream(self):
        """Generator of (request_id, token, done) events until every
        queued request completes."""
        while (self.scheduler.has_work() or self._pending is not None
               or self._spill):
            if self.scheduler.has_work():
                events = self.step()
            else:
                events = self.drain_all()
            for i, (rid, tok) in enumerate(events):
                done = (self.requests[rid].status == "finished"
                        and all(r != rid for r, _ in events[i + 1:]))
                yield rid, tok, done

    def run(self) -> Dict[int, List[int]]:
        """Drain all queued requests; returns request_id -> full tokens."""
        for _ in self.stream():
            pass
        return {rid: self.output(rid) for rid in self.requests}

    # ------------------------------------------------------------ sampling
    def _knobs(self, reqs: Sequence[Request], rows: int) -> dict:
        """Per-row sampling knobs on the device for `rows` rows (rows past
        `reqs` are padding: greedy, no EOS)."""
        seeds = np.zeros((rows,), np.int64)
        temps = np.zeros((rows,), np.float32)
        top_ks = np.zeros((rows,), np.int64)
        top_ps = np.ones((rows,), np.float32)
        eos_ids = np.full((rows,), PAD_TOKEN, np.int64)
        for i, req in enumerate(reqs):
            sp = req.sampling
            seeds[i] = self._seeds[req.request_id]
            temps[i], top_ks[i], top_ps[i] = (sp.temperature, sp.top_k,
                                              sp.top_p)
            if req.eos_token_id is not None:
                eos_ids[i] = req.eos_token_id
        dev = self.device
        return {"seeds": host_to_device(seeds, dev),
                "temps": host_to_device(temps, dev),
                "top_ks": host_to_device(top_ks, dev),
                "top_ps": host_to_device(top_ps, dev),
                "eos_ids": host_to_device(eos_ids, dev),
                "greedy_only": all(r.sampling.temperature == 0.0
                                   for r in reqs)}

    def _emit(self, req: Request, token: int, now: float
              ) -> Tuple[int, int]:
        req.generated.append(token)
        self._draws[req.request_id] += 1
        o = self._obs
        if o is not None:
            o.tokens.inc()
        if req.first_token_t is None:
            req.first_token_t = now
            if o is not None:
                ttft = max(now - req.arrival_t, 0.0)
                o.ttft.observe(ttft)
                o.lifecycle.point(req.request_id, "first_token", now)
                if self._slo is not None:
                    self._slo.first_token(req.slo_class, ttft)
        req.last_token_t = now
        if req.is_done():
            req.finish_t = now
            self.scheduler.finish(req)
        return (req.request_id, token)

    # -------------------------------------------------------------- prefill
    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _prefill(self, req: Request) -> List[Tuple[int, int]]:
        """Prefill a prompt, or on a prefix-cache hit only its uncached
        suffix, bucketed on the suffix length, at the cached offset (a
        host int: offset 0 attends over the step's own K/V, a cached
        offset over the gathered page table); the first token is sampled
        from the suffix's last logits."""
        t_in = time.perf_counter()
        n_cached = req.cached_tokens
        suffix = req.prompt[n_cached:]
        bucket = self._bucket_for(len(suffix))
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :len(suffix)] = suffix
        ids = host_to_device(ids, self.device)
        page_table = self.cache.page_table_array([req.pages],
                                                 self.max_pages_per_seq)
        knobs = self._knobs([req], 1)
        draws = host_to_device(
            np.asarray([self._draws[req.request_id]], np.int64), self.device)

        def dispatch():
            with torch.no_grad():
                logits, _ = self._fwd(ids, caches=self.cache.layer_views(
                    page_table), start_pos=n_cached)
                tok = sample_batch(logits[:, len(suffix) - 1], knobs, draws)
                return int(tok[0])             # the prefill's host sync

        t0 = time.perf_counter()
        if self._recorder is not None:
            self._recorder.record(
                "dispatch", family="prefill_offset" if n_cached else "prefill",
                rid=req.request_id, tokens=len(suffix))
        with RecordEvent("serving.prefill"):
            token, err = self._guarded_call("dispatch", dispatch)
        if err is not None:
            # isolate THIS request; a pending decode block belongs to other
            # (prefilled) requests and keeps flying
            self._quarantine([req], err, "prefill")
            return []
        req.num_computed_tokens = len(req.prompt)
        if self.prefix_cache is not None:
            # the prompt's full pages become reusable (the partial last
            # page never enters the tree)
            self.prefix_cache.insert(req.prompt, req.pages)
        now = time.perf_counter()
        o = self._obs
        prev_t = req.last_token_t              # set => this is a re-prefill
        if o is not None:
            o.prefill_steps.inc()
            o.dispatches.inc()
            o.host_syncs.inc()
            o.prefill_seconds.inc(now - t0)
            o.lifecycle.span(req.request_id, "prefill", t0, now)
            o.step_phase["assemble"].observe(t0 - t_in)
            o.step_phase["dispatch"].observe(now - t0)
        events = [self._emit(req, token, now)]
        if o is not None and prev_t is not None:
            # a requeued request: the gap since its last token before the
            # preemption is its inter-token latency
            gap = max(now - prev_t, 0.0)
            o.inter_token.observe(gap)
            if self._slo is not None:
                self._slo.decode_tokens(req.slo_class, gap, 1)
        return events

    # ------------------------------------------------------ chunked prefill
    def _chunk_prefill(self, task) -> List[Tuple[int, int]]:
        """One scheduled prefill chunk at its offset, attending over the
        request's earlier pages through its page table. Intermediate
        chunks write K/V and return without a host sync or a draw; the
        final chunk samples the first token at the request's next draw
        index, exactly like the tail of `_prefill`."""
        t_in = time.perf_counter()
        req, start, n = task.req, task.start, task.length
        final = task.is_final
        dev = self.device
        ids = host_to_device(np.asarray([req.prompt[start:start + n]],
                                        np.int64), dev)
        page_table = self.cache.page_table_array([req.pages],
                                                 self.max_pages_per_seq)
        # the offset rides as a tensor, so even a first chunk at 0 takes
        # the paged path every chunk takes (serving.attention)
        offset = host_to_device(np.asarray([start], np.int64), dev)
        if final:
            knobs = self._knobs([req], 1)
            draws = host_to_device(
                np.asarray([self._draws[req.request_id]], np.int64), dev)

        def dispatch():
            with torch.no_grad():
                logits, _ = self._fwd(ids, caches=self.cache.layer_views(
                    page_table), start_pos=offset)
                if not final:
                    return PAD_TOKEN           # no host sync, no draw
                tok = sample_batch(logits[:, n - 1], knobs, draws)
                return int(tok[0])             # the final chunk's host sync

        t0 = time.perf_counter()
        if self._recorder is not None:
            self._recorder.record("dispatch", family="prefill_chunk",
                                  rid=req.request_id, tokens=n, final=final)
        with RecordEvent("serving.prefill_chunk"):
            token, err = self._guarded_call("dispatch", dispatch)
        if err is not None:
            # only this request: its cursor never advanced, so finalize
            # releases exactly its chunk-to-date pages
            self._quarantine([req], err, "prefill_chunk")
            return []
        req.num_computed_tokens = start + n
        now = time.perf_counter()
        o = self._obs
        if o is not None:
            o.prefill_chunks.inc()
            o.dispatches.inc()
            o.prefill_seconds.inc(now - t0)
            # intermediate chunks go to the profiler only (the retained
            # lifecycle lists must not grow a chunk at a time); the final
            # chunk is the retained "prefill" stage
            o.lifecycle.span(req.request_id, "prefill", t0, now,
                             retain=final)
            o.step_phase["assemble"].observe(t0 - t_in)
            o.step_phase["dispatch"].observe(now - t0)
        if not final:
            return []
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, req.pages)
        prev_t = req.last_token_t              # set => this is a re-prefill
        if o is not None:
            o.prefill_steps.inc()
            o.host_syncs.inc()
        events = [self._emit(req, token, now)]
        if o is not None and prev_t is not None:
            gap = max(now - prev_t, 0.0)
            o.inter_token.observe(gap)
            if self._slo is not None:
                self._slo.decode_tokens(req.slo_class, gap, 1)
        return events

    # ---------------------------------------------------------- ragged step
    def _ragged_step(self, decision) -> List[Tuple[int, int]]:
        """One flat ragged step: iteration 0 is a single (1, T) forward
        carrying every row's input tokens - each decode row's one token
        and every chunk's extent, routed through their own page-table rows
        by the ragged attention kernel - followed by the decode body for
        horizon-1 iterations over the decode rows. A final chunk is a row
        with an emit budget of 1, an intermediate chunk a row with budget
        0. Flat inputs come from host request state, so any pending block
        drains FIRST; the record this step leaves drains under the next
        step's device time, so a final chunk's token surfaces at the next
        drain.

        Under speculation the decode iterations after iteration 0 are
        horizon-1 verify windows over the decode rows
        (spec.verify_windows), whose drafts start after iteration 0's
        token."""
        events = self._drain_pending()
        t_in = time.perf_counter()      # assemble starts after the drain
        decode = [r for r in decision.decode if r.status == "running"]
        chunks = [t for t in decision.chunks
                  if t.req.status == "running"
                  and t.start == t.req.num_computed_tokens]
        if not chunks:
            # every chunk went stale during the drain: plain decode
            return events + (self._decode_path(decode) if decode else [])
        max_pages = self.max_pages_per_seq
        h, L = self.decode_horizon, self._spec_lookahead
        spec_on = self.spec_config is not None
        # a speculative decode row can emit 1 (iteration 0) + (h-1) x
        # (1+L) tokens: the in-flight bound scales with it
        batch = build_ragged_inputs(
            decode, chunks, buckets=self.token_buckets,
            max_batch=self.max_batch_size,
            horizon=1 + (h - 1) * (1 + L),
            page_size=self.page_size, max_pages=max_pages,
            draws=self._draws)
        if batch is None:
            return events
        dev = self.device
        page_tables = self.cache.page_table_array(batch.page_lists,
                                                  max_pages)
        flat_ids, last_idx, tokens = (
            host_to_device(x.astype(np.int64), dev)
            for x in (batch.flat_ids, batch.last_idx, batch.tokens))
        flat_pos, row_ids, positions, remaining, draws = (
            host_to_device(x, dev)
            for x in (batch.flat_pos, batch.row_ids, batch.positions,
                      batch.remaining, batch.draws))
        knobs = self._knobs(batch.reqs, self.max_batch_size)
        if spec_on:
            # drafts for the decode rows only: a final chunk emits its one
            # iteration-0 token and parks
            dbuf = host_to_device(self._spec.build_draft_buffer(
                decode, self.max_batch_size, h * (1 + L), self.spec_config,
                self.prefix_cache), dev)

        def dispatch():
            with torch.no_grad():
                logits, _ = self._fwd(
                    flat_ids, caches=self.cache.layer_views(page_tables,
                                                            row_ids),
                    start_pos=flat_pos)
                nxt = sample_batch(logits[0, last_idx], knobs, draws)
                alive = remaining > 0
                emit, tok, pos, drw, rem = self._advance(
                    nxt, tokens, positions, draws, knobs, remaining,
                    max_pages)
                emitted = [emit[:, None]]
                # chunk rows are parked now; a chunk-only step skips the
                # iterations in which every row would be dead
                views = (self.cache.layer_views(page_tables) if decode
                         else None)
                if spec_on:
                    # the tokens and the accept counters come back in ONE
                    # copy
                    emitted.extend(self._spec.verify_windows(
                        self._fwd, views, dbuf, tok, pos, drw, knobs, rem,
                        windows=h - 1 if decode else 0, lookahead=L,
                        page_size=self.page_size, max_pages=max_pages,
                        first=nxt, alive=alive))
                elif decode:
                    for _ in range(h - 1):
                        emit, tok, pos, drw, rem = self._decode_iter(
                            views, tok, pos, drw, knobs, rem, max_pages)
                        emitted.append(emit[:, None])
                return _start_host_copy(torch.cat(emitted, dim=1))

        t0 = time.perf_counter()
        if self._recorder is not None:
            self._recorder.record("dispatch", family="ragged",
                                  rows=len(batch.reqs), decode=len(decode),
                                  chunks=len(chunks),
                                  t_bucket=batch.t_bucket)
        with RecordEvent("serving.ragged_step"):
            out, err = self._guarded_call("dispatch", dispatch)
        if err is not None:
            # one dispatch carries every row: a fault implicates them all
            self._quarantine([r for r in batch.reqs
                              if r.status == "running"], err, "ragged")
            return events
        host, event = out
        for req, n in zip(batch.reqs, batch.incr):
            req.inflight += n
        now = time.perf_counter()
        o = self._obs
        for task in chunks:
            task.req.num_computed_tokens = task.start + task.length
            if task.is_final and self.prefix_cache is not None:
                # the pages are complete once this dispatch lands; later
                # dispatches queue behind it on the stream
                self.prefix_cache.insert(task.req.prompt, task.req.pages)
            if o is not None:
                o.prefill_chunks.inc()
                o.lifecycle.span(task.req.request_id, "prefill", t0, now,
                                 retain=task.is_final)
                if task.is_final:
                    o.prefill_steps.inc()
        if o is not None:
            o.ragged_steps.inc()
            o.dispatches.inc()
            o.step_phase["assemble"].observe(t0 - t_in)
            o.step_phase["dispatch"].observe(now - t0)
            if decode:
                o.decode_steps.inc()
                if self._last_decode_dispatch_t is not None:
                    o.decode_stall.observe(
                        max(t0 - self._last_decode_dispatch_t, 0.0))
        if decode:
            self._last_decode_dispatch_t = t0
        if decode or any(t.is_final for t in chunks):
            self._pending = {
                "kind": "ragged",
                "rids": tuple(r.request_id for r in batch.reqs),
                "reqs": list(batch.reqs), "incr": list(batch.incr),
                "host": host, "event": event, "t0": t0,
            }
            if spec_on:
                self._pending["windows"] = (
                    (1,) + (L + 1,) * (h - 1) if decode else (1,))
        # else: intermediate chunks only - nothing can emit, so no record
        # (and no host sync) is left behind
        return events

    # --------------------------------------------------------------- decode
    def _advance(self, nxt, tokens, positions, draws, knobs, remaining,
                 max_pages: int):
        """The decode body's bookkeeping after sampling `nxt`: EOS and
        budget masking, the draw counters, the position advance (dead rows
        park). Returns (emitted, tokens, positions, draws, remaining)."""
        eos_ids = knobs["eos_ids"]
        alive = remaining > 0
        hit_eos = alive & (eos_ids >= 0) & (nxt == eos_ids)
        emit = torch.where(alive, nxt, torch.full_like(nxt, PAD_TOKEN))
        remaining = torch.where(alive, remaining - 1, remaining)
        remaining = torch.where(hit_eos, torch.zeros_like(remaining),
                                remaining)
        tokens = torch.where(alive, nxt, tokens)
        draws = draws + alive.to(draws.dtype)
        positions = advance_positions(positions, remaining > 0, max_pages,
                                      self.page_size)
        return emit, tokens, positions, draws, remaining

    def _decode_iter(self, views, tokens, positions, draws, knobs,
                     remaining, max_pages: int):
        """One model step of every row with sampling and `_advance`."""
        logits, _ = self._fwd(tokens[:, None], caches=views,
                              start_pos=positions)
        nxt = sample_batch(logits[:, 0], knobs, draws)
        return self._advance(nxt, tokens, positions, draws, knobs,
                             remaining, max_pages)

    def _decode_block(self, tokens, page_tables, positions, draws, knobs,
                      remaining):
        """`decode_horizon` model steps with sampling, EOS/budget masking
        and position advance, all enqueued on the device with no host
        sync. Returns the (b, horizon) emitted block and the carries the
        next chained block consumes."""
        max_pages = page_tables.shape[1]
        views = self.cache.layer_views(page_tables)
        emitted = []
        for _ in range(self.decode_horizon):
            emit, tokens, positions, draws, remaining = self._decode_iter(
                views, tokens, positions, draws, knobs, remaining, max_pages)
            emitted.append(emit)
        return torch.stack(emitted, dim=1), tokens, positions, draws, \
            remaining

    def _decode_rows(self, n: int) -> int:
        """Dispatched decode row count: the next power of two >= n, capped
        at max_batch_size."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch_size)

    def _decode_page_tables(self, reqs: Sequence[Request],
                            b: int) -> torch.Tensor:
        page_lists: List[Sequence[int]] = [()] * b
        for i, req in enumerate(reqs):
            page_lists[i] = req.pages
        return self.cache.page_table_array(page_lists,
                                           self.max_pages_per_seq)

    def _decode_inputs(self, reqs: Sequence[Request], b: int):
        """A fresh block's (tokens, positions, remaining, draws, knobs) on
        the device for `b` rows, from (drained, accurate) host state; rows
        past `reqs` are dead padding parked at the overflow slot."""
        park = overflow_position(self.max_pages_per_seq, self.page_size)
        tokens = np.zeros((b,), np.int64)
        positions = np.full((b,), park, np.int32)
        remaining = np.zeros((b,), np.int32)
        draws = np.zeros((b,), np.int64)
        for i, req in enumerate(reqs):
            tokens[i] = (req.generated[-1] if req.generated
                         else req.prompt[-1])
            # the input token's K/V lands at its own position; the step
            # predicts the token after it
            positions[i] = req.num_tokens - 1
            remaining[i] = req.max_new_tokens - len(req.generated)
            draws[i] = self._draws[req.request_id]
        dev = self.device
        return tuple(host_to_device(x, dev) for x in (
            tokens, positions, remaining, draws)) + (self._knobs(reqs, b),)

    def _decode_path(self, reqs: Sequence[Request]
                     ) -> List[Tuple[int, int]]:
        """A decode batch goes to the speculative block when speculation
        is on; the spec-off path is `_decode`, unchanged."""
        if self.spec_config is not None:
            return self._spec_decode(reqs)
        return self._decode(reqs)

    def _spec_decode(self, reqs: Sequence[Request]
                     ) -> List[Tuple[int, int]]:
        """A speculative decode block: `decode_horizon` verify windows of
        (b, 1 + lookahead) tokens (spec.verify_windows). Its drafts come
        from HOST request state, so the pending block drains FIRST and a
        speculative block never chains on device carries; its own record
        drains under the next step's work. A row can emit up to horizon
        x (1 + lookahead) tokens: the scheduler charged pages for that,
        and the drain reverts the charge to what was accepted."""
        events = self._drain_pending()
        t_in = time.perf_counter()
        reqs = [r for r in reqs if r.status == "running"]
        if not reqs:
            return events
        h, L = self.decode_horizon, self._spec_lookahead
        cap = h * (1 + L)
        b = self._decode_rows(len(reqs))
        page_tables = self._decode_page_tables(reqs, b)
        tokens, positions, remaining, draws, knobs = self._decode_inputs(
            reqs, b)
        # drafts ride in as one (b, cap) PAD-padded buffer; each window
        # slides its row's cursor by the row's emitted count
        dbuf = host_to_device(self._spec.build_draft_buffer(
            reqs, b, cap, self.spec_config, self.prefix_cache), self.device)
        incr = [max(min(cap, r.max_new_tokens - len(r.generated)
                        - r.inflight), 0) for r in reqs]

        def dispatch():
            with torch.no_grad():
                out = torch.cat(self._spec.verify_windows(
                    self._fwd, self.cache.layer_views(page_tables), dbuf,
                    tokens, positions, draws, knobs, remaining, windows=h,
                    lookahead=L, page_size=self.page_size,
                    max_pages=self.max_pages_per_seq), dim=1)
            # the tokens and the accept counters come back in ONE copy
            return _start_host_copy(out)

        t0 = time.perf_counter()
        if self._recorder is not None:
            self._recorder.record("dispatch", family="spec", rows=len(reqs),
                                  horizon=h, lookahead=L)
        with RecordEvent("serving.spec_block"):
            out, err = self._guarded_call("dispatch", dispatch)
        if err is not None:
            self._quarantine([r for r in reqs if r.status == "running"],
                             err, "spec")
            return events
        host, event = out
        for req, n in zip(reqs, incr):
            req.inflight += n
        o = self._obs
        if o is not None:
            o.step_phase["assemble"].observe(t0 - t_in)
            o.step_phase["dispatch"].observe(time.perf_counter() - t0)
            o.decode_steps.inc()
            o.dispatches.inc()
            if self._last_decode_dispatch_t is not None:
                o.decode_stall.observe(
                    max(t0 - self._last_decode_dispatch_t, 0.0))
        self._last_decode_dispatch_t = t0
        self._pending = {
            "kind": "spec", "rids": tuple(r.request_id for r in reqs),
            "reqs": list(reqs), "incr": incr, "host": host, "event": event,
            "windows": (L + 1,) * h, "t0": t0,
        }
        return events

    def _decode(self, reqs: Sequence[Request]) -> List[Tuple[int, int]]:
        t_in = time.perf_counter()
        reqs = [r for r in reqs if r.status == "running"]
        if not reqs:
            return self._drain_pending()
        h = self.decode_horizon
        rids = tuple(r.request_id for r in reqs)
        events_prev: List[Tuple[int, int]] = []
        prev = self._pending
        if prev is not None and (prev["kind"] != "decode"
                                 or prev["rids"] != rids):
            # batch composition changed (admission / finish / preemption),
            # or the pending record is a ragged step (it leaves no decode
            # carries): sync and go fresh
            events_prev = self._drain_pending()
            reqs = [r for r in reqs if r.status == "running"]
            if not reqs:
                return events_prev
            rids = tuple(r.request_id for r in reqs)
            prev = None
        b = self._decode_rows(len(reqs))
        page_tables = self._decode_page_tables(reqs, b)
        if prev is None:
            # fresh block: inputs from (drained, accurate) host state
            tokens, positions, remaining, draws, knobs = \
                self._decode_inputs(reqs, b)
        else:
            # chained block: the pending block's device carries, no sync
            tokens, positions = prev["tokens"], prev["positions"]
            draws, remaining = prev["draws"], prev["remaining"]
            knobs = prev["knobs"]
        # the block may add up to min(h, budget) tokens per row before the
        # host sees them; the scheduler reserves pages against this bound
        incr = [max(min(h, r.max_new_tokens - len(r.generated) - r.inflight),
                    0) for r in reqs]

        def dispatch():
            with torch.no_grad():
                emitted, *carries = self._decode_block(
                    tokens, page_tables, positions, draws, knobs, remaining)
            return _start_host_copy(emitted), carries

        t0 = time.perf_counter()
        if self._recorder is not None:
            self._recorder.record("dispatch", family="decode",
                                  rows=len(reqs), horizon=h)
        with RecordEvent("serving.decode_block"):
            out, err = self._guarded_call("dispatch", dispatch)
        if err is not None:
            # a decode dispatch implicates the whole batch. Drain the
            # previous block FIRST (its tokens are sound and its writes
            # land before the pages are released), then isolate whatever
            # still runs
            ev = self._drain_pending()
            self._quarantine([r for r in reqs if r.status == "running"],
                             err, "decode")
            return events_prev + ev
        (host, event), (tokens, positions, draws, remaining) = out
        for req, n in zip(reqs, incr):
            req.inflight += n
        if self._obs is not None:
            self._obs.step_phase["assemble"].observe(t0 - t_in)
            self._obs.step_phase["dispatch"].observe(
                time.perf_counter() - t0)
            self._obs.decode_steps.inc()
            self._obs.dispatches.inc()
            if self._last_decode_dispatch_t is not None:
                # dispatch-to-dispatch gap while requests were running:
                # whatever kept the engine from decode shows up here
                self._obs.decode_stall.observe(
                    max(t0 - self._last_decode_dispatch_t, 0.0))
        self._last_decode_dispatch_t = t0
        self._pending = {
            "kind": "decode", "rids": rids, "reqs": list(reqs), "incr": incr,
            "host": host, "event": event, "tokens": tokens,
            "positions": positions, "draws": draws, "remaining": remaining,
            "knobs": knobs, "t0": t0,
        }
        if prev is not None:
            # block k+1 is enqueued; pulling block k's tokens now waits
            # only for block k's copy
            return events_prev + self._drain_record(prev)
        return events_prev

    # ---------------------------------------------------------------- drain
    def _drain_for_scheduler(self) -> None:
        """Scheduler drain_hook: drained events surface through step()'s
        spill queue so callers still see every token."""
        self._spill.extend(self._drain_pending())

    def _drain_pending(self) -> List[Tuple[int, int]]:
        rec, self._pending = self._pending, None
        if rec is None:
            return []
        return self._drain_record(rec)

    def _drain_record(self, rec: dict) -> List[Tuple[int, int]]:
        """THE host sync of a decode block: wait for its token copy,
        append per-request tokens trimmed at PAD, finish requests. A
        speculative record (`windows` set) carries PAD-terminated windows
        and the rows' (drafted, accepted, target steps) counters in the
        same copy; after it drains, each running row's worst-case page
        charge is reverted."""
        o = self._obs
        t_in = time.perf_counter()
        with RecordEvent("serving.host_drain"):
            toks, err = self._guarded_call("drain", lambda: _pull(rec))
        windows = rec.get("windows")
        if err is not None:
            # the block's tokens are lost: give back the in-flight bound
            # and isolate exactly its running rows (rec is detached from
            # _pending already, so teardown releases pages directly; a
            # speculative record's worst-case charge goes with them)
            for i, req in enumerate(rec["reqs"]):
                req.inflight = max(req.inflight - rec["incr"][i], 0)
            self._quarantine([r for r in rec["reqs"]
                              if r.status == "running"], err, "drain")
            return []
        if windows is not None:
            toks, sstats = toks[:, :-3], toks[:, -3:]
        if o is not None:
            o.host_syncs.inc()
        now = time.perf_counter()
        events: List[Tuple[int, int]] = []
        for i, req in enumerate(rec["reqs"]):
            req.inflight = max(req.inflight - rec["incr"][i], 0)
            if req.status != "running":
                continue
            prev_t = req.last_token_t
            k0 = len(events)
            row = toks[i]
            if windows is not None:
                row = self._spec.parse_emitted_row(row, windows)
            for t in row:
                t = int(t)
                if t == PAD_TOKEN:
                    break
                events.append(self._emit(req, t, now))
                if req.status != "running":
                    break
            k = len(events) - k0
            if windows is not None:
                d_cnt, a_cnt, s_cnt = (int(v) for v in sstats[i])
                req.spec_drafted += d_cnt
                req.spec_accepted += a_cnt
                req.spec_target_steps += s_cnt
                req.spec_emitted += k
                if o is not None:
                    o.spec_drained(d_cnt, a_cnt, s_cnt, k)
                    if req.status != "running" and req.spec_target_steps:
                        acc = req.spec_accepted / max(req.spec_drafted, 1)
                        tps = req.spec_emitted / req.spec_target_steps
                        o.lifecycle.point(
                            req.request_id,
                            f"spec[a={acc:.2f},t/s={tps:.1f}]", now)
            if o is not None and k:
                # one lifecycle span per request per drained block, to the
                # profiler only (per-block volume must not grow the
                # tracker's retained lists)
                o.lifecycle.span(req.request_id, "decode_block", rec["t0"],
                                 now, retain=False)
                if prev_t is not None:
                    # the block lands as a burst: spread its host-visible
                    # gap evenly over the k tokens it carried
                    per_tok = max(now - prev_t, 0.0) / k
                    for _ in range(k):
                        o.inter_token.observe(per_tok)
                    if self._slo is not None:
                        self._slo.decode_tokens(req.slo_class, per_tok, k)
        if windows is not None:
            # roll the worst-case page charge back to what was accepted;
            # the next block's charge tops it up again in schedule()
            for req in rec["reqs"]:
                if req.status == "running":
                    self.scheduler.revert_spec_pages(req)
        # decode wall time without double-counting overlapped block spans
        start = max(rec["t0"], self._last_drain_t)
        if o is not None:
            o.decode_seconds.inc(max(now - start, 0.0))
            o.step_phase["drain"].observe(now - t_in)
            o.device_residency.observe(max(now - rec["t0"], 0.0))
        if self._recorder is not None:
            self._recorder.record("drain", family=rec["kind"],
                                  rows=len(rec["reqs"]), tokens=len(events))
        self._last_drain_t = now
        return events

    # ------------------------------------------------------------- recovery
    def attach_journal(self, journal) -> None:
        """Attach the RequestJournal this engine appends to. Must happen
        before any request is added: a request the journal does not know
        cannot be recovered."""
        self._journal = journal

    def salvage(self) -> List[Tuple[int, int]]:
        """The supervisor's best-effort drain before a restart: surface
        what a still-answering device can deliver (spilled events plus the
        pending block) and journal it. Unlike the steady-state drain this
        never quarantines: a block the device cannot hand back is dropped,
        its tokens were never delivered, and the rebuilt engine recomputes
        them. Every row of the record gives back its in-flight bound
        whether or not the copy's event is reached. The injector's `drain`
        site is consulted, so chaos schedules can kill the salvage too."""
        events = list(self._spill)
        self._spill = []
        rec, self._pending = self._pending, None
        if rec is not None:
            toks = None
            try:
                if self._faults is not None:
                    self._faults.check("drain")
                toks = _pull(rec)
            except Exception:  # noqa: BLE001 (the device may be gone)
                self.fault_events += 1
            for i, req in enumerate(rec["reqs"]):
                req.inflight = max(req.inflight - rec["incr"][i], 0)
            if toks is not None:
                now = time.perf_counter()
                windows = rec.get("windows")
                if windows is not None:
                    toks = toks[:, :-3]
                for i, req in enumerate(rec["reqs"]):
                    if req.status != "running":
                        continue
                    row = toks[i]
                    if windows is not None:
                        row = self._spec.parse_emitted_row(row, windows)
                    for t in row:
                        t = int(t)
                        if t == PAD_TOKEN:
                            break
                        events.append(self._emit(req, t, now))
                        if req.status != "running":
                            break
        if self._journal is not None and events:
            self._journal_delivery(events)
        return events

    def release_pools(self) -> None:
        """Drop this engine's KV pools and any undrained block so that a
        replacement can allocate its own. The engine cannot serve after
        this; the supervisor calls it once `snapshot()` has returned."""
        self._pending = None
        self.cache.release()

    def snapshot(self):
        """Serializable boundary state of every request the journal holds
        live: original prompt, delivered tokens, sampling knobs and the
        effective seed, wall-clock deadlines and timestamps, and the draw
        index replayed from the delivered count (never the live
        `_draws`, which a lost spill can leave ahead of what was
        delivered). KV pages and the pending block are absent: restore
        re-prefills the fold instead. Needs an attached journal."""
        from .recovery import EngineSnapshot, RequestSnapshot, \
            replay_key_state

        if self._journal is None:
            raise RuntimeError(
                "snapshot() needs an attached journal: the journal is the "
                "source of truth for what each consumer was shown")
        snaps = []
        for rec in self._journal.live_records():
            live = self.requests.get(rec.request_id)
            snaps.append(RequestSnapshot(
                request_id=rec.request_id, prompt=list(rec.prompt),
                delivered=list(rec.delivered),
                max_new_tokens=rec.max_new_tokens,
                temperature=rec.temperature, top_k=rec.top_k,
                top_p=rec.top_p, seed=rec.seed,
                eos_token_id=rec.eos_token_id,
                deadline_wall=rec.deadline_wall,
                arrival_wall=rec.arrival_wall,
                first_token_wall=rec.first_token_wall,
                last_token_wall=rec.last_token_wall,
                preemptions=live.preemptions if live is not None else 0,
                parked=live.parked if live is not None else False,
                draws=replay_key_state(rec.seed, rec.key_splits
                                       + len(rec.delivered))))
        config = {
            "page_size": self.page_size,
            "max_batch_size": self.max_batch_size,
            "max_seq_len": self.max_seq_len,
            "decode_horizon": self.decode_horizon,
            "enable_chunked_prefill": self.enable_chunked_prefill,
            "enable_prefix_caching": self.prefix_cache is not None,
            # a record of the degree only: the journal's token record is
            # device-independent, so the snapshot restores at any degree
            "tp_size": self.tp_size,
        }
        return EngineSnapshot(config=config, requests=snaps,
                              taken_wall=time.time())

    def restore(self, snapshot, cancelled: Sequence[int] = ()) -> List[int]:
        """Rebuild request state on a FRESH engine from a snapshot. Each
        unfinished request is re-admitted in submission order under its
        ORIGINAL id as a folded prompt (original prompt + delivered
        tokens, as preemption folds), resuming at its draw index, so its
        continuation is the stream it would have produced. A request whose
        delivered stream already meets its stopping rule is rebuilt as
        finished; one in `cancelled` (cancelled while the restore was in
        flight) ends "cancelled"; one whose wall-clock deadline passed
        during the outage ends "expired", never resurrected. Returns the
        re-admitted request ids."""
        if self.requests:
            raise RuntimeError(
                "restore() needs a fresh engine: this one already holds "
                f"{len(self.requests)} requests")
        if snapshot.config.get("max_seq_len", self.max_seq_len) > \
                self.max_seq_len:
            raise ValueError(
                f"restore target's max_seq_len ({self.max_seq_len}) is "
                "smaller than the snapshot's "
                f"({snapshot.config['max_seq_len']}): folded prompts may "
                "not fit")
        if snapshot.requests:
            reserve_request_ids(max(r.request_id
                                    for r in snapshot.requests))
        cancelled = set(cancelled)
        now_wall = time.time()
        # the snapshot's wall-clock anchors on this process's perf_counter
        # timeline: deadlines keep counting down across the outage
        offset = time.perf_counter() - now_wall
        readmitted: List[int] = []
        for rs in snapshot.requests:
            rid = rs.request_id
            done = (len(rs.delivered) >= rs.max_new_tokens
                    or (rs.eos_token_id is not None and rs.delivered
                        and rs.delivered[-1] == rs.eos_token_id))
            sampling = SamplingParams(rs.temperature, rs.top_k, rs.top_p,
                                      rs.seed)
            self._seeds[rid] = int(rs.seed)
            self._draws[rid] = int(rs.draws)
            if done:
                # everything was delivered and only the `finished` record
                # was lost: rebuild, never recompute
                req = Request(prompt=list(rs.prompt),
                              max_new_tokens=rs.max_new_tokens,
                              sampling=sampling,
                              eos_token_id=rs.eos_token_id, request_id=rid)
                req.generated = list(rs.delivered)
                req.num_computed_tokens = len(rs.prompt)
                self._restore_times(req, rs, offset)
                req.finish_t = time.perf_counter()
                self.requests[rid] = req
                self.scheduler.finish(req)
                if self._journal is not None and self._journal.known(rid):
                    self._journal.terminal(rid, "finished")
                continue
            req = Request(prompt=list(rs.prompt) + list(rs.delivered),
                          max_new_tokens=(rs.max_new_tokens
                                          - len(rs.delivered)),
                          sampling=sampling, eos_token_id=rs.eos_token_id,
                          request_id=rid)
            req.preemptions = rs.preemptions
            req.parked = rs.parked
            self._restore_times(req, rs, offset)
            self.requests[rid] = req
            if rid in cancelled:
                # a cancel issued mid-restore wins over re-admission
                self._finalize(req, "cancelled")
                continue
            if rs.deadline_wall is not None:
                req.deadline_t = rs.deadline_wall + offset
                if now_wall >= rs.deadline_wall:
                    # the deadline passed during the outage
                    self._finalize(req, "expired")
                    continue
            self.scheduler.add(req, force=True)
            if req.deadline_t is not None:
                self._deadlined.add(rid)
            if self._obs is not None:
                self._obs.lifecycle.point(rid, "recovered")
            readmitted.append(rid)
        return readmitted

    @staticmethod
    def _restore_times(req: Request, rs, offset: float) -> None:
        req.arrival_t = rs.arrival_wall + offset
        if rs.first_token_wall is not None:
            req.first_token_t = rs.first_token_wall + offset
        if rs.last_token_wall is not None:
            req.last_token_t = rs.last_token_wall + offset

    def adopt_request(self, *, prompt: List[int],
                      delivered: Sequence[int] = (),
                      max_new_tokens: int,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, seed: int,
                      eos_token_id: Optional[int] = None,
                      deadline_wall: Optional[float] = None,
                      key_splits: int = 0,
                      request_id: Optional[int] = None,
                      slo_class: Optional[str] = None) -> int:
        """Re-admit another engine's in-flight request into this running
        engine (the single-request form of `restore()`): it enters as the
        folded prompt `prompt + delivered` with the remaining budget, at
        draw index `key_splits + len(delivered)`, so its continuation is
        the stream the other engine would have produced.
        `request_id=None` mints a fresh id; passing one keeps it
        (`reserve_request_ids` fences the counter either way). A journal
        that does not know the id gets the fold as a new submission
        carrying the accumulated draw count (`key_splits`). A
        `deadline_wall` already past finalizes the request "expired".
        Returns the id the request now runs under."""
        from .recovery import replay_key_state

        prompt = [int(t) for t in prompt]
        delivered = [int(t) for t in delivered]
        if not prompt:
            raise ValueError("empty prompt")
        if slo_class is not None and (
                self._slo is None or not self._slo.has_class(slo_class)):
            # a migrated request's class may not exist on the adopting
            # engine: the caller drops it rather than naming an unknown one
            raise ValueError(
                f"unknown SLO class {slo_class!r} on adopting engine")
        remaining = max_new_tokens - len(delivered)
        if remaining < 1:
            raise ValueError(
                f"nothing left to generate: {len(delivered)} of "
                f"{max_new_tokens} tokens already delivered")
        folded = prompt + delivered
        if len(folded) + remaining > self.max_seq_len:
            raise ValueError(
                f"folded prompt ({len(folded)}) + remaining budget "
                f"({remaining}) exceeds max_seq_len {self.max_seq_len}")
        if not self.enable_chunked_prefill \
                and len(folded) > self.prefill_buckets[-1]:
            raise ValueError(
                f"folded prompt length {len(folded)} exceeds the largest "
                f"prefill bucket {self.prefill_buckets[-1]}")
        if request_id is not None:
            if request_id in self.requests:
                raise ValueError(
                    f"request {request_id} already lives on this engine")
            reserve_request_ids(request_id)
        req = Request(prompt=folded, max_new_tokens=remaining,
                      sampling=SamplingParams(temperature, top_k, top_p,
                                              seed),
                      eos_token_id=eos_token_id, slo_class=slo_class,
                      **({"request_id": request_id}
                         if request_id is not None else {}))
        rid = req.request_id
        now_wall = time.time()
        offset = time.perf_counter() - now_wall
        expired = deadline_wall is not None and now_wall >= deadline_wall
        if not expired:
            # may raise on the page budget, before any registration; force
            # because an engine already admitted this request once
            self.scheduler.add(req, force=True)
        self.requests[rid] = req
        self._seeds[rid] = int(seed)
        self._draws[rid] = replay_key_state(seed,
                                            key_splits + len(delivered))
        if self._journal is not None and not self._journal.known(rid):
            self._journal.submit(
                request_id=rid, prompt=folded, max_new_tokens=remaining,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed, eos_token_id=eos_token_id,
                deadline_wall=deadline_wall, arrival_wall=now_wall,
                key_splits=key_splits + len(delivered))
        if deadline_wall is not None:
            req.deadline_t = deadline_wall + offset
            if expired:
                self._finalize(req, "expired")
                return rid
            self._deadlined.add(rid)
        if self._obs is not None:
            self._obs.lifecycle.point(rid, "adopted")
        if self._recorder is not None:
            self._recorder.record("adopt", rid=rid, delivered=len(delivered),
                                  remaining=remaining)
        return rid

    # -------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, object]:
        """Aggregate serving metrics, a thin view over the metrics
        registry. With `enable_metrics=False` the same shape comes back
        with the counters zeroed (request-derived fields stay filled)."""
        o = self._obs
        keys = ("prefill_steps", "prefill_chunks", "decode_steps",
                "ragged_steps", "dispatches", "tokens_generated",
                "host_syncs")
        if o is not None:
            s = {"prefill_steps": int(o.prefill_steps.value),
                 "prefill_chunks": int(o.prefill_chunks.value),
                 "decode_steps": int(o.decode_steps.value),
                 "ragged_steps": int(o.ragged_steps.value),
                 "dispatches": int(o.dispatches.value),
                 "tokens_generated": int(o.tokens.value),
                 "host_syncs": int(o.host_syncs.value),
                 "prefill_time_s": float(o.prefill_seconds.value),
                 "decode_time_s": float(o.decode_seconds.value),
                 "preemptions": int(o.preemptions.value)}
        else:
            s = dict.fromkeys(keys, 0)
            s.update(prefill_time_s=0.0, decode_time_s=0.0,
                     preemptions=sum(r.preemptions
                                     for r in self.requests.values()))
        dt = s["decode_time_s"]
        s["decode_tokens_per_s"] = (s["tokens_generated"] / dt
                                    if dt > 0 else 0.0)
        s["tokens_per_sync"] = (s["tokens_generated"] / s["host_syncs"]
                                if s["host_syncs"] else 0.0)
        s["decode_horizon"] = self.decode_horizon
        s["tp_size"] = self.tp_size
        if self._tp is not None:
            s["tp"] = dict(self._tp.describe(),
                           shard_pool_bytes=self.cache.shard_pool_bytes)
        s["kv_dtype"] = self.kv_dtype
        if self.cache.quantized:
            c = self.cache
            s["quant"] = {"kv_dtype": c.kv_dtype,
                          "pool_bytes": c.pool_bytes,
                          "page_bytes": c.page_bytes,
                          "fp32_pool_bytes": self._fp32_pool_bytes(),
                          "tp_quantized_allreduce":
                              self.tp_quantized_allreduce}
        s["num_requests"] = len(self.requests)
        s["num_finished"] = sum(r.status == "finished"
                                for r in self.requests.values())
        # resilience outcomes from request state, so the shape is the same
        # with metrics off (the registry keeps the same counts under
        # serving_requests_terminated_total{status=})
        term = dict.fromkeys(("cancelled", "expired", "failed", "shed"), 0)
        for r in self.requests.values():
            if r.status in term:
                term[r.status] += 1
        s["terminal"] = term
        s["transient_retries"] = (int(o.retries.value) if o is not None
                                  else 0)
        s["parked"] = sum(r.parked for r in self.requests.values())
        s["free_pages"] = self.cache.allocator.num_free
        empty = Histogram.empty_summary()
        if self.prefix_cache is not None:
            s["prefix_cache"] = self.prefix_cache.stats()
        if self.spec_config is not None:
            # from request state, so the shape is the same with metrics off
            reqs = self.requests.values()
            drafted = sum(r.spec_drafted for r in reqs)
            accepted = sum(r.spec_accepted for r in reqs)
            steps = sum(r.spec_target_steps for r in reqs)
            emitted = sum(r.spec_emitted for r in reqs)
            s["spec"] = {
                "lookahead": self.spec_config.lookahead,
                "method": self.spec_config.method,
                "drafted_tokens": drafted,
                "accepted_tokens": accepted,
                "wasted_tokens": drafted - accepted,
                "accept_rate": accepted / drafted if drafted else 0.0,
                "target_steps": steps,
                "tokens_per_target_step": (emitted / steps
                                           if steps else 0.0),
                "tokens_per_step": (o.spec_tokens_per_step.summary()
                                    if o is not None else empty),
            }
        s["latency"] = {
            "ttft": o.ttft.summary() if o is not None else empty,
            "inter_token": (o.inter_token.summary() if o is not None
                            else empty),
            "decode_stall": (o.decode_stall.summary() if o is not None
                             else empty),
        }
        s["step_breakdown"] = {
            phase: (o.step_phase[phase].summary() if o is not None
                    else empty)
            for phase in ("schedule", "assemble", "dispatch", "drain")}
        s["step_breakdown"]["device_residency"] = (
            o.device_residency.summary() if o is not None else empty)
        # SLO / goodput: per-class targets, windowed TTFT / TPOT percentiles
        # and attainment, and the all-class goodput counter beside the raw
        # tokens_generated
        if self._slo is not None:
            self._slo.refresh(advance=False)
            s["slo"] = self._slo.summary()
            s["goodput_tokens"] = self._slo.goodput_tokens
        else:
            s["slo"] = {}
            s["goodput_tokens"] = 0
        s["requests"] = {
            rid: {"ttft_s": (req.first_token_t - req.arrival_t
                             if req.first_token_t else None),
                  "latency_s": (req.finish_t - req.arrival_t
                                if req.finish_t else None),
                  "tokens": len(req.generated),
                  "preemptions": req.preemptions,
                  "status": req.status,
                  "slo_class": req.slo_class}
            for rid, req in self.requests.items()}
        return s

    # ------------------------------------------------------------ forensics
    def build_postmortem(self, reason: str,
                         info: Optional[Dict[str, object]] = None
                         ) -> Dict[str, object]:
        """Assemble (but do not write) a post-mortem bundle from this
        engine's recorder ring, metrics registry, request table and journal
        tail. Works with any subset of those attached."""
        return _build_bundle(reason, recorder=self._recorder,
                             registry=self.metrics,
                             requests=self.requests.values(),
                             journal=self._journal, info=info)

    def dump_postmortem(self, reason: str,
                        directory: Optional[str] = None,
                        info: Optional[Dict[str, object]] = None) -> str:
        """Build a bundle and write it to `directory` (default: the
        engine's `postmortem_dir`). Returns the path, also kept as
        `last_postmortem_path`."""
        directory = directory or self._postmortem_dir
        if directory is None:
            raise ValueError(
                "no directory: pass one or set postmortem_dir= on the "
                "engine")
        path = _dump_bundle(self.build_postmortem(reason, info=info),
                            directory)
        self.last_postmortem_path = path
        return path
