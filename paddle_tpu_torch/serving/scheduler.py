"""Continuous-batching scheduler, Orca-style iteration-level scheduling
(ported from paddle_tpu/serving/scheduler.py).

Policy, as in the reference:

- admission by free-page budget: a waiting request is admitted only when
  the pool can hold its whole prompt plus its first decode block, so a
  prefill never fails mid-flight;
- prefill priority, one request per step, padded to the smallest prompt
  bucket;
- decode batches every running request;
- copy-on-extend one decode BLOCK at a time: before a block, each running
  request is topped up to the block's worst-case page demand
  (`num_tokens + inflight` undrained upper bound), so no allocation is
  needed mid-block. On pool exhaustion the engine's pending block is
  drained once (`drain_hook`), then the YOUNGEST running request is
  preempted: its pages return to the free list and it re-queues at the
  front with prompt + generated tokens, to be re-prefilled later.
  Eviction costs recompute, never correctness;
- prefix caching (optional): admission first asks the PrefixCache for the
  longest cached full-page prefix of the prompt and charges the pool only
  for the UNCACHED suffix; pages are released through the refcounted
  allocator, so shared pages outlive any one request, and on pool pressure
  cached pages no sequence holds are evicted before anyone is preempted;
- speculative decoding (`spec_lookahead=L`): a decode block can emit up
  to `decode_horizon * (1 + L)` tokens a row, so every site that charged
  a block's pages charges that worst case, and `revert_spec_pages` hands
  the unaccepted tail back after the block drains;
- chunked prefill (`prefill_chunk_tokens=C`, Sarathi-Serve style): the
  prefill-XOR-decode policy is replaced by MIXED steps under a per-step
  token budget (`max_num_batched_tokens`). A prompt runs in page-aligned
  chunks of C tokens (after any cached prefix), tracked by the request's
  `num_computed_tokens` cursor; every step schedules ALL running decoders
  first, then as many chunks as the leftover budget allows, admitting
  several new requests a step when they fit. Pages are charged chunk by
  chunk: admission reserves only the first chunk, later chunks top the
  request up, and the final chunk reserves through the first decode
  block exactly like `_admission_pages`. With `ragged_steps` a step
  carrying chunk work is one flat kind="ragged" decision (one flat
  forward), otherwise kind="mixed" (decode block, then one call per
  chunk).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import List, Optional, Sequence

from .kv_cache import NULL_PAGE, BlockAllocator, pages_for
from .resilience import EngineOverloaded, InjectedFault, TERMINAL_STATUSES

__all__ = ["ChunkTask", "Request", "SamplingParams", "Scheduler",
           "ScheduleDecision", "reserve_request_ids"]

_REQUEST_IDS = itertools.count()


def reserve_request_ids(up_to: int) -> None:
    """Advance the global request-id counter past `up_to`. A restore
    rebuilds Requests with their ORIGINAL ids (stream consumers and the
    journal key on them), so a rebuilt engine must never hand a new
    request an id the snapshot already owns."""
    global _REQUEST_IDS
    nxt = next(_REQUEST_IDS)
    _REQUEST_IDS = itertools.count(max(nxt, up_to + 1))


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0            # 0.0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    """One generation request plus its serving-side bookkeeping."""

    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    eos_token_id: Optional[int] = None
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS))

    # waiting | running, then exactly one terminal status
    # (resilience.TERMINAL_STATUSES)
    status: str = "waiting"
    generated: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # absolute perf_counter deadline (arrival_t + deadline_s), or None.
    # Past it a waiting request expires before admission and a running one
    # at the next block boundary
    deadline_t: Optional[float] = None
    # set when status lands on "failed": the isolated failure, as text
    error: Optional[str] = None
    # preemption-storm guard tripped: requeued at the BACK of the queue
    parked: bool = False
    # upper bound on tokens sampled by a dispatched-but-undrained decode
    # block (the engine's async overlap): page demand must cover them
    inflight: int = 0
    # prompt tokens whose K/V came from the prefix cache (page-aligned);
    # prefill starts at this offset. pages[:cached_tokens // page_size]
    # are shared: the request holds a reference and never writes them
    cached_tokens: int = 0
    # prompt tokens whose K/V is resident: the cached prefix plus every
    # chunk dispatched so far (the engine advances it after a dispatch). A
    # request with
    # num_computed_tokens < len(prompt) is mid-prefill: it never joins the
    # decode batch, and its pages cover exactly its computed tokens
    num_computed_tokens: int = 0
    # SLO class name (observability/slo.py), or None when the request opted
    # out of SLO accounting. Validated by the engine at admission; the
    # scheduler never reads it, it rides along for the engine's latency
    # observation sites
    slo_class: Optional[str] = None
    # speculative decoding, filled by the engine's drain: draft tokens
    # verified / accepted, target-model passes that scored this row, and
    # tokens emitted by speculative blocks (all 0 with speculation off)
    spec_drafted: int = 0
    spec_accepted: int = 0
    spec_target_steps: int = 0
    spec_emitted: int = 0

    # metrics (perf_counter timestamps, filled by the engine)
    arrival_t: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    last_token_t: Optional[float] = None

    @property
    def num_tokens(self) -> int:
        """Tokens resident in the cache once prefilled + decoded so far."""
        return len(self.prompt) + len(self.generated)

    @property
    def next_pos(self) -> int:
        """Position the next decode token will occupy."""
        return self.num_tokens

    @property
    def prefill_done(self) -> bool:
        """The whole prompt's K/V is resident: the request can decode.
        Preemption folds generated tokens into the prompt and resets the
        cursor, so a requeued victim re-prefills from scratch."""
        return self.num_computed_tokens >= len(self.prompt)

    def is_done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and bool(self.generated)
                and self.generated[-1] == self.eos_token_id)


@dataclasses.dataclass
class ChunkTask:
    """One page-aligned prefill chunk of one request, scheduled into a
    mixed step: compute prompt[start : start+length] at offset `start`,
    attending over the request's earlier pages through its page table."""

    req: Request
    start: int
    length: int

    @property
    def is_final(self) -> bool:
        return self.start + self.length >= len(self.req.prompt)


@dataclasses.dataclass
class ScheduleDecision:
    # "prefill" | "decode" | "idle"; under chunked prefill "mixed" (decode
    # block plus chunks, one call each) or, with ragged steps, "ragged"
    # (the same rows as ONE flat step; chunk-free steps stay "decode").
    # `flat_tokens` is the flat token count before bucket padding.
    kind: str
    prefill: Optional[Request] = None
    decode: Sequence[Request] = ()
    chunks: Sequence[ChunkTask] = ()
    flat_tokens: int = 0


class Scheduler:
    def __init__(self, allocator: BlockAllocator, page_size: int,
                 max_batch_size: int, max_pages_per_seq: int,
                 prefix_cache=None, decode_horizon: int = 1,
                 drain_hook=None, obs=None, recorder=None,
                 max_waiting: Optional[int] = None,
                 max_preemptions: Optional[int] = None,
                 max_prefill_tokens: Optional[int] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 max_num_batched_tokens: Optional[int] = None,
                 ragged_steps: bool = False,
                 spec_lookahead: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        self.max_batch_size = max_batch_size
        self.max_pages_per_seq = max_pages_per_seq
        self.prefix_cache = prefix_cache
        self.decode_horizon = max(int(decode_horizon), 1)
        # a decode block emits up to block_tokens tokens a row: the worst
        # case every page charge covers (decode_horizon with speculation
        # off), reverted to what was accepted after each drain
        self.spec_lookahead = max(int(spec_lookahead), 0)
        self.block_tokens = self.decode_horizon * (1 + self.spec_lookahead)
        # bounded waiting queue: add() past this raises EngineOverloaded
        self.max_waiting = max_waiting
        # a victim preempted more than this many times is parked
        # (requeued at the back) instead of jumping the line again
        self.max_preemptions = max_preemptions
        # largest prompt the engine can prefill (its biggest bucket; None
        # under chunked prefill, which takes any length)
        self.max_prefill_tokens = max_prefill_tokens
        # chunked prefill: None = prefill-XOR-decode; an int C (a positive
        # multiple of page_size, validated by the engine) = mixed steps
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # per-step token budget of mixed steps: each running decoder
        # charges block_tokens, each chunk the full chunk width
        self.max_num_batched_tokens = max_num_batched_tokens
        # steps with chunk work come back as ONE kind="ragged" decision
        self.ragged_steps = bool(ragged_steps)
        # called once per _ensure_decode_pages on pool exhaustion, before
        # any preemption: the engine drains its in-flight decode block
        self.drain_hook = drain_hook
        # the engine's ServingObs: lifecycle points at every queue
        # transition, the preemption / terminal counters, queue gauges
        self.obs = obs
        # the engine's FlightRecorder: terminal and preempt records. None
        # = the scheduler executes no recorder code at all
        self.recorder = recorder
        self.waiting: List[Request] = []
        self.running: List[Request] = []

    # ------------------------------------------------------------ lifecycle
    def add(self, req: Request, force: bool = False) -> None:
        """Enqueue `req`. `force=True` bypasses the bounded-queue check:
        a restore re-admits requests the engine already accepted once, and
        bouncing them off `max_waiting` would turn a restart into
        shedding."""
        need = pages_for(len(req.prompt) + req.max_new_tokens,
                         self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_seq "
                f"{self.max_pages_per_seq}; raise max_seq_len/page budget")
        if not force and self.max_waiting is not None and \
                len(self.waiting) >= self.max_waiting:
            raise EngineOverloaded(
                f"waiting queue is full ({len(self.waiting)} >= "
                f"max_waiting={self.max_waiting}); retry later")
        self.waiting.append(req)
        if self.obs is not None:
            self.obs.enqueued(req)

    def finish(self, req: Request) -> None:
        """Drop a completed request's page references; a shared page
        returns to the pool once no other sequence (and no cached prefix)
        holds it."""
        req.status = "finished"
        self.allocator.free_all(req.pages)
        req.pages = []
        if req in self.running:
            self.running.remove(req)
        if self.obs is not None:
            self.obs.finished(req)
        if self.recorder is not None:
            self.recorder.record("terminal", rid=req.request_id,
                                 status="finished",
                                 generated=len(req.generated))

    def finalize(self, req: Request, status: str,
                 error: Optional[str] = None) -> bool:
        """Terminal transition for the failure-side statuses (cancelled /
        expired / failed / shed): pull the request out of its queue and
        release its pages through the refcounted path, so a shared prefix
        page only loses THIS request's reference. Idempotent: a request
        already terminal is left alone (returns False). The engine drains
        any in-flight decode block first."""
        if req.status in TERMINAL_STATUSES:
            return False
        if status not in TERMINAL_STATUSES or status == "finished":
            raise ValueError(f"finalize cannot set status {status!r}")
        req.status = status
        req.error = error
        req.inflight = 0
        req.finish_t = time.perf_counter()
        self.allocator.free_all(req.pages)
        req.pages = []
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        if self.obs is not None:
            self.obs.terminal(req, status)
        if self.recorder is not None:
            self.recorder.record("terminal", rid=req.request_id,
                                 status=status, error=error)
        return True

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------- policy
    def _admission_pages(self, req: Request) -> int:
        # prompt + the first decode BLOCK: prefill writes the prompt, and
        # the first block writes K/V at positions prompt .. prompt +
        # min(block_tokens, max_new-1) - 1 (block_tokens is the horizon,
        # times 1 + lookahead under speculation)
        first_block = max(1, min(self.block_tokens,
                                 req.max_new_tokens - 1))
        return pages_for(len(req.prompt) + first_block, self.page_size)

    def _block_pages(self, req: Request) -> int:
        """Pages the NEXT decode block needs resident for `req`: host
        state plus the undrained in-flight bound, advanced by one block of
        writes (the block's last sampled token never gets K/V written in
        it, hence the -1)."""
        assumed = req.num_tokens + req.inflight
        rem = max(req.max_new_tokens - len(req.generated) - req.inflight,
                  0)
        want = max(assumed - 1 + min(self.block_tokens, rem),
                   req.num_tokens)
        return pages_for(want, self.page_size)

    def revert_spec_pages(self, req: Request) -> int:
        """Roll a speculative block's WORST-CASE page charge back to what
        its drain accepted: host state (`num_tokens`) plus any undrained
        in-flight bound is the truth, and tail pages past it return to the
        pool. The popped tail is never a shared prefix page: those cover
        at most cached_tokens <= len(prompt) <= num_tokens tokens, and the
        kept count never drops below pages_for(num_tokens) nor the
        chunked-prefill cursor's charge. Returns the pages released."""
        keep = max(
            pages_for(req.num_tokens + req.inflight, self.page_size),
            pages_for(req.num_computed_tokens, self.page_size))
        freed = 0
        while len(req.pages) > keep:
            self.allocator.free(req.pages.pop())
            freed += 1
        return freed

    def _alloc_n(self, n: int) -> Optional[List[int]]:
        """All-or-nothing alloc that evicts cached pages no sequence holds
        before reporting exhaustion. An injected alloc fault degrades to
        the exhausted path: admission defers a step, which loses
        nothing."""
        try:
            pages = self.allocator.alloc_n(n)
            if pages is None and self.prefix_cache is not None:
                self.prefix_cache.evict(n - self.allocator.num_free)
                pages = self.allocator.alloc_n(n)
        except InjectedFault:
            return None
        return pages

    def _alloc_one(self) -> Optional[int]:
        try:
            page = self.allocator.alloc()
            if page is None and self.prefix_cache is not None \
                    and self.prefix_cache.evict(1):
                page = self.allocator.alloc()
        except InjectedFault:
            return None
        return page

    def _match(self, req: Request) -> List[int]:
        """The cached full-page prefix of `req`'s prompt (one reference a
        page, owned by the caller), or [] without a prefix cache. An
        injected lookup fault degrades to a miss: the request prefills its
        whole prompt, with the same stream either way."""
        if self.prefix_cache is None:
            return []
        try:
            return self.prefix_cache.match(req.prompt)
        except InjectedFault:
            return []

    def _admit(self, req: Request, cached: List[int],
               pages: List[int]) -> Request:
        self.waiting.pop(0)
        req.pages = cached + pages
        req.cached_tokens = len(cached) * self.page_size
        # the engine advances the cursor past the prompt once the prefill
        # (or each chunk) dispatch succeeds
        req.num_computed_tokens = req.cached_tokens
        if self.prefix_cache is not None:
            self.prefix_cache.record(len(req.prompt), req.cached_tokens)
        req.status = "running"
        self.running.append(req)
        if self.obs is not None:
            self.obs.admitted(req)
        return req

    def _try_admit(self) -> Optional[Request]:
        if not self.waiting or len(self.running) >= self.max_batch_size:
            return None
        req = self.waiting[0]
        # the pool is charged only for the uncached suffix
        cached = self._match(req)
        pages = self._alloc_n(self._admission_pages(req) - len(cached))
        if pages is None:
            # pool exhausted. Drop the match references FIRST (they pin
            # exactly the pages whose eviction could let a request
            # through), then retry once without the cache
            self.allocator.free_all(cached)
            if cached:
                cached = []
                pages = self._alloc_n(self._admission_pages(req))
            if pages is None:
                return None
        return self._admit(req, cached, pages)

    def _preempt(self, victim: Request) -> None:
        """Evict a running request and requeue it at the FRONT of the
        waiting queue with its generated tokens folded into the prompt
        (re-prefill resumes it exactly). Shared prefix pages only lose
        the victim's reference. Past `max_preemptions` it is parked at the
        BACK instead."""
        folded = len(victim.prompt) + len(victim.generated)
        if self.max_prefill_tokens is not None \
                and folded > self.max_prefill_tokens:
            raise RuntimeError(
                f"cannot preempt request {victim.request_id}: its folded "
                f"prompt+generated length {folded} exceeds the largest "
                f"prefill bucket ({self.max_prefill_tokens} tokens) — "
                "re-prefill after requeue would be impossible. "
                "prefill_buckets must cover max_seq_len")
        self.running.remove(victim)
        self.allocator.free_all(victim.pages)
        victim.pages = []
        victim.cached_tokens = 0
        victim.num_computed_tokens = 0   # re-prefill from scratch
        victim.inflight = 0     # drain_hook ran first: nothing undrained
        victim.prompt = victim.prompt + victim.generated
        victim.max_new_tokens -= len(victim.generated)
        victim.generated = []
        victim.status = "waiting"
        victim.preemptions += 1
        if self.max_preemptions is not None \
                and victim.preemptions > self.max_preemptions:
            victim.parked = True
            self.waiting.append(victim)
            if self.obs is not None:
                self.obs.parked(victim)
        else:
            self.waiting.insert(0, victim)
        if self.obs is not None:
            self.obs.preempted(victim)
        if self.recorder is not None:
            self.recorder.record("preempt", rid=victim.request_id,
                                 parked=victim.parked,
                                 preemptions=victim.preemptions)

    def _ensure_decode_pages(self) -> None:
        """Copy-on-extend, one decode BLOCK at a time (see module doc)."""
        drained = False
        for req in list(self.running):
            if req not in self.running:   # preempted by an older peer
                continue
            if self.prefill_chunk_tokens is not None \
                    and not req.prefill_done:
                # mid-prefill under chunking: the request does not decode
                # this step, and _block_pages would charge its WHOLE
                # prompt; its pages are charged chunk by chunk instead
                continue
            while req in self.running and \
                    self._block_pages(req) > len(req.pages):
                page = self._alloc_one()
                if page is not None:
                    req.pages.append(page)
                    continue
                if self.drain_hook is not None and not drained:
                    drained = True
                    self.drain_hook()     # may finish reqs / free pages
                    continue
                victim = self.running[-1]
                if victim is req and len(self.running) == 1:
                    raise RuntimeError(
                        "KV page pool too small for a single request: "
                        f"request {req.request_id} at position "
                        f"{req.next_pos} with "
                        f"{self.allocator.num_allocatable} "
                        "allocatable pages in total")
                self._preempt(victim)
                if victim is req:         # self-preempted: sit this one out
                    break

    def schedule(self) -> ScheduleDecision:
        if self.obs is not None:
            self.obs.sample_queues(len(self.waiting), len(self.running),
                                   self.allocator)
        if self.prefill_chunk_tokens is not None:
            return self._schedule_chunked()
        admitted = self._try_admit()
        if admitted is not None:
            return ScheduleDecision(kind="prefill", prefill=admitted)
        if self.running:
            self._ensure_decode_pages()
            batch = self.running[:self.max_batch_size]
            return ScheduleDecision(kind="decode", decode=list(batch))
        self._check_head_fits()
        return ScheduleDecision(kind="idle")

    def _check_head_fits(self) -> None:
        """About to go idle with requests still waiting: if nothing runs
        and the head request cannot fit even in an EMPTY pool, raise now
        instead of idling forever."""
        if self.running or not self.waiting:
            return
        req = self.waiting[0]
        need = self._admission_pages(req)
        if need > self.allocator.num_allocatable:
            raise RuntimeError(
                f"request {req.request_id} needs {need} pages but "
                f"the pool has {self.allocator.num_allocatable} "
                "allocatable in total")

    # ------------------------------------------------------ chunked prefill
    def _schedule_chunked(self) -> ScheduleDecision:
        """Mixed-step assembly under the per-step token budget: ALL
        running decoders first (a decode step is never skipped because
        prefill work exists), then prefill chunks from the leftover
        budget: partially prefilled running requests oldest first, then
        NEW admissions while batch slots and budget last."""
        budget = self.max_num_batched_tokens
        chunk = self.prefill_chunk_tokens
        decode: List[Request] = []
        if any(r.prefill_done for r in self.running):
            self._ensure_decode_pages()      # may drain and/or preempt
            decode = [r for r in self.running
                      if r.prefill_done][:self.max_batch_size]
            budget -= self.block_tokens * len(decode)
        chunks: List[ChunkTask] = []
        for req in list(self.running):
            if budget < chunk:
                break
            if req not in self.running or req.prefill_done:
                continue
            task = self._next_chunk(req)
            if task is not None:
                chunks.append(task)
                budget -= chunk
        while (budget >= chunk and self.waiting
               and len(self.running) < self.max_batch_size):
            req = self._admit_chunked()
            if req is None:
                break
            task = self._next_chunk(req)
            if task is None:      # admission just paid for this chunk
                break
            chunks.append(task)
            budget -= chunk
        # chunk-page reservation may have preempted a request already
        # picked for this step's decode batch (or holding a chunk): keep
        # only entries still running (the engine also drops a task whose
        # start no longer matches its request's cursor)
        decode = [r for r in decode
                  if r.status == "running" and r.prefill_done]
        chunks = [t for t in chunks if t.req.status == "running"]
        flat = len(decode) + sum(t.length for t in chunks)
        if self.ragged_steps:
            if chunks:
                return ScheduleDecision(kind="ragged", decode=decode,
                                        chunks=chunks, flat_tokens=flat)
            if decode:
                return ScheduleDecision(kind="decode", decode=decode)
        elif decode or chunks:
            return ScheduleDecision(kind="mixed", decode=decode,
                                    chunks=chunks, flat_tokens=flat)
        self._check_head_fits()
        return ScheduleDecision(kind="idle")

    def _chunk_pages_needed(self, req: Request, end: int) -> int:
        """Pages `req` must hold once its prompt is computed up to `end`:
        the final chunk reserves through the first decode block (as
        `_admission_pages`); earlier chunks exactly their computed
        tokens."""
        if end >= len(req.prompt):
            return self._admission_pages(req)
        return pages_for(end, self.page_size)

    def _admit_chunked(self) -> Optional[Request]:
        """Admission under chunking: charge the pool for the FIRST chunk
        after the cached prefix only, not the whole prompt; on exhaustion
        drop the match references and retry once without the cache, as
        `_try_admit` does."""
        req = self.waiting[0]
        cached = self._match(req)
        start = len(cached) * self.page_size
        need = self._chunk_pages_needed(
            req, min(start + self.prefill_chunk_tokens, len(req.prompt)))
        pages = self._alloc_n(need - len(cached))
        if pages is None:
            self.allocator.free_all(cached)
            if cached:
                cached = []
                need = self._chunk_pages_needed(
                    req, min(self.prefill_chunk_tokens, len(req.prompt)))
                pages = self._alloc_n(need)
            if pages is None:
                return None
        return self._admit(req, cached, pages)

    def _next_chunk(self, req: Request) -> Optional[ChunkTask]:
        """The next chunk of a mid-prefill request with its pages
        reserved, or None when the pool cannot cover it this step (the
        request keeps its pages and waits)."""
        start = req.num_computed_tokens
        n = min(self.prefill_chunk_tokens, len(req.prompt) - start)
        if n <= 0:
            return None
        if not self._reserve_chunk_pages(
                req, self._chunk_pages_needed(req, start + n)):
            return None
        return ChunkTask(req=req, start=start, length=n)

    def _reserve_chunk_pages(self, req: Request, need: int) -> bool:
        """Top `req` up to `need` pages: drain the pending block once (may
        free pages), then preempt the YOUNGEST running request - never
        `req` itself: if it is the youngest it sits the step out, unless
        it is alone and over the pool's whole capacity."""
        drained = False
        while need > len(req.pages) and req in self.running:
            pages = self._alloc_n(need - len(req.pages))
            if pages is not None:
                req.pages.extend(pages)
                return True
            if self.drain_hook is not None and not drained:
                drained = True
                self.drain_hook()     # may finish reqs / free pages
                continue
            victim = self.running[-1]
            if victim is req:
                if len(self.running) == 1 \
                        and need > self.allocator.num_allocatable:
                    raise RuntimeError(
                        "KV page pool too small for a single request: "
                        f"request {req.request_id} needs {need} pages "
                        f"with {self.allocator.num_allocatable} "
                        "allocatable pages in total")
                return False
            self._preempt(victim)
        return req in self.running and len(req.pages) >= need

    # ----------------------------------------------------------- invariants
    def check_consistency(self) -> bool:
        """Scheduler + allocator invariant audit: queues disjoint with
        matching statuses, every running request's pages live (never the
        null page), waiting requests holding none, and the prefix cache's
        tree sound. Raises RuntimeError on the first violation."""
        self.allocator.check_consistency()
        if self.prefix_cache is not None:
            self.prefix_cache.check_consistency()
        if set(map(id, self.waiting)) & set(map(id, self.running)):
            raise RuntimeError("scheduler corrupt: request in both "
                               "waiting and running queues")
        for req in self.running:
            if req.status != "running":
                raise RuntimeError(
                    f"scheduler corrupt: request {req.request_id} in the "
                    f"running queue with status {req.status!r}")
            if self.prefill_chunk_tokens is not None and (
                    req.num_computed_tokens > len(req.prompt)
                    or pages_for(req.num_computed_tokens, self.page_size)
                    > len(req.pages)):
                raise RuntimeError(
                    f"scheduler corrupt: request {req.request_id} computed "
                    f"{req.num_computed_tokens} of {len(req.prompt)} prompt "
                    f"tokens and holds {len(req.pages)} pages")
            for p in req.pages:
                if p == NULL_PAGE:
                    raise RuntimeError(
                        f"scheduler corrupt: request {req.request_id} "
                        "holds the null page")
                if self.allocator.ref_count(p) < 1:
                    raise RuntimeError(
                        f"scheduler corrupt: request {req.request_id} "
                        f"holds freed page {p}")
        for req in self.waiting:
            if req.status != "waiting":
                raise RuntimeError(
                    f"scheduler corrupt: request {req.request_id} in the "
                    f"waiting queue with status {req.status!r}")
            if req.pages:
                raise RuntimeError(
                    f"scheduler corrupt: waiting request "
                    f"{req.request_id} holds pages {req.pages}")
        return True
