"""Replicated serving: N supervised engines behind one front door (the
port's own copy of paddle_tpu/serving/cluster.py).

`ServingEngine` isolates failures and `EngineSupervisor` makes the engine
itself replaceable (journal, snapshot, rebuild, exactly-once delivery).
But one engine is still one blast radius and one queue — the operability
tier that systems like vLLM and Orca assume exists ABOVE the engine (many
workers, any of which may die, behind one job-level API) is this module. `ServingCluster` owns N
`EngineSupervisor`-wrapped replicas and presents the single-engine API
(`add_request` / `cancel` / `status` / `output` / `step` / `stream` /
`run` / `stats`) so existing callers are drop-in. Three pillars:

- **Router** — load-aware placement over the replicas that accept new
  work: candidates are ordered healthy-before-degraded, then by a load
  score combining waiting-queue depth (dominant), in-flight decode
  budget, and KV page pressure. With `prefix_affinity=True` the router
  first steers a request toward the replica already holding its longest
  full-page prompt prefix: a live `PrefixCache` is probed read-only
  (`peek` — no refs, no LRU ticks), and an LRU table of prefix-hash →
  replica covers engines without prefix caching. A replica raising
  `EngineOverloaded` at admission spills the request to the next
  candidate; only when EVERY candidate is full does the overload reach
  the caller.

- **Health + failover** — per-replica `healthy | degraded | draining |
  dead`, driven by the supervisor's own signals: a restart (watchdog,
  fault storm, fatal fault) or `degrade_after_faults` engine faults
  inside `degrade_window_steps` marks a replica degraded; it heals
  after `degrade_recovery_steps` clean steps. `drain(i)` stops
  placement while in-flight work finishes; `resume(i)` re-enables.
  When a supervisor exhausts `max_restarts` it raises `EngineDead` —
  the cluster catches it mid-`step`, and MIGRATES: every journal-live
  request of the dead replica is re-admitted on the best survivor
  through `ServingEngine.adopt_request` as a folded prompt (original
  prompt + delivered tokens, resuming at draw index `len(delivered)`,
  original request id preserved via `reserve_request_ids`), so the
  consumer's token stream continues exactly-once — delivered tokens are
  never re-delivered, undelivered ones are recomputed. On the CPU in
  fp32 the continuation is bit-identical; in bf16 on the card the fold's
  re-prefill rounds otherwise than the decode steps it replaces.

- **Cluster resilience policy** — `max_dead_replicas` bounds how many
  replicas may die before the cluster itself raises `EngineDead`;
  `hedge_after_s` re-dispatches a request stuck on a degraded replica
  as a clone on another replica (both race; streams are bit-identical
  by construction, so the first copy to produce a NEW token wins and
  the loser is cancelled through its journal — the consumer sees one
  stream); `chaos_seed=` derives one deterministic `FaultInjector` per
  replica from a single seed (sha512-stable, like the injector's own
  per-site streams) for kill-anything cluster chaos tests.

What migration preserves: the token stream (bit-identical, greedy and
seeded-stochastic), the request id, the remaining budget, the absolute
wall-clock deadline, exactly-once delivery. What it does not: KV pages
(the fold re-prefills on the survivor — cost is a re-prefill, never a
re-decode), engine-local latency state (TTFT on the dead replica is
journal history, not carried), and queue position (migrated requests
re-enter admission like restore()'s re-admissions, ahead of the
bounded-queue check).

Replicas share nothing but what the factory gives them: a factory may
close over ONE model, so N replicas hold one copy of the weights and N
KV pools; a dead replica frees its own pools (`release_pools`) and never
the shared weights. Tensor-parallel replicas (`tp_size>1`): the device
list (`devices=`, default every card of the process) is sorted and carved
into `num_replicas` disjoint tp-wide groups (`parallel.mesh.
carve_submeshes`; a list may repeat one card, so one H100 can hold every
group), and the factory, which must take `tp_size=` and `devices=`, gets
its replica's group. A replica's journal is device-independent, so a dead
tp=2 replica's requests migrate onto a tp=1 survivor. `devices=` is
resolved whatever the degree (a CUDA name raises on a machine without a
card); at tp_size=1 it carves nothing, as in the reference.

Zero cost when unused: a plain `ServingEngine` (or a bare supervisor)
executes none of this module — tests pin that with a raise-on-touch
guard over every cluster entry point.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import numpy as np

from ..device import resolve_device
from ..observability import MetricsRegistry
from ..profiler import add_host_span
from .recovery import EngineSupervisor, RequestJournal
from .resilience import EngineDead, EngineOverloaded, FaultInjector, \
    TERMINAL_STATUSES

__all__ = ["ClusterRequest", "ReplicaHandle", "ServingCluster"]

HEALTH_STATES = ("healthy", "degraded", "draining", "dead")
_HEALTH_CODE = {s: i for i, s in enumerate(HEALTH_STATES)}


@dataclasses.dataclass
class _Copy:
    """One engine-level incarnation of a cluster request: the primary,
    a migrated re-admission, or a hedge clone. `base` is how many
    cluster-delivered tokens were folded into this copy's prompt;
    `emitted` counts tokens the copy has produced since, so the copy's
    i-th token is absolute stream position `base + emitted`."""

    replica: int
    base: int
    emitted: int = 0


@dataclasses.dataclass
class ClusterRequest:
    """Cluster-level view of one request: the consumer-visible stream
    (`delivered`), the submission metadata every copy is folded from,
    and which engine-level copies currently carry it."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_token_id: Optional[int]
    deadline_wall: Optional[float]
    arrival_wall: float
    delivered: List[int] = dataclasses.field(default_factory=list)
    status: Optional[str] = None      # terminal status, None while live
    error: Optional[str] = None
    replica: int = -1                 # current owner replica index
    copies: Dict[int, _Copy] = dataclasses.field(default_factory=dict)
    placed_t: float = 0.0
    last_progress_t: float = 0.0
    migrations: int = 0
    hedges: int = 0
    # SLO class the request opted into (observability/slo.py); every copy
    # is adopted under it, so goodput follows the request across replicas
    slo_class: Optional[str] = None

    @property
    def live(self) -> bool:
        return self.status is None


class ReplicaHandle:
    """One replica's cluster-side bookkeeping: the supervisor, its
    (optional) chaos injector, and the health state machine's inputs —
    restart/fault watermarks and the clean-step recovery counter."""

    def __init__(self, index: int, supervisor: EngineSupervisor,
                 injector: Optional[FaultInjector],
                 fault_window_steps: int):
        self.index = index
        self.supervisor = supervisor
        self.injector = injector
        self.health = "healthy"
        self.seen_restarts = 0
        self.last_fault_events = 0
        self.fault_window: deque = deque(maxlen=max(fault_window_steps, 1))
        self.clean_steps = 0

    @property
    def journal(self) -> RequestJournal:
        return self.supervisor.journal

    def __repr__(self) -> str:
        return f"ReplicaHandle(r{self.index}, {self.health})"


class ServingCluster:
    """N supervised `ServingEngine` replicas behind the single-engine
    API — see the module docstring for the router / health / policy
    design. `factory` builds one engine; it may be zero-arg, or accept
    `replica=` (the replica index) and/or `fault_injector=` keyword
    arguments — the cluster passes whichever the signature admits, and
    the per-replica supervisor reuses the same closure for rebuilds, so
    an injector's call counts span engine incarnations exactly like the
    single-supervisor chaos tests.

    `placement` is `"load"` (default: healthy-first, then the load
    score) or `"round_robin"` (ignore load; still healthy-first).
    `prefix_affinity` steers shared-prefix requests onto the replica
    whose cache holds the prefix. `hedge_after_s=None` disables
    hedging. `max_dead_replicas` defaults to `num_replicas - 1`: the
    cluster survives anything short of losing every replica.
    `postmortem_dir` receives each dead replica's post-mortem bundle.
    """

    def __init__(self, factory: Callable[..., object], *,
                 num_replicas: int = 2,
                 placement: str = "load",
                 prefix_affinity: bool = True,
                 hedge_after_s: Optional[float] = None,
                 max_dead_replicas: Optional[int] = None,
                 degrade_after_faults: int = 3,
                 degrade_window_steps: int = 32,
                 degrade_recovery_steps: int = 16,
                 affinity_table_size: int = 4096,
                 metrics: Optional[MetricsRegistry] = None,
                 enable_metrics: bool = True,
                 supervisor_kw: Optional[dict] = None,
                 fault_injectors: Optional[Sequence[FaultInjector]] = None,
                 chaos_seed: Optional[int] = None,
                 journal_paths: Optional[Sequence[str]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 tp_size: int = 1,
                 devices: Optional[Sequence] = None,
                 postmortem_dir: Optional[str] = None):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if placement not in ("load", "round_robin"):
            raise ValueError(
                f"unknown placement {placement!r}; "
                "one of ('load', 'round_robin')")
        if fault_injectors is not None \
                and len(fault_injectors) != num_replicas:
            raise ValueError(
                f"fault_injectors has {len(fault_injectors)} entries "
                f"for {num_replicas} replicas")
        if journal_paths is not None \
                and len(journal_paths) != num_replicas:
            raise ValueError(
                f"journal_paths has {len(journal_paths)} entries "
                f"for {num_replicas} replicas")
        self.num_replicas = num_replicas
        self.placement = placement
        self.prefix_affinity = bool(prefix_affinity)
        self.hedge_after_s = hedge_after_s
        self.max_dead_replicas = (num_replicas - 1
                                  if max_dead_replicas is None
                                  else int(max_dead_replicas))
        self.degrade_after_faults = int(degrade_after_faults)
        self.degrade_recovery_steps = int(degrade_recovery_steps)
        self._clock = clock
        if fault_injectors is None and chaos_seed is not None:
            fault_injectors = self.chaos_injectors(chaos_seed,
                                                   num_replicas)
        self.fault_injectors = (list(fault_injectors)
                                if fault_injectors is not None else None)
        self.metrics = metrics if metrics is not None else (
            MetricsRegistry() if enable_metrics else None)
        self._init_metrics()
        # tensor parallelism: carve the sorted device list into disjoint
        # tp-wide groups, replica i getting entries [i*tp, (i+1)*tp); a
        # tp_size=1 cluster imports and carves nothing
        self.tp_size = int(tp_size)
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {tp_size}")
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
        self._replica_devices: Optional[List[tuple]] = None
        if self.tp_size > 1:
            from ..parallel.mesh import carve_submeshes

            self._replica_devices = carve_submeshes(
                num_replicas, self.tp_size, devices)
        # factory protocol: pass only what the signature admits
        params = inspect.signature(factory).parameters
        varkw = any(p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
        self._factory_kw = {
            "replica": varkw or "replica" in params,
            "fault_injector": varkw or "fault_injector" in params,
            "tp_size": varkw or "tp_size" in params,
            "devices": varkw or "devices" in params,
        }
        if self.tp_size > 1 and not (self._factory_kw["tp_size"]
                                     and self._factory_kw["devices"]):
            raise ValueError(
                "ServingCluster(tp_size>1) needs a factory that accepts "
                "tp_size= and devices= keywords (or **kwargs) so each "
                "replica's engine lands on its carved group")
        self._factory = factory
        sup_kw = dict(supervisor_kw or {})
        self.replicas: List[ReplicaHandle] = []
        for i in range(num_replicas):
            journal = RequestJournal(journal_paths[i]
                                     if journal_paths is not None
                                     else None)
            sup = EngineSupervisor(
                self._engine_factory(i), journal=journal,
                metrics=self.metrics, **sup_kw)
            self.replicas.append(ReplicaHandle(
                i, sup,
                (self.fault_injectors[i]
                 if self.fault_injectors is not None else None),
                degrade_window_steps))
        # consumer-facing request table + engine-rid -> consumer-rid
        # aliases (hedge clones / re-minted migrations); alias entries
        # outlive their copies so a cancelled loser's late-drained
        # tokens still resolve (and are dropped) instead of leaking
        # through as a phantom request
        self._records: Dict[int, ClusterRequest] = {}
        self._alias: Dict[int, int] = {}
        # prefix-hash -> replica affinity table (LRU-capped), used for
        # replicas without a live PrefixCache to probe
        self._affinity: "OrderedDict[str, int]" = OrderedDict()
        self._affinity_cap = int(affinity_table_size)
        self._page_size = int(
            self.replicas[0].supervisor.engine.page_size)
        self._rr = 0                   # round-robin cursor
        self._step_count = 0
        self.dead_replicas = 0
        # forensics: replica deaths dump a post-mortem bundle
        # here — the supervisor's bundle refreshed with the migration
        # events the cluster appended to the dead engine's ring. None =
        # bundles stay in memory (rep.supervisor.postmortem).
        self.postmortem_dir = postmortem_dir
        self.postmortem_paths: List[str] = []

    # ------------------------------------------------------------ metrics
    def _init_metrics(self) -> None:
        m = self.metrics
        if m is None:
            self._m_routed = self._m_aff_hit = self._m_aff_miss = None
            self._m_spill = self._m_shed = self._m_migrations = None
            self._m_migrated_tokens = self._m_migration_s = None
            self._m_hedges = self._m_hedge_cancels = None
            self._m_deaths = self._m_health = None
            self._m_free_pages = self._m_queue_depth = None
            return
        n = self.num_replicas

        def per_replica(cls, name, help):
            return [cls(name, help, labels={"replica": str(i)})
                    for i in range(n)]

        self._m_routed = per_replica(
            m.counter, "serving_cluster_requests_routed_total",
            "requests placed, by replica")
        self._m_aff_hit = m.counter(
            "serving_cluster_affinity_hits_total",
            "placements steered to a replica holding the prefix")
        self._m_aff_miss = m.counter(
            "serving_cluster_affinity_misses_total",
            "placements with no cached prefix anywhere")
        self._m_spill = m.counter(
            "serving_cluster_spillovers_total",
            "admissions retried on another replica after "
            "EngineOverloaded")
        self._m_shed = m.counter(
            "serving_cluster_shed_total",
            "admissions refused by every placeable replica")
        self._m_migrations = m.counter(
            "serving_cluster_migrations_total",
            "requests re-admitted on a survivor after replica death")
        self._m_migrated_tokens = m.counter(
            "serving_cluster_migrated_tokens_total",
            "folded prompt+delivered tokens re-prefilled by migrations")
        self._m_migration_s = m.histogram(
            "serving_cluster_migration_seconds",
            "journal-replay + re-admission wall time per dead replica")
        self._m_hedges = m.counter(
            "serving_cluster_hedges_total",
            "stuck requests re-dispatched as clones")
        self._m_hedge_cancels = m.counter(
            "serving_cluster_hedge_cancels_total",
            "hedge losers cancelled after the race resolved")
        self._m_deaths = m.counter(
            "serving_cluster_replica_deaths_total",
            "replicas declared dead (max_restarts exhausted)")
        self._m_health = per_replica(
            m.gauge, "serving_cluster_replica_health",
            "0 healthy / 1 degraded / 2 draining / 3 dead")
        self._m_free_pages = per_replica(
            m.gauge, "serving_cluster_replica_free_pages",
            "free KV pages, by replica")
        self._m_queue_depth = per_replica(
            m.gauge, "serving_cluster_replica_queue_depth",
            "waiting-queue depth, by replica")

    # ------------------------------------------------------------- chaos
    @staticmethod
    def chaos_injectors(seed: int, n: int) -> List[FaultInjector]:
        """One deterministic `FaultInjector` per replica, all derived
        from a single seed: replica i's injector seed is the first 8
        bytes of sha512(f"{seed}:{i}") — stable across processes (same
        construction as the injector's own per-site streams), so one
        integer reproduces an entire cluster chaos run."""
        return [FaultInjector(seed=int.from_bytes(
            hashlib.sha512(f"{seed}:{i}".encode()).digest()[:8], "big"))
            for i in range(n)]

    def _engine_factory(self, index: int) -> Callable[[], object]:
        def make():
            kw = {}
            if self._factory_kw["replica"]:
                kw["replica"] = index
            if self._factory_kw["fault_injector"] \
                    and self.fault_injectors is not None:
                kw["fault_injector"] = self.fault_injectors[index]
            if self._replica_devices is not None:
                kw["tp_size"] = self.tp_size
                kw["devices"] = self._replica_devices[index]
            return self._factory(**kw)
        return make

    # ------------------------------------------------------------ routing
    def _load_score(self, rep: ReplicaHandle) -> float:
        """Placement load: waiting-queue depth dominates (a queued
        request is a whole prefill + decode the replica still owes),
        remaining in-flight decode budget and KV page pressure break
        ties among equally-deep queues."""
        eng = rep.supervisor.engine
        sch = eng.scheduler
        alloc = eng.cache.allocator
        inflight = sum(r.max_new_tokens - len(r.generated)
                       for r in sch.running)
        used = alloc.num_allocatable - alloc.num_free
        return len(sch.waiting) * 1000.0 + inflight + used

    def _affinity_keys(self, prompt: Sequence[int]
                       ) -> List[Tuple[int, str]]:
        """(prefix_tokens, digest) per full-page prefix, LONGEST first;
        digests are cumulative sha1 over page-sized chunks so every
        prefix of the prompt hashes in one O(len) pass. Capped at
        len(prompt)-1 like `PrefixCache.match`, so the keys cover
        exactly the prefixes admission could reuse."""
        ps = self._page_size
        n_full = (len(prompt) - 1) // ps
        keys: List[Tuple[int, str]] = []
        h = hashlib.sha1()
        for i in range(n_full):
            h.update(np.asarray(prompt[i * ps:(i + 1) * ps],
                                np.int64).tobytes())
            keys.append(((i + 1) * ps, h.hexdigest()))
        keys.reverse()
        return keys

    def _affinity_tokens(self, rep: ReplicaHandle,
                         prompt: Sequence[int],
                         keys: List[Tuple[int, str]]) -> int:
        """Cached-prefix tokens this replica would reuse: a live
        PrefixCache is probed read-only; without one, the affinity
        table's longest hash owned by this replica stands in."""
        eng = rep.supervisor.engine
        if eng is not None and eng.prefix_cache is not None:
            return eng.prefix_cache.peek(prompt)
        for n_tokens, key in keys:
            if self._affinity.get(key) == rep.index:
                return n_tokens
        return 0

    def _note_affinity(self, prompt: Sequence[int], index: int) -> None:
        for _, key in self._affinity_keys(prompt):
            self._affinity[key] = index
            self._affinity.move_to_end(key)
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)

    def _candidates(self, prompt: Sequence[int]) -> List[ReplicaHandle]:
        """Placement order: healthy replicas before degraded (draining
        and dead never place), each tier by ascending load (or
        round-robin rotation), and — with affinity on — the replica
        holding the longest cached prefix moved to the front."""
        healthy = [r for r in self.replicas if r.health == "healthy"]
        degraded = [r for r in self.replicas if r.health == "degraded"]
        if self.placement == "round_robin":
            if healthy:
                k = self._rr % len(healthy)
                healthy = healthy[k:] + healthy[:k]
            elif degraded:
                k = self._rr % len(degraded)
                degraded = degraded[k:] + degraded[:k]
            self._rr += 1
        else:
            healthy.sort(key=self._load_score)
            degraded.sort(key=self._load_score)
        order = healthy + degraded
        if self.prefix_affinity and order:
            keys = self._affinity_keys(prompt)
            best, best_tokens = None, 0
            for rep in order:
                t = self._affinity_tokens(rep, prompt, keys)
                if t > best_tokens:
                    best, best_tokens = rep, t
            if best is not None:
                order.remove(best)
                order.insert(0, best)
                if self._m_aff_hit is not None:
                    self._m_aff_hit.inc()
            elif self._m_aff_miss is not None:
                self._m_aff_miss.inc()
        return order

    # -------------------------------------------------------- request API
    def add_request(self, prompt_ids, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, seed: Optional[int] = None,
                    eos_token_id: Optional[int] = None,
                    deadline_s: Optional[float] = None,
                    slo_class: Optional[str] = None) -> int:
        """Single-engine signature, cluster placement: route to the
        best candidate, spill to the next on `EngineOverloaded`, raise
        it only when every placeable replica is full. The effective
        seed is drawn HERE (not inside the engine) so migration and
        hedging replay the same sampling chain wherever the request
        lands. `slo_class` must name a class every replica's engine
        registers; migrations and hedge clones keep it. Returns the
        consumer-visible request id — stable across any number of
        migrations."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if seed is None:
            # fresh entropy is drawn exactly once, at routing; the seed is
            # journaled with the request, so migration/hedging REPLAY this
            # value rather than redrawing
            seed = int(np.random.randint(0, 2 ** 31 - 1))  # noqa: WALLCLOCK-IN-REPLAY — drawn once, journaled
        candidates = self._candidates(prompt)
        if not candidates:
            raise EngineOverloaded(
                "no placeable replica (all draining or dead)")
        last_exc: Optional[EngineOverloaded] = None
        for tried, rep in enumerate(candidates):
            try:
                rid = rep.supervisor.add_request(
                    prompt, max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, eos_token_id=eos_token_id,
                    deadline_s=deadline_s, slo_class=slo_class)
            except EngineOverloaded as e:
                last_exc = e
                if self._m_spill is not None:
                    self._m_spill.inc()
                continue
            now = self._clock()
            now_wall = time.time()
            rec = ClusterRequest(
                request_id=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature), top_k=int(top_k),
                top_p=float(top_p), seed=int(seed),
                eos_token_id=eos_token_id,
                deadline_wall=(now_wall + deadline_s
                               if deadline_s is not None else None),
                arrival_wall=now_wall,
                replica=rep.index, placed_t=now, last_progress_t=now,
                slo_class=slo_class)
            rec.copies[rid] = _Copy(replica=rep.index, base=0)
            self._records[rid] = rec
            if self._m_routed is not None:
                self._m_routed[rep.index].inc()
            if self.prefix_affinity:
                self._note_affinity(prompt, rep.index)
            # replica tag inside the request's lifecycle lane —
            # trace_summary renders these as [r0->r2]-style headers
            t = time.perf_counter()
            add_host_span(f"serving.request[{rid}].replica[r{rep.index}]",
                          t, t, event_type="Lifecycle")
            return rid
        if self._m_shed is not None:
            self._m_shed.inc()
        raise last_exc

    def cancel(self, request_id: int) -> bool:
        """Cancel the request on every replica currently carrying a
        copy (hedge clones included). True if it was live."""
        rec = self._records.get(request_id)
        if rec is None or rec.status is not None:
            return False
        for erid, copy in list(rec.copies.items()):
            rep = self.replicas[copy.replica]
            try:
                rep.supervisor.cancel(erid)
            except KeyError:
                pass
        rec.status = "cancelled"
        return True

    def status(self, request_id: int) -> Tuple[str, Optional[str]]:
        """(status, error): the cluster record once terminal, else the
        owning replica's live view (waiting/running)."""
        rec = self._records[request_id]
        if rec.status is None:
            self._refresh_status(rec)
        if rec.status is not None:
            return rec.status, rec.error
        for erid, copy in rec.copies.items():
            if copy.replica == rec.replica:
                return self.replicas[copy.replica].supervisor.status(erid)
        for erid, copy in rec.copies.items():
            return self.replicas[copy.replica].supervisor.status(erid)
        return "waiting", rec.error

    def _refresh_status(self, rec: ClusterRequest) -> None:
        """Pull failure-side terminals (failed/expired/shed) up from
        the replicas: a quarantined or expired copy ends the cluster
        request only when NO copy is still making progress."""
        if rec.status is not None or not rec.copies:
            return
        bad: List[Tuple[str, Optional[str]]] = []
        for erid, copy in list(rec.copies.items()):
            sup = self.replicas[copy.replica].supervisor
            try:
                st, err = sup.status(erid)
            except KeyError:
                continue
            if st in TERMINAL_STATUSES and st != "finished":
                bad.append((st, err))
        if bad and len(bad) == len(rec.copies):
            rec.status, rec.error = bad[0]

    def output(self, request_id: int) -> List[int]:
        """prompt + every token delivered to the consumer — the
        cluster-level stream, identical across migrations."""
        rec = self._records[request_id]
        return list(rec.prompt) + list(rec.delivered)

    # --------------------------------------------------------------- steps
    def has_work(self) -> bool:
        return any(rep.health != "dead" and rep.supervisor.has_work()
                   for rep in self.replicas)

    def step(self) -> List[Tuple[int, int]]:
        """One cluster step: health/hedging maintenance, then one
        engine step per replica with work. Token events come back under
        CONSUMER request ids, deduplicated across hedge copies, in
        replica order. A replica dying mid-step (`EngineDead`) triggers
        migration inline; its salvageable events are delivered first."""
        self._maintenance()
        out: List[Tuple[int, int]] = []
        for rep in self.replicas:
            if rep.health == "dead" or not rep.supervisor.has_work():
                continue
            try:
                events = rep.supervisor.step()
            except EngineDead as e:
                # a post-step escalation (watchdog/fault storm) stashes
                # its already-journaled events on the exception: deliver
                # them before migrating, or they would be marked shown
                # in the journal yet never reach the consumer
                out.extend(self._ingest(
                    getattr(e, "undelivered", None) or []))
                self._on_replica_death(rep, e)
                continue
            out.extend(self._ingest(events))
        return out

    def _ingest(self, events: List[Tuple[int, int]]
                ) -> List[Tuple[int, int]]:
        """Translate engine events to consumer events: alias hedge
        clones back to their consumer id, drop tokens from cancelled
        copies, dedup by absolute stream position (copies of one
        request produce bit-identical streams, so any overlap must
        agree — asserted), and resolve hedge races on the first NEW
        token."""
        out: List[Tuple[int, int]] = []
        now = self._clock()
        for erid, tok in events:
            crid = self._alias.get(erid, erid)
            rec = self._records.get(crid)
            if rec is None:
                # not cluster-placed (someone drove a supervisor
                # directly) — pass through untouched
                out.append((erid, tok))
                continue
            copy = rec.copies.get(erid)
            if copy is None:
                continue              # cancelled loser, late drain
            pos = copy.base + copy.emitted
            copy.emitted += 1
            if rec.status is not None:
                continue              # terminal already; suppress
            if pos < len(rec.delivered):
                if rec.delivered[pos] != tok:
                    raise RuntimeError(
                        f"hedge divergence on request {crid}: position "
                        f"{pos} delivered {rec.delivered[pos]} but "
                        f"replica r{copy.replica} produced {tok}")
                continue              # duplicate from the lagging copy
            rec.delivered.append(tok)
            rec.last_progress_t = now
            out.append((crid, tok))
            if len(rec.copies) > 1:
                self._resolve_hedge(rec, erid)
            if len(rec.delivered) >= rec.max_new_tokens or (
                    rec.eos_token_id is not None
                    and tok == rec.eos_token_id):
                rec.status = "finished"
        return out

    def stream(self) -> Iterable[Tuple[int, int, bool]]:
        """(request_id, token, done) across every replica, exactly-once
        per consumer id — migrations and hedges under the hood never
        duplicate or drop a token."""
        while self.has_work():
            events = self.step()
            for i, (rid, tok) in enumerate(events):
                rec = self._records.get(rid)
                done = (rec is not None and rec.status == "finished"
                        and all(r != rid for r, _ in events[i + 1:]))
                yield rid, tok, done

    def run(self) -> Dict[int, List[int]]:
        """Drive everything to completion; {request_id: prompt+tokens}
        for every request ever placed."""
        for _ in self.stream():
            pass
        for rec in self._records.values():
            self._refresh_status(rec)
        return {rid: self.output(rid) for rid in self._records}

    # ------------------------------------------------------------- health
    def drain(self, index: int) -> None:
        """Stop placing NEW work on a replica; in-flight requests keep
        running to completion (planned maintenance)."""
        rep = self.replicas[index]
        if rep.health == "dead":
            raise ValueError(f"replica r{index} is dead")
        self._set_health(rep, "draining")

    def resume(self, index: int) -> None:
        """Re-enable placement on a draining replica."""
        rep = self.replicas[index]
        if rep.health == "dead":
            raise ValueError(f"replica r{index} is dead")
        if rep.health == "draining":
            self._set_health(rep, "healthy")
            rep.clean_steps = 0
            rep.fault_window.clear()

    def health(self) -> List[str]:
        return [rep.health for rep in self.replicas]

    def _set_health(self, rep: ReplicaHandle, state: str) -> None:
        rep.health = state
        if self._m_health is not None:
            self._m_health[rep.index].set(_HEALTH_CODE[state])

    def _maintenance(self) -> None:
        """Per-step health refresh: supervisor restarts and fault
        bursts degrade a replica; `degrade_recovery_steps` clean steps
        heal it. Draining and dead states are sticky (operator /
        death-path owned). Then the hedge scan, if enabled."""
        self._step_count += 1
        for rep in self.replicas:
            if rep.health == "dead":
                continue
            sup = rep.supervisor
            eng = sup.engine
            if eng is None:
                continue
            restarted = len(sup.restarts) > rep.seen_restarts
            if restarted:
                rep.seen_restarts = len(sup.restarts)
            delta = eng.fault_events - rep.last_fault_events
            rep.last_fault_events = eng.fault_events
            rep.fault_window.append(delta)
            if rep.health == "healthy" and (
                    restarted
                    or sum(rep.fault_window) >= self.degrade_after_faults):
                self._set_health(rep, "degraded")
                rep.clean_steps = 0
            elif restarted or delta:
                rep.clean_steps = 0
            else:
                rep.clean_steps += 1
                if rep.health == "degraded" \
                        and rep.clean_steps >= self.degrade_recovery_steps:
                    self._set_health(rep, "healthy")
                    rep.fault_window.clear()
            if self._m_free_pages is not None:
                self._m_free_pages[rep.index].set(
                    eng.cache.allocator.num_free)
                self._m_queue_depth[rep.index].set(
                    len(eng.scheduler.waiting))
        if self.hedge_after_s is not None:
            self._maybe_hedge()

    # ------------------------------------------------------------ hedging
    def _maybe_hedge(self) -> None:
        now = self._clock()
        for rec in self._records.values():
            if rec.status is not None or len(rec.copies) != 1:
                continue
            (erid, copy), = rec.copies.items()
            owner = self.replicas[copy.replica]
            if owner.health != "degraded":
                continue
            if now - max(rec.placed_t, rec.last_progress_t) \
                    < self.hedge_after_s:
                continue
            targets = [r for r in self.replicas
                       if r.index != owner.index
                       and r.health in ("healthy", "degraded")]
            if not targets:
                continue
            healthy = [r for r in targets if r.health == "healthy"]
            target = min(healthy or targets, key=self._load_score)
            self._hedge(rec, owner, target)

    def _hedge(self, rec: ClusterRequest, owner: ReplicaHandle,
               target: ReplicaHandle) -> None:
        """Clone a stuck request onto `target` as a fold of everything
        delivered so far, under a FRESH engine id aliased back to the
        consumer id. Both copies race; `_ingest` dedups the overlap and
        `_resolve_hedge` cancels the loser on its first lost token."""
        t0 = time.perf_counter()
        eng = target.supervisor.engine
        try:
            clone = eng.adopt_request(
                prompt=rec.prompt, delivered=rec.delivered,
                max_new_tokens=rec.max_new_tokens,
                temperature=rec.temperature, top_k=rec.top_k,
                top_p=rec.top_p, seed=rec.seed,
                eos_token_id=rec.eos_token_id,
                deadline_wall=rec.deadline_wall,
                slo_class=rec.slo_class)
        except ValueError:
            return                     # hedging is best-effort
        rec.copies[clone] = _Copy(replica=target.index,
                                  base=len(rec.delivered))
        self._alias[clone] = rec.request_id
        rec.hedges += 1
        if self._m_hedges is not None:
            self._m_hedges.inc()
        t1 = time.perf_counter()
        add_host_span(
            f"serving.cluster.hedge[{rec.request_id}]"
            f".r{owner.index}->r{target.index}",
            t0, t1, event_type="Hedge")
        add_host_span(
            f"serving.request[{rec.request_id}].replica[r{target.index}]",
            t1, t1, event_type="Lifecycle")

    def _resolve_hedge(self, rec: ClusterRequest, winner: int) -> None:
        """First copy to contribute a NEW stream position wins; every
        other copy is cancelled through its replica (journal terminal
        "cancelled"), so exactly one copy keeps generating and the
        consumer keeps seeing one stream."""
        for erid, copy in list(rec.copies.items()):
            if erid == winner:
                continue
            sup = self.replicas[copy.replica].supervisor
            try:
                sup.cancel(erid)
            except KeyError:
                pass
            del rec.copies[erid]
            if self._m_hedge_cancels is not None:
                self._m_hedge_cancels.inc()
        rec.replica = rec.copies[winner].replica

    # ----------------------------------------------------------- failover
    def _on_replica_death(self, rep: ReplicaHandle,
                          exc: EngineDead) -> None:
        """A supervisor exhausted `max_restarts` mid-step: mark the
        replica dead, enforce `max_dead_replicas`, and migrate every
        journal-live request to the survivors — the dead replica's
        journal is the authoritative record of what each consumer was
        shown, so the fold (prompt + delivered) re-prefills on the
        target and the continuation is bit-identical."""
        self._set_health(rep, "dead")
        self.dead_replicas += 1
        if self._m_deaths is not None:
            self._m_deaths.inc()
        if self.dead_replicas > self.max_dead_replicas:
            raise EngineDead(
                f"cluster lost {self.dead_replicas} replicas "
                f"(max_dead_replicas={self.max_dead_replicas}); "
                f"last straw: r{rep.index}: {exc}",
                reason=exc.reason, restarts=exc.restarts)
        t0 = time.perf_counter()
        migrated = 0
        for jrec in rep.journal.live_records():
            self._migrate_one(rep, jrec.request_id, str(exc))
            migrated += 1
        t1 = time.perf_counter()
        if migrated and self._m_migration_s is not None:
            self._m_migration_s.observe(t1 - t0)
        self._dump_death_postmortem(rep, exc, migrated)

    def _dump_death_postmortem(self, rep: ReplicaHandle, exc: EngineDead,
                               migrated: int) -> None:
        """Finish the dead replica's forensics: the supervisor built its
        bundle BEFORE the migration loop ran, so refresh the event list
        from the (still-alive) ring — which now carries the migrate
        events — fold in the cluster's view, and write the bundle when a
        `postmortem_dir` is configured. Guarded end to end: forensics
        must never turn a survived failover into a crash."""
        try:
            sup = rep.supervisor
            bundle = getattr(sup, "postmortem", None)
            if bundle is None:
                return
            recorder = getattr(sup, "_dead_recorder", None)
            if recorder is not None:
                bundle["events"] = recorder.events()
                bundle["events_total"] = recorder.total_recorded
            bundle.setdefault("info", {})["cluster"] = {
                "replica": rep.index,
                "dead_replicas": self.dead_replicas,
                "migrated": migrated,
                "error": str(exc),
            }
            if self.postmortem_dir is not None:
                from ..observability import dump_postmortem

                path = dump_postmortem(
                    bundle, self.postmortem_dir,
                    prefix=f"postmortem-r{rep.index}")
                self.postmortem_paths.append(path)
                sup.postmortem_path = path
        except Exception:  # noqa: BLE001 — forensics must not kill failover
            pass

    def _migrate_one(self, rep: ReplicaHandle, erid: int,
                     reason: str) -> None:
        t0 = time.perf_counter()
        journal = rep.journal
        crid = self._alias.get(erid, erid)
        rec = self._records.get(crid)
        if rec is None:
            # not cluster-placed; nothing to migrate it into
            journal.terminal(erid, "failed",
                             error=f"replica r{rep.index} died: {reason}")
            return
        copy = rec.copies.pop(erid, None)
        if copy is None:
            # a hedge loser already cancelled at cluster level; close
            # the dead journal's record to match
            journal.terminal(erid, "cancelled")
            return
        if rec.status is not None:
            journal.terminal(
                erid,
                rec.status if rec.status in TERMINAL_STATUSES
                else "failed",
                error=rec.error)
            return
        if rec.copies:
            # a live hedge copy survives elsewhere — it owns the
            # stream now; nothing to re-admit
            journal.terminal(erid, "failed",
                             error=f"replica r{rep.index} died; hedge "
                                   f"copy survives on r{rec.replica}")
            rec.replica = next(iter(rec.copies.values())).replica
            return
        if len(rec.delivered) >= rec.max_new_tokens or (
                rec.eos_token_id is not None and rec.delivered
                and rec.delivered[-1] == rec.eos_token_id):
            # everything was delivered; only the finish record died
            # with the replica — reconstruct, never recompute
            rec.status = "finished"
            journal.terminal(erid, "finished")
            return
        targets = [r for r in self.replicas
                   if r.health in ("healthy", "degraded")]
        if not targets:
            rec.status, rec.error = "failed", (
                f"replica r{rep.index} died with no surviving replica "
                "to migrate to")
            journal.terminal(erid, "failed", error=rec.error)
            return
        healthy = [r for r in targets if r.health == "healthy"]
        target = min(healthy or targets, key=self._load_score)
        new_rid = self._adopt_on(target, rec, crid)
        if new_rid is None:
            journal.terminal(erid, "failed", error=rec.error)
            return
        journal.terminal(
            erid, "failed",
            error=f"replica r{rep.index} died ({reason}); migrated to "
                  f"r{target.index} as request {new_rid}")
        rec.migrations += 1
        if self._m_migrations is not None:
            self._m_migrations.inc()
            self._m_migrated_tokens.inc(
                len(rec.prompt) + len(rec.delivered))
        if self.prefix_affinity:
            self._note_affinity(rec.prompt, target.index)
        recorder = getattr(rep.supervisor, "_dead_recorder", None)
        if recorder is not None:
            # append to the DEAD replica's ring: its post-mortem bundle
            # then shows the fatal fault, the death, and where every
            # casualty went — the full story in one timeline
            recorder.record("migrate", rid=crid, src=rep.index,
                            dst=target.index, new_rid=new_rid,
                            delivered=len(rec.delivered))
        t1 = time.perf_counter()
        add_host_span(
            f"serving.cluster.migrate[{crid}]"
            f".r{rep.index}->r{target.index}",
            t0, t1, event_type="Migration")
        add_host_span(
            f"serving.request[{crid}].replica[r{target.index}]",
            t1, t1, event_type="Lifecycle")

    def _adopt_on(self, target: ReplicaHandle, rec: ClusterRequest,
                  crid: int) -> Optional[int]:
        """Re-admit `rec` on `target` under its consumer id (or a fresh
        alias if the target's journal somehow already knows the id),
        registering the FULL history (original prompt + delivered,
        split count 0) in the target's journal first — so if the target
        later dies too, the next migration folds from the same
        authoritative record."""
        from .recovery import RequestRecord

        tsup = target.supervisor
        rid_for_adopt: Optional[int] = crid
        if tsup.journal.known(crid):
            rid_for_adopt = None       # re-mint + alias, never collide
        elif tsup.journal is not None:
            tsup.journal.adopt(RequestRecord(
                request_id=crid, prompt=list(rec.prompt),
                max_new_tokens=rec.max_new_tokens,
                temperature=rec.temperature, top_k=rec.top_k,
                top_p=rec.top_p, seed=rec.seed,
                eos_token_id=rec.eos_token_id,
                deadline_wall=rec.deadline_wall,
                arrival_wall=rec.arrival_wall,
                delivered=list(rec.delivered)))
        try:
            new_rid = tsup.engine.adopt_request(
                prompt=rec.prompt, delivered=rec.delivered,
                max_new_tokens=rec.max_new_tokens,
                temperature=rec.temperature, top_k=rec.top_k,
                top_p=rec.top_p, seed=rec.seed,
                eos_token_id=rec.eos_token_id,
                deadline_wall=rec.deadline_wall,
                request_id=rid_for_adopt, slo_class=rec.slo_class)
        except ValueError as e:
            rec.status, rec.error = "failed", (
                f"migration to r{target.index} rejected: {e}")
            rec.copies = {}
            return None
        st, err = tsup.engine.status(new_rid)
        if st in TERMINAL_STATUSES:
            # expired during the outage (deadline_wall in the past):
            # terminal on arrival, never resurrected
            rec.status, rec.error = st, err
            rec.copies = {}
            return new_rid
        rec.copies = {new_rid: _Copy(replica=target.index,
                                     base=len(rec.delivered))}
        rec.replica = target.index
        if new_rid != crid:
            self._alias[new_rid] = crid
        return new_rid

    # -------------------------------------------------------- diagnostics
    def check_consistency(self) -> bool:
        """Cluster invariant audit: every live replica's scheduler (and
        prefix cache / allocator, transitively), every journal, plus
        the cluster's own tables — aliases resolve, every LIVE
        request's copies sit on non-dead replicas that know them (a
        terminal request's copy entries are history: the replica that
        finished a request is allowed to die afterwards), delivered
        streams fit their budgets. Raises RuntimeError on the first
        violation."""
        for rep in self.replicas:
            if rep.health != "dead" and rep.supervisor.engine is not None:
                rep.supervisor.engine.scheduler.check_consistency()
            rep.journal.check_consistency()
        for erid, crid in self._alias.items():
            if crid not in self._records:
                raise RuntimeError(
                    f"cluster corrupt: alias {erid}->{crid} points at "
                    "an unknown request")
        for crid, rec in self._records.items():
            if len(rec.delivered) > rec.max_new_tokens:
                raise RuntimeError(
                    f"cluster corrupt: request {crid} delivered "
                    f"{len(rec.delivered)} tokens over its budget "
                    f"{rec.max_new_tokens}")
            if rec.status is not None:
                continue
            for erid, copy in rec.copies.items():
                rep = self.replicas[copy.replica]
                if rep.health == "dead":
                    raise RuntimeError(
                        f"cluster corrupt: request {crid} holds a copy "
                        f"on dead replica r{copy.replica}")
                if self._alias.get(erid, erid) != crid:
                    raise RuntimeError(
                        f"cluster corrupt: copy {erid} of request "
                        f"{crid} does not alias back to it")
                eng = rep.supervisor.engine
                if eng is not None and erid not in eng.requests \
                        and not rep.journal.known(erid):
                    raise RuntimeError(
                        f"cluster corrupt: copy {erid} of request "
                        f"{crid} unknown to replica r{copy.replica}")
        return True

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Cluster roll-up: per-replica health + engine/supervisor
        stats, router and failover counters, and a per-request summary
        (status / owner / delivered / migrations / hedges)."""
        terminal: Dict[str, int] = {}
        live = 0
        requests: Dict[int, dict] = {}
        for crid, rec in self._records.items():
            if rec.status is None:
                live += 1
            else:
                terminal[rec.status] = terminal.get(rec.status, 0) + 1
            requests[crid] = {
                "status": rec.status if rec.status is not None else "live",
                "replica": rec.replica,
                "tokens": len(rec.delivered),
                "migrations": rec.migrations,
                "hedges": rec.hedges,
            }

        def counter(c):
            return int(c.value) if c is not None else 0

        return {
            "num_replicas": self.num_replicas,
            "dead_replicas": self.dead_replicas,
            "health": self.health(),
            "placement": self.placement,
            "prefix_affinity": self.prefix_affinity,
            "num_requests": len(self._records),
            "num_finished": terminal.get("finished", 0),
            "num_live": live,
            "terminal": terminal,
            "router": {
                "routed": [counter(c) for c in (self._m_routed or [])],
                "affinity_hits": counter(self._m_aff_hit),
                "affinity_misses": counter(self._m_aff_miss),
                "spillovers": counter(self._m_spill),
                "shed": counter(self._m_shed),
                "affinity_table": len(self._affinity),
            },
            "migrations": counter(self._m_migrations),
            "migrated_tokens": counter(self._m_migrated_tokens),
            "hedges": counter(self._m_hedges),
            "hedge_cancels": counter(self._m_hedge_cancels),
            "replica_deaths": counter(self._m_deaths),
            "replicas": [
                {"index": rep.index, "health": rep.health,
                 "stats": rep.supervisor.stats()}
                for rep in self.replicas],
            "requests": requests,
        }

    def telemetry(self) -> Dict[str, object]:
        """One cluster-wide metric view: every live replica's
        engine registry merged with the cluster's own registry into a
        single replica-labelled snapshot plus its Prometheus text
        exposition — the scrape endpoint a deployment exports, instead
        of N per-replica registries.

        Every merged series gains a ``replica`` label: the engine
        registries are tagged with their replica index, the cluster
        registry with ``cluster``. ``setdefault`` (never overwrite)
        keeps the cluster's own per-replica gauges — which already
        carry a ``replica`` label — intact. Engines that share the
        cluster registry (``metrics=cluster.metrics`` factories) are
        skipped so their series never double-count."""
        from ..observability import registry_from_snapshot, to_prometheus

        merged: List[dict] = []

        def fold(registry, tag: str) -> None:
            for d in registry.snapshot()["metrics"]:
                d = dict(d)
                labels = dict(d.get("labels") or {})
                labels.setdefault("replica", tag)
                d["labels"] = labels
                merged.append(d)

        if self.metrics is not None:
            fold(self.metrics, "cluster")
        for rep in self.replicas:
            eng = rep.supervisor.engine
            if eng is None or eng.metrics is None \
                    or eng.metrics is self.metrics:
                continue
            fold(eng.metrics, str(rep.index))
        registry = registry_from_snapshot({"metrics": merged})
        return {
            "replicas": [
                {"index": rep.index, "health": rep.health,
                 "alive": rep.supervisor.engine is not None,
                 "restarts": len(rep.supervisor.restarts),
                 "postmortem": rep.supervisor.postmortem_path}
                for rep in self.replicas],
            "dead_replicas": self.dead_replicas,
            "metrics": registry.snapshot(),
            "prometheus": to_prometheus(registry),
            "postmortems": list(self.postmortem_paths),
        }

    def close(self) -> None:
        for rep in self.replicas:
            rep.journal.close()
