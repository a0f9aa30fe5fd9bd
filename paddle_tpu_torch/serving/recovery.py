"""Crash recovery for the serving engine (ported from
paddle_tpu/serving/recovery.py).

The engine is a replaceable part: kill it at any point and rebuild it with
every unfinished request resuming as if nothing happened. Three pieces:

- **`RequestJournal`**: an append-only, optionally file-backed log of
  request lifecycle events (`submit` / `tokens` / `terminal` / `restart`),
  the source of truth for what a `stream()` consumer has been shown.
  Tokens enter it when the engine RETURNS them to the caller, so recovery
  re-admits each unfinished request as `original prompt + journaled
  tokens`: what was delivered is folded into the prompt (never delivered
  again), what was not (an undrained decode block, spilled events lost to
  the crash) was never journaled and is recomputed. That is exactly-once
  delivery across restarts. The JSON-lines schema is the reference's, so
  either package reads the other's file.

- **`EngineSnapshot` / `ServingEngine.restore()`**: the serializable
  boundary state: per-request metadata, queue order, wall-clock deadlines
  and each request's sampling state. The port samples from counter-based
  draws (serving.sampling), so that state is a draw index, the number of
  tokens the request has sampled (`replay_key_state`), where the reference
  carries a threefry key. KV pages are not captured: the folded re-prefill
  recreates them through the ordinary prefill / chunked-prefill /
  prefix-cache paths, so recovery costs a re-prefill, never a re-decode.
  On the CPU in fp32 the continuation is bit-identical; in bf16 on the
  card the re-prefill's attention rounds otherwise than the decode steps
  it replaces.

- **`EngineSupervisor`**: the escalation ladder above the engine's retry /
  quarantine. A FATAL fault (`is_fatal`, e.g. the injector's `device_lost`
  site), a step exceeding `max_step_wall_s` (watchdog), or too many faults
  over a sliding window of steps trigger salvage -> snapshot -> rebuild
  (the engine factory) -> re-admit, with `check_consistency()` audits on
  both sides and restart counters and a time-to-recover histogram in the
  metrics registry.

The restart is in-process. It covers an injected `device_lost`, the
watchdog, fault storms and non-sticky CUDA errors. A sticky CUDA error
(an illegal address, a device-side assert) poisons the process's CUDA
context: every later CUDA call in the process fails, so no factory in the
process can rebuild from it, and the supervisor's restart fails too.
Recovering from one needs a new process that loads the journal
(`RequestJournal.load`); that is not part of this module.

Everything here is zero-cost when unused: an engine without a journal runs
one `None` check per step and never imports this module.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .resilience import EngineDead, TERMINAL_STATUSES, is_fatal

__all__ = ["EngineSnapshot", "EngineSupervisor", "RequestJournal",
           "RequestRecord", "RequestSnapshot", "replay_key_state"]


def replay_key_state(seed: int, delivered: int) -> int:
    """A request's sampling state after `delivered` tokens: its draw index.
    The port's n-th sampled token draws noise from (seed, n) alone
    (serving.sampling), each emitted token advances the index by one and
    an intermediate prefill chunk draws nothing, so the state after
    `delivered` tokens is `delivered`, whatever the seed. Callers pass
    `key_splits + len(delivered)` for a record that was folded before.
    The name is the reference's, whose state is a threefry key chain."""
    return int(delivered)


# --------------------------------------------------------------- journal

@dataclasses.dataclass
class RequestRecord:
    """Aggregated journal view of one request: the submit metadata plus
    everything delivered so far and how (whether) it ended."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    top_k: int
    top_p: float
    seed: int                     # effective sampling seed (never None)
    eos_token_id: Optional[int]
    deadline_wall: Optional[float]   # absolute time.time() deadline
    arrival_wall: float
    delivered: List[int] = dataclasses.field(default_factory=list)
    status: Optional[str] = None     # terminal status, None while live
    error: Optional[str] = None
    first_token_wall: Optional[float] = None
    last_token_wall: Optional[float] = None
    # draws consumed BEFORE this record's first delivered token: 0 for
    # ordinary submissions; a request adopted as a fold of an older one
    # inherits that request's count, so `replay_key_state(seed,
    # key_splits + len(delivered))` is the draw index of ANY record
    # (the reference's name, where it counts key splits)
    key_splits: int = 0

    @property
    def live(self) -> bool:
        return self.status is None

    def is_complete(self) -> bool:
        """Delivered stream already satisfies the stopping rule (budget
        or EOS) — nothing left to recompute even without a journaled
        `finished` event (the finish record itself can be lost to a
        crash; the tokens cannot, or they were never delivered)."""
        if len(self.delivered) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and bool(self.delivered)
                and self.delivered[-1] == self.eos_token_id)


class RequestJournal:
    """Append-only request journal: the exactly-once delivery ledger.

    The engine appends `submit` on `add_request`, `tokens` at the moment
    a step RETURNS events to the caller, and `terminal` when a request
    reaches a terminal status; the supervisor appends `restart` epochs.
    `path=` makes it file-backed (one JSON object per line, flushed per
    append) so a journal can outlive the process; `RequestJournal.load`
    rebuilds one from such a file.

    Tokens recorded here have been SHOWN to a `stream()`/`step()`
    consumer; recovery folds them into the re-admitted prompt, so they
    are never delivered twice. Tokens the engine computed but never
    returned (an undrained decode block, spill lost mid-crash) never
    reach the journal and are recomputed bit-identically. Token records
    arriving after a terminal record (a cancel drained its block first)
    are kept for the audit trail but never change the terminal outcome.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: Dict[int, RequestRecord] = {}
        self._order: List[int] = []          # submission order
        self.restarts: List[dict] = []
        self._fh = open(path, "a", encoding="utf-8") if path else None

    # ------------------------------------------------------------ appends
    def _persist(self, obj: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(obj) + "\n")
            self._fh.flush()

    def submit(self, *, request_id: int, prompt: List[int],
               max_new_tokens: int, temperature: float, top_k: int,
               top_p: float, seed: int, eos_token_id: Optional[int],
               deadline_wall: Optional[float],
               arrival_wall: Optional[float] = None,
               key_splits: int = 0) -> None:
        if request_id in self._records:
            raise ValueError(
                f"request {request_id} already journaled")
        rec = RequestRecord(
            request_id=request_id, prompt=list(prompt),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p), seed=int(seed),
            eos_token_id=eos_token_id, deadline_wall=deadline_wall,
            arrival_wall=(time.time() if arrival_wall is None
                          else arrival_wall),
            key_splits=int(key_splits))
        self._records[request_id] = rec
        self._order.append(request_id)
        obj = {"ev": "submit", "rid": request_id,
               "prompt": rec.prompt,
               "max_new_tokens": rec.max_new_tokens,
               "temperature": rec.temperature,
               "top_k": rec.top_k, "top_p": rec.top_p,
               "seed": rec.seed,
               "eos_token_id": rec.eos_token_id,
               "deadline_wall": rec.deadline_wall,
               "arrival_wall": rec.arrival_wall}
        if rec.key_splits:
            obj["key_splits"] = rec.key_splits
        self._persist(obj)

    def adopt(self, rec: RequestRecord) -> None:
        """Register a copy of another journal's record (cluster
        migration: the consumer-visible history of a request moving off
        a dead replica). The copy is live (terminal state stays with the
        old incarnation), carries the ORIGINAL prompt plus everything
        delivered so far, and persists as an equivalent submit + tokens
        pair so a reload of THIS journal reconstructs it."""
        if rec.request_id in self._records:
            raise ValueError(
                f"request {rec.request_id} already journaled")
        self.submit(request_id=rec.request_id, prompt=rec.prompt,
                    max_new_tokens=rec.max_new_tokens,
                    temperature=rec.temperature, top_k=rec.top_k,
                    top_p=rec.top_p, seed=rec.seed,
                    eos_token_id=rec.eos_token_id,
                    deadline_wall=rec.deadline_wall,
                    arrival_wall=rec.arrival_wall,
                    key_splits=rec.key_splits)
        if rec.delivered:
            self.tokens(rec.request_id, list(rec.delivered),
                        t_wall=rec.last_token_wall)
            self._records[rec.request_id].first_token_wall = \
                rec.first_token_wall

    def tokens(self, request_id: int, toks: List[int],
               t_wall: Optional[float] = None) -> None:
        rec = self._records[request_id]
        if t_wall is None:
            t_wall = time.time()
        if rec.first_token_wall is None:
            rec.first_token_wall = t_wall
        rec.last_token_wall = t_wall
        rec.delivered.extend(int(t) for t in toks)
        self._persist({"ev": "tokens", "rid": request_id,
                       "toks": [int(t) for t in toks],
                       "t_wall": t_wall})

    def terminal(self, request_id: int, status: str,
                 error: Optional[str] = None) -> None:
        if status not in TERMINAL_STATUSES:
            raise ValueError(f"not a terminal status: {status!r}")
        rec = self._records[request_id]
        if rec.status is not None:
            return                   # idempotent: first terminal wins
        rec.status = status
        rec.error = error
        self._persist({"ev": "terminal", "rid": request_id,
                       "status": status, "error": error})

    def restart(self, epoch: int, reason: str, t_recover_s: float,
                readmitted: int = 0, replayed_tokens: int = 0) -> None:
        obj = {"ev": "restart", "epoch": epoch, "reason": reason,
               "t_recover_s": t_recover_s, "readmitted": readmitted,
               "replayed_tokens": replayed_tokens,
               "t_wall": time.time()}
        self.restarts.append(obj)
        self._persist(obj)

    # ------------------------------------------------------------ queries
    def record(self, request_id: int) -> RequestRecord:
        return self._records[request_id]

    def known(self, request_id: int) -> bool:
        return request_id in self._records

    def request_ids(self) -> List[int]:
        return list(self._order)

    def delivered(self, request_id: int) -> List[int]:
        return list(self._records[request_id].delivered)

    def live_records(self) -> List[RequestRecord]:
        """Submission-ordered records with no terminal status — the set a
        restore must account for (re-admit, expire, or complete)."""
        return [self._records[r] for r in self._order
                if self._records[r].status is None]

    def check_consistency(self) -> bool:
        """Journal invariant audit: per request at most `max_new_tokens`
        delivered, no tokens past a delivered EOS, submission order
        consistent. Raises RuntimeError on the first violation."""
        if sorted(self._order) != sorted(self._records):
            raise RuntimeError("journal corrupt: order/record mismatch")
        for rec in self._records.values():
            if len(rec.delivered) > rec.max_new_tokens:
                raise RuntimeError(
                    f"journal corrupt: request {rec.request_id} "
                    f"delivered {len(rec.delivered)} tokens over its "
                    f"budget {rec.max_new_tokens}")
            if rec.eos_token_id is not None \
                    and rec.eos_token_id in rec.delivered[:-1]:
                raise RuntimeError(
                    f"journal corrupt: request {rec.request_id} "
                    "delivered tokens past EOS")
        return True

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    @classmethod
    def load(cls, path: str) -> "RequestJournal":
        """Rebuild a journal from its JSONL file (a restart in a fresh
        process): replays every record through the ordinary append path
        with persistence off, then re-attaches the file for appends.

        A TORN FINAL LINE — the writer died mid-append, so the file ends
        in a partial JSON record — is tolerated: the tail is truncated
        off (with a warning) and everything before it loads normally.
        One torn record is exactly what a kill-anywhere crash can
        produce, and by the delivery contract a token record that never
        finished hitting the disk was never shown to a consumer, so
        dropping it is correct (the token is recomputed, not lost).
        Corruption anywhere BEFORE the final record is still an error:
        that is not a torn append but a damaged file."""
        j = cls()
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        for raw in data.splitlines(keepends=True):
            start, pos = pos, pos + len(raw)
            line = raw.strip()
            if not line:
                continue
            try:
                obj = json.loads(line.decode("utf-8"))
                ev = obj["ev"]
                if ev == "submit":
                    j.submit(request_id=obj["rid"], prompt=obj["prompt"],
                             max_new_tokens=obj["max_new_tokens"],
                             temperature=obj["temperature"],
                             top_k=obj["top_k"], top_p=obj["top_p"],
                             seed=obj["seed"],
                             eos_token_id=obj["eos_token_id"],
                             deadline_wall=obj["deadline_wall"],
                             arrival_wall=obj["arrival_wall"],
                             key_splits=obj.get("key_splits", 0))
                elif ev == "tokens":
                    j.tokens(obj["rid"], obj["toks"],
                             t_wall=obj["t_wall"])
                elif ev == "terminal":
                    j.terminal(obj["rid"], obj["status"], obj["error"])
                elif ev == "restart":
                    j.restarts.append(obj)
            except (ValueError, KeyError, UnicodeDecodeError) as e:
                if data[pos:].strip():
                    # damage with intact records AFTER it cannot be a
                    # torn append — refuse to guess
                    raise ValueError(
                        f"corrupt journal record at byte {start} of "
                        f"{path}: {line[:80]!r}") from e
                warnings.warn(
                    f"journal {path}: dropping torn final record "
                    f"({len(raw)} bytes, writer died mid-append)",
                    RuntimeWarning, stacklevel=2)
                with open(path, "r+b") as fh:
                    fh.truncate(start)
                break
        j.path = path
        j._fh = open(path, "a", encoding="utf-8")
        return j


# -------------------------------------------------------------- snapshot

@dataclasses.dataclass
class RequestSnapshot:
    """One unfinished request's restorable state. `prompt` is the
    ORIGINAL prompt and `delivered` the journaled tokens: the restore side
    folds them (`prompt + delivered`) and re-prefills. `draws` is the draw
    index after them (`replay_key_state`), where the reference carries a
    threefry `key_data`; every other field keeps the reference's name."""

    request_id: int
    prompt: List[int]
    delivered: List[int]
    max_new_tokens: int              # ORIGINAL budget
    temperature: float
    top_k: int
    top_p: float
    seed: int
    eos_token_id: Optional[int]
    deadline_wall: Optional[float]
    arrival_wall: float
    first_token_wall: Optional[float]
    last_token_wall: Optional[float]
    preemptions: int
    parked: bool
    draws: int


@dataclasses.dataclass
class EngineSnapshot:
    """Boundary state of a ServingEngine: scheduler queue order (running
    in admission order, then waiting in queue order — FCFS survives the
    restart), per-request metadata/progress, and the config the restore
    target is validated against. KV pages and undrained decode blocks
    are deliberately absent — see the module docstring for why that is
    safe (and cheaper than checkpointing pools)."""

    config: Dict[str, object]
    requests: List[RequestSnapshot]
    taken_wall: float

    def to_json(self) -> str:
        return json.dumps({
            "config": self.config, "taken_wall": self.taken_wall,
            "requests": [dataclasses.asdict(r) for r in self.requests],
        })

    @classmethod
    def from_json(cls, s: str) -> "EngineSnapshot":
        obj = json.loads(s)
        return cls(config=obj["config"], taken_wall=obj["taken_wall"],
                   requests=[RequestSnapshot(**r) for r in obj["requests"]])


# ------------------------------------------------------------ supervisor

class EngineSupervisor:
    """Keeps a ServingEngine alive across engine-level failures.

    The supervisor owns the journal and an engine FACTORY (a zero-arg
    callable returning a fresh `ServingEngine`; share one
    MetricsRegistry across incarnations by closing over `metrics=` in
    the factory). Drive it exactly like an engine — `add_request` /
    `step` / `stream` / `run` / `cancel` / `status` / `output` — and it
    transparently restarts the engine when:

    - a step raises a FATAL fault (`is_fatal`: the injector's
      `device_lost` site, or any exception carrying `fatal=True`);
    - a step's wall time exceeds `max_step_wall_s` (watchdog — a wedged
      dispatch is indistinguishable from a dead device, and a step that
      slow is evidence the runtime is sick);
    - `fault_rate_threshold` faults accumulate over the last
      `fault_rate_window` steps (transient-retry storms and quarantine
      cascades stop being isolated incidents at some rate).

    A restart runs: drain-what-you-can (`engine.salvage()`: tokens an
    answering device can still surface are delivered and journaled, a
    dead one loses only what was never delivered), `check_consistency()`
    on the wreck, `snapshot()`, the wreck's KV pools released
    (`release_pools()`, so old and new pools are never alive together),
    factory-rebuild, `restore()` (folded re-prefill re-admission),
    `check_consistency()` on the new engine. `restarts[k]` splits each
    restart's wall into `t_salvage_s`, `t_snapshot_s`, `t_factory_s` and
    `t_restore_s`.
    `cancel(rid)` issued while a restore is in flight is recorded and
    wins over re-admission; a request whose wall-clock deadline passed
    during the outage is expired, never resurrected.
    """

    RESTART_REASONS = ("fatal_fault", "watchdog", "fault_storm",
                      "manual")

    def __init__(self, factory: Callable[[], object], *,
                 journal: Optional[RequestJournal] = None,
                 metrics=None,
                 max_step_wall_s: Optional[float] = None,
                 fault_rate_threshold: Optional[int] = None,
                 fault_rate_window: int = 32,
                 max_restarts: int = 8,
                 clock: Callable[[], float] = time.perf_counter):
        self._factory = factory
        self.journal = journal if journal is not None else RequestJournal()
        self.max_step_wall_s = max_step_wall_s
        self.fault_rate_threshold = fault_rate_threshold
        self.max_restarts = max_restarts
        self._clock = clock
        self._fault_window: deque = deque(maxlen=max(fault_rate_window, 1))
        self._pending_cancels: set = set()
        self._restoring = False
        # set when max_restarts is exhausted: the engine object is
        # dropped (`self.engine = None`) and every drive-the-engine entry
        # point raises EngineDead, while status/output/stats keep
        # answering from the journal
        self.dead_reason: Optional[str] = None
        # test/ops hook: called between snapshot and re-admission, the
        # window where a concurrent control-plane cancel() must still win
        self._mid_restore_hook: Optional[Callable] = None
        self.restarts: List[dict] = []
        # forensics: the post-mortem bundle built when the engine is
        # declared dead (and written to the engine's postmortem_dir when it
        # has one); `_dead_recorder` keeps the dead engine's flight-recorder
        # ring alive, so a ServingCluster can append its migration records
        self.postmortem: Optional[dict] = None
        self.postmortem_path: Optional[str] = None
        self._dead_recorder = None
        self.metrics = metrics
        if metrics is not None:
            self._m_restarts = {
                reason: metrics.counter(
                    "serving_engine_restarts_total",
                    "engine rebuilds by escalation reason",
                    labels={"reason": reason})
                for reason in self.RESTART_REASONS}
            self._m_recover = metrics.histogram(
                "serving_recovery_seconds",
                "drain+snapshot+rebuild+re-admit wall time")
            self._m_replayed = metrics.counter(
                "serving_recovery_replayed_tokens_total",
                "folded-prompt tokens re-prefilled by restores")
        else:
            self._m_restarts = None
            self._m_recover = None
            self._m_replayed = None
        self.engine = factory()
        self.engine.attach_journal(self.journal)

    # --------------------------------------------------------- dead state
    @property
    def dead(self) -> bool:
        return self.dead_reason is not None

    def _check_alive(self) -> None:
        if self.dead_reason is not None:
            raise EngineDead(
                f"engine is dead ({self.dead_reason}); journal queries "
                "(status/output/stats) still answer",
                reason=self.dead_reason, restarts=len(self.restarts))

    # ------------------------------------------------------- request API
    def add_request(self, *args, **kwargs) -> int:
        self._check_alive()
        return self.engine.add_request(*args, **kwargs)

    def cancel(self, request_id: int) -> bool:
        if self._restoring:
            # mid-restore: the engine being rebuilt must not resurrect
            # this request — recorded here, applied by restore()
            self._pending_cancels.add(request_id)
            return True
        if self.engine is None:
            # dead supervisor: no engine to stop, but the journal record
            # must still end so consumers (and a migrating cluster) see
            # the cancel — first terminal wins as usual
            rec = self.journal.record(request_id)
            if rec.status is not None:
                return False
            self.journal.terminal(request_id, "cancelled")
            return True
        return self.engine.cancel(request_id)

    def status(self, request_id: int) -> Tuple[str, Optional[str]]:
        """(status, error), falling back to the journal for requests that
        ended before the last restart (terminal requests are not carried
        into rebuilt engines — the journal is their record) and for
        everything once the supervisor is dead."""
        req = (self.engine.requests.get(request_id)
               if self.engine is not None else None)
        if req is not None:
            return req.status, req.error
        rec = self.journal.record(request_id)
        return (rec.status if rec.status is not None else "waiting",
                rec.error)

    def output(self, request_id: int) -> List[int]:
        req = (self.engine.requests.get(request_id)
               if self.engine is not None else None)
        if req is not None:
            return self.engine.output(request_id)
        rec = self.journal.record(request_id)
        return list(rec.prompt) + list(rec.delivered)

    # ------------------------------------------------------------- steps
    def has_work(self) -> bool:
        eng = self.engine
        if eng is None:
            return False
        return (eng.scheduler.has_work() or eng._pending is not None
                or bool(eng._spill))

    def step(self) -> List[Tuple[int, int]]:
        self._check_alive()
        eng = self.engine
        faults_before = eng.fault_events
        t0 = self._clock()
        try:
            events = eng.step()
        except Exception as e:  # noqa: BLE001 — escalation boundary
            if not is_fatal(e):
                raise
            return self._restart("fatal_fault", exc=e)
        dt = self._clock() - t0
        if self.fault_rate_threshold is not None:
            self._fault_window.append(eng.fault_events - faults_before)
        if self.max_step_wall_s is not None and dt > self.max_step_wall_s:
            # the step DID return, but a step this slow means the runtime
            # is wedging; restart proactively at a clean boundary
            return events + self._escalate("watchdog", events)
        if self.fault_rate_threshold is not None and \
                sum(self._fault_window) >= self.fault_rate_threshold:
            self._fault_window.clear()
            return events + self._escalate("fault_storm", events)
        return events

    def _escalate(self, reason: str,
                  events: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        """Post-step escalation: the step returned (and journaled)
        `events` before the restart decision. If the restart budget is
        gone the EngineDead raise would otherwise swallow them — already
        marked delivered in the journal, never shown to the caller — so
        they ride on the exception for the caller (a ServingCluster) to
        deliver before migrating."""
        try:
            return self._restart(reason)
        except EngineDead as e:
            e.undelivered = list(events)
            raise

    def stream(self) -> Iterable[Tuple[int, int, bool]]:
        """Generator of (request_id, token, done) across restarts: the
        engine under the hood may be rebuilt mid-stream, the token
        sequence each consumer sees is exactly-once regardless."""
        while True:
            eng = self.engine
            if eng.scheduler.has_work():
                events = self.step()
            elif eng._pending is not None or eng._spill:
                events = eng.drain_all()
            else:
                break
            for i, (rid, tok) in enumerate(events):
                # status() rather than the engine's request table: a
                # salvaged event may belong to a request that finished
                # during the restart and was not carried into the
                # rebuilt engine — the journal still knows it
                status, _ = self.status(rid)
                done = (status == "finished"
                        and all(r != rid for r, _ in events[i + 1:]))
                yield rid, tok, done

    def run(self) -> Dict[int, List[int]]:
        for _ in self.stream():
            pass
        return {rid: self.output(rid)
                for rid in self.journal.request_ids()}

    def restart(self) -> List[Tuple[int, int]]:
        """Operator-initiated restart (planned maintenance, config
        rollouts): same drain/snapshot/rebuild/re-admit ladder as the
        automatic escalations."""
        self._check_alive()
        return self._restart("manual")

    # ---------------------------------------------------------- recovery
    def _restart(self, reason: str,
                 exc: Optional[BaseException] = None
                 ) -> List[Tuple[int, int]]:
        from ..profiler import add_host_span

        if len(self.restarts) >= self.max_restarts:
            # the budget is gone: declare the engine dead. The engine
            # object is dropped (the device it wrapped is what kept
            # failing) and its KV pools freed; the journal stays as the
            # record of every request, which stats/status/output answer
            # from and a ServingCluster migrates from
            self.dead_reason = (
                f"{reason}" + (f": {exc}" if exc else ""))
            # forensics BEFORE the engine is dropped: record the death in
            # its ring, build the bundle, keep the ring for the cluster's
            # migration records, dump it when the engine has a
            # postmortem_dir. Guarded: forensics never masks the raise
            old = self.engine
            try:
                rec = getattr(old, "_recorder", None)
                if rec is not None:
                    rec.record("dead", reason=reason,
                               error=(str(exc) if exc else None),
                               restarts=len(self.restarts))
                self._dead_recorder = rec
                build = getattr(old, "build_postmortem", None)
                if build is not None:
                    self.postmortem = build(
                        f"dead-{reason}",
                        info={"restarts": list(self.restarts),
                              "dead_reason": self.dead_reason})
                if (self.postmortem is not None
                        and getattr(old, "_postmortem_dir", None)):
                    from ..observability.flight_recorder import \
                        dump_postmortem
                    self.postmortem_path = dump_postmortem(
                        self.postmortem, old._postmortem_dir)
            except Exception:  # noqa: BLE001 (forensics must not mask death)
                pass
            try:
                # the pools only: a factory may share the model's weights
                # with other engines
                old.release_pools()
            except Exception:  # noqa: BLE001 (the device may be gone)
                pass
            self.engine = None
            raise EngineDead(
                f"engine restarted {len(self.restarts)} times "
                f"(max_restarts={self.max_restarts}); giving up on "
                f"{reason}" + (f": {exc}" if exc else ""),
                reason=reason, restarts=len(self.restarts))
        t0 = time.perf_counter()
        old = self.engine
        try:
            # drain-what-you-can: a still-answering device surfaces (and
            # journals) its pending block; a dead one only loses tokens
            # that were never delivered, which the rebuild recomputes
            events = old.salvage()
        except Exception:  # noqa: BLE001 (the device may be truly gone)
            events = []
        t_salvage = time.perf_counter()
        old.scheduler.check_consistency()
        snap = old.snapshot()
        # nothing is read from the wreck's pools after the snapshot: free
        # them before the factory allocates the new engine's
        old.release_pools()
        t_snapshot = time.perf_counter()
        self._restoring = True
        try:
            if self._mid_restore_hook is not None:
                self._mid_restore_hook(self)
            t_hook = time.perf_counter()
            new = self._factory()
            new.attach_journal(self.journal)
            t_factory = time.perf_counter()
            cancelled, self._pending_cancels = self._pending_cancels, set()
            readmitted = new.restore(snap, cancelled=cancelled)
        finally:
            self._restoring = False
        self.engine = new
        new.scheduler.check_consistency()
        t1 = time.perf_counter()
        replayed = sum(len(new.requests[rid].prompt)
                       for rid in readmitted)
        epoch = len(self.restarts) + 1
        info = {"epoch": epoch, "reason": reason,
                "t_recover_s": t1 - t0, "readmitted": len(readmitted),
                "replayed_tokens": replayed,
                "error": repr(exc) if exc is not None else None,
                "t_salvage_s": t_salvage - t0,
                "t_snapshot_s": t_snapshot - t_salvage,
                "t_factory_s": t_factory - t_hook,
                "t_restore_s": t1 - t_factory}
        self.restarts.append(info)
        self.journal.restart(epoch, reason, t1 - t0,
                             readmitted=len(readmitted),
                             replayed_tokens=replayed)
        rec = getattr(new, "_recorder", None)
        if rec is not None:
            # factories sharing one FlightRecorder across rebuilds get one
            # continuous ring with the restart marked in line
            rec.record("restart", epoch=epoch, reason=reason,
                       readmitted=len(readmitted))
        # chrome-trace marker: tools/trace_summary.py draws this span as a
        # `-- restart #k --` divider inside request timelines
        add_host_span(f"serving.recovery[{epoch}].{reason}", t0, t1,
                      event_type="Recovery")
        if self._m_restarts is not None:
            self._m_restarts[reason].inc()
            self._m_recover.observe(t1 - t0)
            self._m_replayed.inc(replayed)
        return events

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Engine stats plus restart history. After the supervisor is
        declared dead (max_restarts exhausted) the engine object is
        gone, so the summary is rebuilt from the journal — reporting the
        terminal reason instead of raising."""
        if self.engine is None:
            terminal: Dict[str, int] = {}
            live = 0
            for rid in self.journal.request_ids():
                rec = self.journal.record(rid)
                if rec.status is None:
                    live += 1
                else:
                    terminal[rec.status] = terminal.get(rec.status, 0) + 1
            s: Dict[str, object] = {
                "num_requests": len(self.journal.request_ids()),
                "num_finished": terminal.get("finished", 0),
                "num_live": live,
                "terminal": terminal,
            }
        else:
            s = self.engine.stats()
        s["dead"] = self.engine is None
        s["dead_reason"] = self.dead_reason
        s["restarts"] = list(self.restarts)
        s["num_restarts"] = len(self.restarts)
        return s
