"""Flight recorder — a bounded ring of control-plane events with JSON
post-mortem bundles (the port's own copy of
paddle_tpu/observability/flight_recorder.py: the same schema, so
`tools/postmortem.py` renders either package's bundles).

A restart counter tells you a replica died; it does not tell you *why*.
The flight recorder is the forensic layer: every scheduler decision,
dispatch, fault, preemption, migration and restart appends one plain
tuple to a fixed-size ``collections.deque`` — O(1), no locking, no
device traffic — so when the EngineDead path or a persistent-fault
quarantine fires, the last ``capacity`` control-plane events are still
in memory and can be dumped next to a metrics snapshot, the per-request
status table and the journal tail as one self-contained JSON bundle
(``tools/postmortem.py`` renders it).

Design constraints, matching the metrics layer (metrics.py):

- zero cost when disabled: the engine holds ``None`` instead of a
  recorder, so a disabled engine executes no recorder code at all
  (raise-on-touch pinned in the port's observability tests);
- bounded cost when enabled: ``record()`` is one clock read plus one
  tuple append into a ``deque(maxlen=...)`` — no allocation beyond the
  event tuple itself, and eviction of the oldest event is free;
- no device sync: events carry host scalars that already exist
  (request ids, site names, counts) — never device tensors.

What a post-mortem bundle deliberately does NOT capture: generated
tokens and KV page contents. Exactly-once delivery state is owned by
the RequestJournal (recovery.py) — the bundle carries the journal
*tail* for cross-reference, not a second copy of the token stream.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "EVENT_KINDS", "FlightRecorder", "POSTMORTEM_SCHEMA",
    "build_postmortem", "dump_postmortem",
]

# the closed vocabulary of event kinds the serving stack emits; the
# recorder itself accepts any string (forward compatibility), the
# constant is for tests and tools/postmortem.py rendering
EVENT_KINDS = (
    "schedule",     # scheduler decision chosen for a step
    "dispatch",     # a batch handed to a compiled executable
    "drain",        # a pending block's ONE host sync completed
    "fault",        # a guarded call raised (transient or fatal)
    "quarantine",   # requests failed after retry exhaustion
    "preempt",      # a running request parked for page pressure
    "terminal",     # a request reached a terminal status
    "restart",      # EngineSupervisor rebuilt the engine
    "dead",         # supervisor declared the engine dead
    "migrate",      # cluster moved a request off a dead replica
    "adopt",        # a surviving replica adopted a migrated request
    # training plane (observability/training.py)
    "train_step",   # one ZeRO train step completed (scalars only)
    "diverged",     # the divergence sentinel flagged a condition
)

POSTMORTEM_SCHEMA = "paddle_tpu.postmortem/v1"


class FlightRecorder:
    """Fixed-capacity ring of ``(seq, t, kind, payload)`` event tuples.

    ``seq`` is a monotonically increasing event number (survives ring
    eviction, so a bundle shows how many events were dropped), ``t`` is
    the recorder clock (``time.perf_counter`` by default — the same
    clock the engine's latency histograms use), ``kind`` is one of
    EVENT_KINDS, ``payload`` is a small dict of host scalars.
    """

    def __init__(self, capacity: int = 256, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1 (got {capacity})")
        self.capacity = int(capacity)
        self._clock = clock
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = 0

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def total_recorded(self) -> int:
        """Events recorded over the recorder's lifetime (>= len(self))."""
        return self._seq

    # ------------------------------------------------------------ hot path
    def record(self, kind: str, **payload) -> None:
        """Append one event. O(1); the only allocations are the payload
        dict and the event tuple. Safe in the serving hot path."""
        self._seq += 1
        self._ring.append((self._seq, self._clock(), kind, payload))

    # ----------------------------------------------------------- cold path
    def events(self) -> List[Dict[str, Any]]:
        """Ring contents oldest-first as JSON-able dicts."""
        return [
            {"seq": seq, "t": t, "kind": kind, **payload}
            for seq, t, kind, payload in self._ring
        ]

    def clear(self) -> None:
        self._ring.clear()


def _journal_tail(journal, n: int) -> List[Dict[str, Any]]:
    """Last ``n`` journal records as JSON-able dicts, newest last.
    Duck-typed: anything with ``request_ids()`` + ``record(rid)`` works;
    a journal-free engine contributes an empty tail."""
    if journal is None:
        return []
    try:
        rids = sorted(journal.request_ids())[-n:]
    except Exception:  # noqa: BLE001 — forensics must not throw
        return []
    out: List[Dict[str, Any]] = []
    for rid in rids:
        try:
            rec = journal.record(rid)
        except Exception:  # noqa: BLE001 — forensics must not throw
            continue
        if rec is None:
            continue
        delivered = getattr(rec, "delivered", None)
        out.append({
            "request_id": rid,
            "status": getattr(rec, "status", None),
            # count only — the bundle never carries token values
            "delivered_tokens": (len(delivered)
                                 if delivered is not None else None),
            "seed": getattr(rec, "seed", None),
            "error": getattr(rec, "error", None),
        })
    return out


def build_postmortem(reason: str, *,
                     recorder: Optional[FlightRecorder] = None,
                     registry=None,
                     requests: Optional[Iterable] = None,
                     journal=None,
                     journal_tail: int = 32,
                     info: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Assemble a JSON-able post-mortem bundle.

    ``requests`` is an iterable of scheduler Request objects (live and
    terminal alike); only their host-side bookkeeping is captured —
    never prompt/generated tokens (the journal owns exactly-once token
    state) and never KV pages.
    """
    req_rows: List[Dict[str, Any]] = []
    for req in (requests or ()):
        req_rows.append({
            "request_id": req.request_id,
            "status": req.status,
            "slo_class": getattr(req, "slo_class", None),
            "generated": len(req.generated),
            "preemptions": req.preemptions,
            "error": req.error,
        })
    bundle: Dict[str, Any] = {
        "schema": POSTMORTEM_SCHEMA,
        "reason": reason,
        "unix_time": time.time(),
        "events": recorder.events() if recorder is not None else [],
        "events_total": (recorder.total_recorded
                         if recorder is not None else 0),
        "ring_capacity": recorder.capacity if recorder is not None else 0,
        "metrics": registry.snapshot() if registry is not None else None,
        "requests": req_rows,
        "journal_tail": _journal_tail(journal, journal_tail),
        "info": dict(info or {}),
    }
    return bundle


def dump_postmortem(bundle: Dict[str, Any], directory: str,
                    prefix: str = "postmortem") -> str:
    """Write a bundle to ``directory`` (created if missing) and return
    the path. Filenames embed pid + ms timestamp + reason so concurrent
    replicas never collide: ``postmortem-<reason>-<pid>-<ms>.json``."""
    os.makedirs(directory, exist_ok=True)
    reason = "".join(
        c if c.isalnum() or c in "-_" else "_"
        for c in str(bundle.get("reason", "unknown")))[:48] or "unknown"
    stamp = int(time.time() * 1000)
    path = os.path.join(
        directory, f"{prefix}-{reason}-{os.getpid()}-{stamp}.json")
    # never clobber an earlier bundle from the same ms
    k = 0
    while os.path.exists(path):
        k += 1
        path = os.path.join(
            directory, f"{prefix}-{reason}-{os.getpid()}-{stamp}.{k}.json")
    with open(path, "w") as f:
        json.dump(bundle, f, indent=1, sort_keys=True)
    return path
