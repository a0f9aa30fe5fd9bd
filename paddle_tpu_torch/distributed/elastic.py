"""Elastic membership and failure detection (counterpart of
paddle_tpu/distributed/elastic.py:1-174, copied: it is host-only).

Paddle's ElasticManager keeps node liveness in etcd (heartbeat leases),
emits scale-in / scale-out events and regenerates the trainer endpoints.
This keeps the same state machine over a shared heartbeat directory:

- workers call :func:`start_heartbeat` (a daemon thread stamping
  ``worker_<rank>.hb``);
- the :class:`ElasticManager` scans the directory, tracks membership and
  emits ``JOIN`` / ``DEAD`` / ``LEAVE`` / ``SCALE_UP`` / ``SCALE_DOWN``
  events to registered callbacks;
- ``endpoints()`` regenerates PADDLE_TRAINER_ENDPOINTS for the surviving
  membership, the input to a restart with a new world.

fleetrun (`distributed.launch`) runs it under ``--elastic_dir``: its watch
loop scans between polls of its ranks and logs membership transitions.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Event", "ElasticManager", "start_heartbeat"]


class Event:
    JOIN = "join"
    LEAVE = "leave"          # clean exit (heartbeat file removed)
    DEAD = "dead"            # heartbeat timeout — failure detection
    SCALE_UP = "scale_up"
    SCALE_DOWN = "scale_down"

    def __init__(self, kind: str, rank: int, world: List[int]):
        self.kind = kind
        self.rank = rank
        self.world = list(world)

    def __repr__(self):
        return f"Event({self.kind}, rank={self.rank}, world={self.world})"


def _hb_path(job_dir: str, rank: int) -> str:
    return os.path.join(job_dir, f"worker_{rank}.hb")


def start_heartbeat(job_dir: Optional[str] = None,
                    rank: Optional[int] = None,
                    interval: float = 1.0) -> Callable[[], None]:
    """Stamp this worker's heartbeat file on a daemon thread.

    Returns a stop() callable that also REMOVES the file — a clean LEAVE,
    distinct from going silent (DEAD). Reads PADDLE_ELASTIC_DIR /
    PADDLE_TRAINER_ID when args are omitted (the launcher contract).
    """
    job_dir = job_dir or os.environ.get("PADDLE_ELASTIC_DIR")
    if not job_dir:
        return lambda: None   # elasticity not enabled for this job
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else rank
    os.makedirs(job_dir, exist_ok=True)
    path = _hb_path(job_dir, rank)
    stop_evt = threading.Event()

    def beat():
        while not stop_evt.is_set():
            # atomic replace: a scan between truncate and write would read
            # an empty/partial stamp and emit a false DEAD
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(str(time.time()))
            os.replace(tmp, path)
            stop_evt.wait(interval)

    t = threading.Thread(target=beat, daemon=True)
    t.start()

    def stop():
        stop_evt.set()
        t.join(timeout=5)
        try:
            os.remove(path)
        except OSError:
            pass

    return stop


class ElasticManager:
    """Membership tracker + event source over the heartbeat directory."""

    def __init__(self, job_dir: str, np_expected: Optional[int] = None,
                 dead_timeout: float = 5.0,
                 base_endpoint: str = "127.0.0.1:49600"):
        self.job_dir = job_dir
        self.np_expected = np_expected
        self.dead_timeout = dead_timeout
        self.base_endpoint = base_endpoint
        os.makedirs(job_dir, exist_ok=True)
        self._alive: Dict[int, float] = {}    # rank -> last stamp
        self._callbacks: Dict[str, List[Callable]] = {}

    def on(self, kind: str, callback: Callable[[Event], None]):
        self._callbacks.setdefault(kind, []).append(callback)
        return callback

    def _emit(self, events: List[Event]):
        for ev in events:
            for cb in self._callbacks.get(ev.kind, []):
                cb(ev)
        return events

    def scan(self) -> List[Event]:
        """One pass: read heartbeat files, diff against known membership."""
        now = time.time()
        seen: Dict[int, float] = {}
        for name in os.listdir(self.job_dir):
            if not (name.startswith("worker_") and name.endswith(".hb")):
                continue
            rank = int(name[len("worker_"):-len(".hb")])
            try:
                with open(os.path.join(self.job_dir, name)) as f:
                    seen[rank] = float(f.read().strip() or 0)
            except (OSError, ValueError):
                continue

        events: List[Event] = []
        before = set(self._alive)
        # joins
        for rank, stamp in seen.items():
            if rank not in self._alive and now - stamp <= self.dead_timeout:
                self._alive[rank] = stamp
                events.append(Event(Event.JOIN, rank, sorted(self._alive)))
        # clean leaves (file removed) and deads (file stale)
        for rank in list(self._alive):
            if rank not in seen:
                del self._alive[rank]
                events.append(Event(Event.LEAVE, rank, sorted(self._alive)))
            elif now - seen[rank] > self.dead_timeout:
                del self._alive[rank]
                events.append(Event(Event.DEAD, rank, sorted(self._alive)))
            else:
                self._alive[rank] = seen[rank]
        # scale transitions relative to the expected world
        if self.np_expected is not None:
            crossed_up = (len(before) < self.np_expected
                          <= len(self._alive))
            crossed_down = (len(before) >= self.np_expected
                            > len(self._alive))
            if crossed_up:
                events.append(Event(Event.SCALE_UP, -1,
                                    sorted(self._alive)))
            if crossed_down:
                events.append(Event(Event.SCALE_DOWN, -1,
                                    sorted(self._alive)))
        return self._emit(events)

    def membership(self) -> List[int]:
        return sorted(self._alive)

    def is_healthy(self) -> bool:
        return (self.np_expected is None
                or len(self._alive) >= self.np_expected)

    def endpoints(self) -> str:
        """Regenerated PADDLE_TRAINER_ENDPOINTS for the current membership
        (densely re-ranked — the restart-with-new-world input)."""
        host, port = self.base_endpoint.rsplit(":", 1)
        return ",".join(f"{host}:{int(port) + i}"
                        for i, _ in enumerate(self.membership()))
