"""paddle_tpu_torch.profiler: scheduling windows, RecordEvent, chrome-trace
export and summary tables (the port of paddle_tpu.profiler).

Two tracers, as in the reference: the HOST tracer is ours (timestamped
event intervals per thread on the `time.perf_counter` clock, exported as
chrome://tracing JSON and summarized), and the DEVICE tracer is
`torch.profiler` (CUPTI: every CUDA kernel, the port's hand-written ones
included), started and stopped around the armed window and written as
its own `*.pt.trace.json`. While a window is armed, `RecordEvent` also
enters `torch.profiler.record_function(name)`, so each host span appears
in the device trace on the same timeline as the kernels it launched. A
disarmed `RecordEvent` touches no `torch.profiler` code: the serving
engine opens one per dispatch.

The reference's C++ host sink (its native tracer) is not ported: every
span lands in the Python sink, which is the reference's own fallback.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from enum import Enum
from typing import Callable, Iterable, Optional

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
    "add_host_span",
    "make_scheduler", "export_chrome_tracing", "export_protobuf",
    "load_profiler_result", "SortedKeys", "SummaryView",
    "profiler_summary",
]


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3  # last active step of a window


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5


class SummaryView(Enum):
    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6


# ---------------------------------------------------------------- host tracer

class _HostEvent:
    __slots__ = ("name", "start", "end", "tid", "event_type")

    def __init__(self, name, start, end, tid, event_type):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid
        self.event_type = event_type


class _HostTracer:
    """Process-wide host event sink: a list of completed spans, filled only
    while a profiler window is armed and emptied by `drain()`."""

    def __init__(self):
        self.events: list = []
        self.armed = False
        self._lock = threading.Lock()

    def set_armed(self, armed: bool):
        self.armed = armed

    def add(self, ev: _HostEvent):
        with self._lock:
            self.events.append(ev)

    def drain(self) -> list:
        with self._lock:
            out = self.events
            self.events = []
        out.sort(key=lambda e: e.start)
        return out


_HOST_TRACER = _HostTracer()


def add_host_span(name: str, start: float, end: float, tid=None,
                  event_type: str = "UserDefined") -> None:
    """Record an already-completed host span with explicit perf_counter
    timestamps into the armed profiler window (no-op when no window is
    armed). The observability LifecycleTracker folds per-request serving
    lifecycle spans into chrome-trace exports through this, alongside
    RecordEvent spans."""
    if not _HOST_TRACER.armed:
        return
    _HOST_TRACER.add(_HostEvent(
        name, float(start), float(end),
        tid if tid is not None else threading.get_ident(), event_type))


class RecordEvent:
    """Context manager / start-stop host span (paddle.profiler.RecordEvent).

    Usable as `with RecordEvent('fwd'): ...` or begin()/end(). While a
    window is armed it also enters `torch.profiler.record_function`, so the
    span shows in the device trace; disarmed, it reads the clock and
    nothing else.
    """

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._start: Optional[float] = None
        self._annotation = None

    def begin(self):
        self._start = time.perf_counter()
        if _HOST_TRACER.armed:
            try:
                import torch.profiler

                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:  # noqa: BLE001 (the device annotation is
                # optional; the host span records either way)
                self._annotation = None
        return self

    def end(self):
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        if self._start is None:
            return
        if _HOST_TRACER.armed:
            _HOST_TRACER.add(_HostEvent(
                self.name, self._start, time.perf_counter(),
                threading.get_ident(), self.event_type))
        self._start = None

    __enter__ = begin

    def __exit__(self, *exc):
        self.end()
        return False


# ----------------------------------------------------------------- scheduler

def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """Step-number -> state, cycling (closed, ready, record) `repeat` times
    (0 = forever), after `skip_first` warm steps. Paddle/torch-compatible."""
    if record <= 0:
        raise ValueError("record window must be >= 1")
    cycle = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        step -= skip_first
        if repeat > 0 and step >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = step % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def _default_schedule(step: int) -> ProfilerState:
    return ProfilerState.RECORD  # profile everything until stop()


# ------------------------------------------------------------------ exporters

def export_chrome_tracing(dir_name: str, worker_name: str = None
                          ) -> Callable[["Profiler"], None]:
    """on_trace_ready callback: write the window's host spans as
    chrome://tracing JSON, one file per window."""

    def handle(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        fname = (f"{worker_name or 'worker'}_pid{os.getpid()}"
                 f"_step{prof.step_num}.pt.trace.json")
        path = os.path.join(dir_name, fname)
        trace_events = []
        for ev in prof._window_events:
            trace_events.append({
                "name": ev.name, "ph": "X", "cat": ev.event_type,
                "ts": ev.start * 1e6, "dur": (ev.end - ev.start) * 1e6,
                "pid": os.getpid(), "tid": ev.tid,
            })
        with open(path, "w") as f:
            json.dump({"traceEvents": trace_events,
                       "displayTimeUnit": "ms"}, f)
        prof._last_export = path

    return handle


def export_protobuf(dir_name: str, worker_name: str = None):
    """Device traces already land as torch.profiler chrome traces under the
    profiler's trace directory; this callback just notes the path."""

    def handle(prof: "Profiler"):
        prof._last_export = prof._device_trace_dir

    return handle


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


# ------------------------------------------------------------------- profiler

class Profiler:
    """paddle.profiler.Profiler over the host tracer + torch.profiler.

    with Profiler(scheduler=make_scheduler(closed=1, ready=1, record=2),
                  on_trace_ready=export_chrome_tracing('./log')) as p:
        for batch in loader:
            train_step(batch)
            p.step()

    Unless `timer_only`, each armed window also runs a
    `torch.profiler.profile` over the CPU and (with a card) CUDA
    activities; at the window's end its trace is written to
    `<profile_dir>/paddle_tpu_torch_profile_<pid>_<step>/device.pt.trace.json`
    (`device_trace_path`). `profile_dir` defaults to
    `$PADDLE_TPU_PROFILE_DIR`, else the temporary directory.
    """

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready: Optional[Callable] = None,
                 record_shapes: bool = False, profile_memory: bool = False,
                 timer_only: bool = False,
                 profile_dir: Optional[str] = None, **kwargs):
        if isinstance(scheduler, (tuple, list)):
            lo, hi = scheduler
            scheduler = make_scheduler(closed=lo, ready=0, record=hi - lo,
                                       repeat=1)
        self.scheduler = scheduler or _default_schedule
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.profile_dir = profile_dir
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._window_events: list = []
        self._all_events: list = []
        self._step_times: list = []
        self._last_step_ts: Optional[float] = None
        self._device_tracing = False
        self._device_trace_dir = None
        self._torch_prof = None
        self.device_trace_path: Optional[str] = None
        self._last_export = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        self.current_state = self.scheduler(self.step_num)
        self._transition(ProfilerState.CLOSED, self.current_state)
        self._last_step_ts = time.perf_counter()
        return self

    def stop(self):
        self._transition(self.current_state, ProfilerState.CLOSED,
                         closing=True)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_ts is not None:
            self._step_times.append(now - self._last_step_ts)
        self._last_step_ts = now
        prev = self.current_state
        self.step_num += 1
        self.current_state = self.scheduler(self.step_num)
        self._transition(prev, self.current_state)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- state machinery ----------------------------------------------------
    def _recording(self, state):
        return state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)

    def _transition(self, prev, new, closing=False):
        was = self._recording(prev)
        now = self._recording(new) and not closing
        if not was and now:
            self._arm()
        window_closed = was and (not now or
                                 prev == ProfilerState.RECORD_AND_RETURN)
        if window_closed:
            self._disarm()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            self._window_events = []
            if now:  # back-to-back windows (RECORD_AND_RETURN -> RECORD)
                self._arm()

    def _arm(self):
        _HOST_TRACER.set_armed(True)
        if not self.timer_only:
            try:
                import torch
                from torch.profiler import ProfilerActivity, profile

                self._device_trace_dir = os.path.join(
                    self.profile_dir
                    or os.environ.get("PADDLE_TPU_PROFILE_DIR")
                    or tempfile.gettempdir(),
                    f"paddle_tpu_torch_profile_{os.getpid()}"
                    f"_{self.step_num}")
                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                self._torch_prof = profile(
                    activities=activities, record_shapes=self.record_shapes,
                    profile_memory=self.profile_memory)
                self._torch_prof.start()
                self._device_tracing = True
            except Exception as e:  # noqa: BLE001 (degrade to host-only,
                # but loudly: the caller asked for a device trace)
                import warnings

                warnings.warn(
                    f"device trace unavailable ({type(e).__name__}: {e}); "
                    f"profiler continues with host-side timing only",
                    RuntimeWarning, stacklevel=2)
                self._torch_prof = None
                self._device_tracing = False

    def _disarm(self):
        _HOST_TRACER.set_armed(False)
        evs = _HOST_TRACER.drain()
        self._window_events.extend(evs)
        self._all_events.extend(evs)
        if self._device_tracing:
            prof, self._torch_prof = self._torch_prof, None
            self._device_tracing = False
            try:
                prof.stop()
                os.makedirs(self._device_trace_dir, exist_ok=True)
                path = os.path.join(self._device_trace_dir,
                                    "device.pt.trace.json")
                prof.export_chrome_trace(path)
                self.device_trace_path = path
            except Exception:  # noqa: BLE001 (stop is best-effort: the
                # trace may be partial after a device fault)
                pass

    # -- reporting ----------------------------------------------------------
    def export(self, path: str, format: str = "json"):
        export_chrome_tracing(os.path.dirname(path) or ".",
                              os.path.basename(path))(self)

    def summary(self, sorted_by: SortedKeys = SortedKeys.CPUTotal,
                op_detail: bool = True, thread_sep: bool = False,
                time_unit: str = "ms", views=None) -> str:
        """Event statistics table (profiler_statistic analog)."""
        unit = {"s": 1.0, "ms": 1e3, "us": 1e6}[time_unit]
        stats = {}
        for ev in self._all_events:
            tot, cnt, mx = stats.get(ev.name, (0.0, 0, 0.0))
            d = ev.end - ev.start
            stats[ev.name] = (tot + d, cnt + 1, max(mx, d))
        order = sorted(stats.items(),
                       key=lambda kv: kv[1][0], reverse=True)
        lines = [
            f"{'Name':<40}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
            f"{'Avg(' + time_unit + ')':>14}{'Max(' + time_unit + ')':>14}",
            "-" * 90,
        ]
        for name, (tot, cnt, mx) in order:
            lines.append(f"{name[:39]:<40}{cnt:>8}{tot * unit:>14.3f}"
                         f"{tot / cnt * unit:>14.3f}{mx * unit:>14.3f}")
        if self._step_times:
            st = self._step_times
            lines += ["-" * 90,
                      f"steps: {len(st)}  avg {sum(st) / len(st) * unit:.3f}"
                      f"{time_unit}  min {min(st) * unit:.3f}{time_unit}  "
                      f"max {max(st) * unit:.3f}{time_unit}"]
        return "\n".join(lines)


def profiler_summary(prof: Profiler, **kwargs) -> str:
    return prof.summary(**kwargs)
