"""paddle_tpu_torch.observability: metrics and request-lifecycle telemetry
(the port of paddle_tpu.observability).

- `metrics`: `MetricsRegistry` of `Counter` / `Gauge` / `Histogram`
  (fixed log buckets, p50 / p95 / p99 estimates), the single source behind
  `ServingEngine.stats()`;
- `export`: Prometheus text exposition and the JSON snapshot round trip;
- `lifecycle`: `LifecycleTracker`, per-request spans
  (`serving.request[<rid>].<stage>`) folded into the paddle_tpu_torch
  profiler's host tracer;
- `slo`: `SloClass` / `SloTracker`, per-class TTFT / TPOT targets,
  goodput and windowed attainment gauges;
- `flight_recorder`: `FlightRecorder`, a bounded ring of control-plane
  events, and the JSON post-mortem bundles (`tools/postmortem.py` renders
  them).

- `training`: the ZeRO trainer's plane (`TrainingTelemetry`,
  `DivergenceSentinel`, `TrainingDiverged`), imported only by a trainer
  that turns telemetry on (not re-exported here).

`global_registry()` is the process-wide registry for library-level
signals; each ServingEngine keeps its own registry by default so
per-engine stats never mix.
"""
from __future__ import annotations

import threading
from typing import Optional

from .export import registry_from_snapshot, to_prometheus
from .flight_recorder import FlightRecorder, build_postmortem, \
    dump_postmortem
from .lifecycle import LifecycleTracker
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .slo import HistogramWindow, SloClass, SloTracker

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LifecycleTracker", "to_prometheus", "registry_from_snapshot",
    "global_registry",
    "SloClass", "SloTracker", "HistogramWindow",
    "FlightRecorder", "build_postmortem", "dump_postmortem",
]

_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def global_registry() -> MetricsRegistry:
    """Lazily-created process-wide registry (library-level counters that
    have no owning engine)."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = MetricsRegistry()
    return _GLOBAL
