"""Per-request lifecycle spans: enqueue -> admission -> prefill -> first
token -> decode blocks -> finish / preempt / requeue.

Every span/point carries the request id in its NAME
(`serving.request[<rid>].<stage>`) and is folded into the
paddle_tpu_torch.profiler host tracer (`add_host_span`), so a chrome-trace
export of a serving run shows scheduler decisions per request on the
same timeline as the `serving.prefill` / `serving.decode_block` /
`serving.host_drain` RecordEvent spans — and
`tools/trace_summary.py --requests` reconstructs per-request timelines
from the exported file.

The tracker also RETAINS stage transitions locally (capped per request,
so a long-running engine stays bounded) for stats/tests independent of
whether a profiler window happens to be armed; high-volume spans
(per-block decode spans) are emitted to the tracer only (`retain=False`).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LifecycleTracker"]


class LifecycleTracker:
    def __init__(self, max_events_per_request: int = 512,
                 tag: Optional[str] = None):
        self.max_events_per_request = max_events_per_request
        # deployment tag appended to every EMITTED span name
        # (`serving.request[rid].stage@tag`, e.g. tag="tp=2"); the
        # locally retained events keep the plain stage so stats/tests
        # are tag-agnostic. The host tracer's events carry only a name,
        # so the tag rides in the name by design.
        self.tag = tag
        # rid -> [(stage, t0, t1)] in emission order; points have t0 == t1
        self._events: Dict[int, List[Tuple[str, float, float]]] = {}
        self._dropped = 0

    @staticmethod
    def span_name(rid: int, stage: str) -> str:
        return f"serving.request[{rid}].{stage}"

    @property
    def dropped(self) -> int:
        return self._dropped

    def span(self, rid: int, stage: str, start: float, end: float,
             retain: bool = True) -> None:
        from ..profiler import add_host_span

        name = self.span_name(rid, stage)
        if self.tag:
            name = f"{name}@{self.tag}"
        add_host_span(name, start, end, event_type="RequestLifecycle")
        if not retain:
            return
        lst = self._events.setdefault(rid, [])
        if len(lst) < self.max_events_per_request:
            lst.append((stage, start, end))
        else:
            self._dropped += 1

    def point(self, rid: int, stage: str, t: float = None,
              retain: bool = True) -> None:
        if t is None:
            t = time.perf_counter()
        self.span(rid, stage, t, t, retain=retain)

    # ------------------------------------------------------------ queries
    def request_ids(self) -> List[int]:
        return sorted(self._events)

    def events(self, rid: int) -> List[Tuple[str, float, float]]:
        return list(self._events.get(rid, ()))

    def stages(self, rid: int) -> List[str]:
        return [stage for stage, _, _ in self._events.get(rid, ())]

    def timeline(self, rid: int) -> str:
        """Human-readable per-request timeline (ms relative to the first
        recorded event)."""
        evs = self._events.get(rid, ())
        if not evs:
            return f"request {rid}: no recorded lifecycle events"
        t0 = evs[0][1]
        lines = [f"request {rid}:"]
        for stage, a, b in evs:
            dur = f" ({(b - a) * 1e3:.3f} ms)" if b > a else ""
            lines.append(f"  +{(a - t0) * 1e3:9.3f} ms  {stage}{dur}")
        return "\n".join(lines)
