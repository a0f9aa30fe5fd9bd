"""SLO classes, goodput accounting and windowed percentiles (the port's
own copy of paddle_tpu/observability/slo.py).

Raw throughput is the wrong autoscaling signal: a replica can push
tokens at full rate while every one of them lands *after* its
deadline. This module adds the latency-aware layer ROADMAP item 4's
router/autoscaler consumes:

- **SLO classes**: ``SloClass(name, ttft_target_s, tpot_target_s)``
  registered on the engine; requests opt in via
  ``add_request(slo_class=...)``. Per-class TTFT/TPOT land in labelled
  histograms (``serving_slo_ttft_seconds{slo_class=...}``) next to the
  class-blind ones the engine already keeps.
- **Goodput**: ``serving_slo_goodput_tokens_total`` counts only tokens
  delivered within their class target (first token judged against
  TTFT, decode tokens against TPOT) — goodput vs the raw
  ``serving_tokens_generated_total`` is the overload signal.
- **Windowed percentiles**: ``HistogramWindow`` anchors a copy of a
  log-bucket histogram's counts and computes percentiles over the
  *delta* since the anchor — a sliding-window view with NO new
  histogram type and no per-observation cost (the window pays
  O(buckets) only at refresh). ``serving_slo_attainment`` gauges
  (labels ``slo_class`` + ``slo`` in {ttft, tpot}) are recomputed from
  the window every ``refresh_every`` hot-path ticks.

Hot-path discipline matches metrics.py: ``first_token`` /
``decode_tokens`` / ``step_tick`` are one dict lookup + a handful of
float compares and histogram observes — no allocation, no device
traffic: the tracker reads host floats the engine already holds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

from .metrics import Histogram, MetricsRegistry

__all__ = ["SloClass", "SloTracker", "HistogramWindow"]


@dataclass(frozen=True)
class SloClass:
    """One request class and its latency targets (seconds). A class
    with ``ttft_target_s=0.5, tpot_target_s=0.05`` promises the first
    token within 500 ms and a sustained 20 tok/s after that."""

    name: str
    ttft_target_s: float
    tpot_target_s: float

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO class needs a non-empty name")
        if self.ttft_target_s <= 0 or self.tpot_target_s <= 0:
            raise ValueError(
                f"SLO targets must be positive (got ttft="
                f"{self.ttft_target_s}, tpot={self.tpot_target_s})")


class HistogramWindow:
    """Sliding-window view over one fixed-log-bucket ``Histogram``.

    ``anchor()`` copies the histogram's bucket counts; ``percentile``/
    ``fraction_within``/``summary`` then answer over the observations
    that arrived SINCE the anchor, by subtracting the anchored counts
    from the live ones. Same geometric-interpolation estimator as
    ``Histogram.percentile`` (and the same ~bucket-growth relative
    error bound), minus the exact min/max clamp — a window does not
    track exact extrema, so estimates are clamped to bucket edges only.
    """

    def __init__(self, hist: Histogram):
        self._h = hist
        self._anchor_counts: List[int] = [0] * len(hist._counts)
        self._anchor_count = 0
        self._anchor_sum = 0.0

    def anchor(self) -> None:
        """Start a new window at 'now'."""
        h = self._h
        self._anchor_counts = list(h._counts)
        self._anchor_count = h._count
        self._anchor_sum = h._sum

    @property
    def count(self) -> int:
        return self._h._count - self._anchor_count

    @property
    def sum(self) -> float:
        return self._h._sum - self._anchor_sum

    def _delta(self) -> List[int]:
        anchored = self._anchor_counts
        return [c - anchored[i] for i, c in enumerate(self._h._counts)]

    def percentile(self, q: float) -> float:
        """q-th percentile (q in [0, 100]) of the windowed observations,
        estimated exactly as Histogram.percentile over the bucket
        deltas (underflow reports ``lo``, overflow reports ``hi``)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile out of range: {q}")
        n = self.count
        if n == 0:
            return 0.0
        h = self._h
        target = max(1, math.ceil(q / 100.0 * n))
        cum = 0
        for i, c in enumerate(self._delta()):
            if c == 0:
                continue
            if cum + c >= target:
                if i == 0:
                    return h.lo
                if i > h.num_buckets:
                    return h.hi
                lower = h.lo * h.growth ** (i - 1)
                frac = (target - cum) / c
                return lower * h.growth ** frac
            cum += c
        return h.hi  # unreachable unless counts were mutated mid-walk

    def fraction_within(self, limit: float) -> float:
        """Estimated fraction of windowed observations <= ``limit``
        (goodput attainment for a target of ``limit`` seconds).
        Buckets fully below the limit count whole; the covering bucket
        contributes geometrically-interpolated mass."""
        n = self.count
        if n == 0:
            return 1.0  # vacuous: nothing observed, nothing violated
        h = self._h
        within = 0.0
        for i, c in enumerate(self._delta()):
            if c == 0:
                continue
            if i == 0:
                lower, upper = 0.0, h.lo
            elif i > h.num_buckets:
                lower, upper = h.hi, math.inf
            else:
                lower = h.lo * h.growth ** (i - 1)
                upper = h.lo * h.growth ** i
            if upper <= limit:
                within += c
            elif lower < limit:
                if i == 0 or i > h.num_buckets:
                    within += c * 0.5  # open-ended bucket: no shape info
                else:
                    within += c * (math.log(limit / lower) / h._log_g)
        return min(within / n, 1.0)

    def summary(self, percentiles=(50.0, 95.0, 99.0)) -> Dict[str, float]:
        n = self.count
        if n == 0:
            return Histogram.empty_summary(percentiles)
        out = {"count": n, "sum": self.sum, "mean": self.sum / n,
               "min": 0.0, "max": 0.0}
        for p in percentiles:
            out[f"p{p:g}"] = self.percentile(p)
        return out


class _ClassState:
    """Resolved-once handles for one SLO class (the metrics.py
    discipline: no registry lookups on the hot path)."""

    __slots__ = ("cls", "ttft_hist", "tpot_hist", "ttft_window",
                 "tpot_window", "attain_ttft", "attain_tpot", "goodput")

    def __init__(self, cls: SloClass, registry: MetricsRegistry):
        self.cls = cls
        lab = {"slo_class": cls.name}
        self.ttft_hist = registry.histogram(
            "serving_slo_ttft_seconds",
            "per-SLO-class time to first token", labels=lab)
        self.tpot_hist = registry.histogram(
            "serving_slo_tpot_seconds",
            "per-SLO-class time per output token", labels=lab)
        self.ttft_window = HistogramWindow(self.ttft_hist)
        self.tpot_window = HistogramWindow(self.tpot_hist)
        self.attain_ttft = registry.gauge(
            "serving_slo_attainment",
            "windowed fraction of observations within the class target",
            labels={"slo_class": cls.name, "slo": "ttft"})
        self.attain_tpot = registry.gauge(
            "serving_slo_attainment",
            "windowed fraction of observations within the class target",
            labels={"slo_class": cls.name, "slo": "tpot"})
        self.attain_ttft.set(1.0)
        self.attain_tpot.set(1.0)
        self.goodput = registry.counter(
            "serving_slo_goodput_tokens_total",
            "tokens delivered within their SLO-class target", labels=lab)


class SloTracker:
    """Per-class SLO accounting over one MetricsRegistry.

    The engine calls ``first_token`` / ``decode_tokens`` from its
    latency observation sites and ``step_tick`` once per step; the
    tracker refreshes attainment gauges from the sliding windows every
    ``refresh_every`` ticks (and on ``stats()`` via ``refresh``).
    Unknown/absent classes are ignored — SLO accounting is opt-in per
    request.
    """

    def __init__(self, registry: MetricsRegistry,
                 classes: Iterable[SloClass],
                 refresh_every: int = 64):
        if refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1 (got {refresh_every})")
        self._states: Dict[str, _ClassState] = {}
        for cls in classes:
            if cls.name in self._states:
                raise ValueError(f"duplicate SLO class {cls.name!r}")
            self._states[cls.name] = _ClassState(cls, registry)
        if not self._states:
            raise ValueError("SloTracker needs at least one SLO class")
        self._goodput_total = registry.counter(
            "serving_slo_goodput_tokens_total",
            "tokens delivered within SLO across all classes")
        self._refresh_every = int(refresh_every)
        self._ticks = 0

    @property
    def class_names(self):
        return tuple(self._states)

    def has_class(self, name: Optional[str]) -> bool:
        return name in self._states

    # ------------------------------------------------------------ hot path
    def first_token(self, slo_class: Optional[str], ttft_s: float) -> None:
        st = self._states.get(slo_class)
        if st is None:
            return
        st.ttft_hist.observe(ttft_s)
        if ttft_s <= st.cls.ttft_target_s:
            st.goodput.inc()
            self._goodput_total.inc()

    def decode_tokens(self, slo_class: Optional[str], per_token_s: float,
                      k: int) -> None:
        st = self._states.get(slo_class)
        if st is None:
            return
        for _ in range(k):
            st.tpot_hist.observe(per_token_s)
        if per_token_s <= st.cls.tpot_target_s:
            st.goodput.inc(k)
            self._goodput_total.inc(k)

    def step_tick(self) -> None:
        """One per engine step: an int bump + compare, with the O(buckets)
        window refresh amortized to every ``refresh_every`` steps."""
        self._ticks += 1
        if self._ticks >= self._refresh_every:
            self._ticks = 0
            self.refresh()

    # ----------------------------------------------------------- cold path
    def refresh(self, advance: bool = True) -> None:
        """Recompute attainment gauges from the current windows; with
        ``advance`` the windows re-anchor, sliding forward."""
        for st in self._states.values():
            st.attain_ttft.set(
                st.ttft_window.fraction_within(st.cls.ttft_target_s))
            st.attain_tpot.set(
                st.tpot_window.fraction_within(st.cls.tpot_target_s))
            if advance:
                st.ttft_window.anchor()
                st.tpot_window.anchor()

    def summary(self) -> Dict[str, Dict[str, object]]:
        """stats()-ready per-class view: targets, windowed TTFT/TPOT
        percentiles (current, un-advanced window), attainment gauges,
        goodput counter."""
        out: Dict[str, Dict[str, object]] = {}
        for name, st in self._states.items():
            out[name] = {
                "targets": {"ttft_s": st.cls.ttft_target_s,
                            "tpot_s": st.cls.tpot_target_s},
                "window": {"ttft": st.ttft_window.summary(),
                           "tpot": st.tpot_window.summary()},
                "lifetime": {"ttft": st.ttft_hist.summary(),
                             "tpot": st.tpot_hist.summary()},
                "attainment": {"ttft": st.attain_ttft.value,
                               "tpot": st.attain_tpot.value},
                "goodput_tokens": st.goodput.value,
            }
        return out

    @property
    def goodput_tokens(self) -> int:
        return self._goodput_total.value
