"""Counters, gauges and fixed-log-bucket histograms over one registry
(the port's own copy of paddle_tpu/observability/metrics.py, without the
Prometheus exporter).

Every counter the serving engine, scheduler and allocator report lives in
ONE `MetricsRegistry`; `ServingEngine.stats()` is a thin view over it.

Design constraints, in order:

- near-zero cost when disabled: callers resolve metric handles ONCE (at
  engine construction) and hold them; a metrics-disabled engine holds no
  handles at all, so its hot path does literally no registry work
  (the port's serving tests pin this);
- bounded cost when enabled: a counter inc is one float add, a histogram
  observe is one `math.log` plus one list index — no allocation, no
  locking on the hot path (the serving loop is single-controller; the
  registry lock only guards get-or-create);
- bounded memory: histograms are FIXED log-spaced buckets
  (`lo * growth**i`), so percentile estimation (p50/p95/p99 via
  geometric interpolation inside the covering bucket) costs O(buckets)
  with relative error bounded by the bucket growth factor (~19% at the
  default `growth=2**0.25`), independent of how many values were
  observed.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# (name, sorted label items) — one registry slot per labelled series
_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class Counter:
    """Monotonic counter. `inc(n)` with n >= 0 (ints stay ints, so
    token/step counts survive JSON round-trips unchanged; float
    increments — wall-time accumulators — promote naturally)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0

    @property
    def value(self):
        return self._value

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} can only go up (n={n})")
        self._value += n


class Gauge:
    """Point-in-time value (queue depth, free pages, utilization)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0

    @property
    def value(self):
        return self._value

    def set(self, v) -> None:
        self._value = v

    def inc(self, n=1) -> None:
        self._value += n

    def dec(self, n=1) -> None:
        self._value -= n


class Histogram:
    """Fixed log-bucket histogram with percentile estimation.

    Buckets: [0] catches v < lo (underflow — zero/negative/sub-resolution
    values); [1 + i] covers [lo * growth**i, lo * growth**(i+1)) for
    i in 0..n-1; [-1] catches v >= hi (overflow). Defaults cover 10 µs
    to 10 min in ~19%-wide buckets (104 of them) — latency-shaped.

    `percentile(q)` (q in [0, 100]) finds the covering bucket by
    cumulative count and interpolates GEOMETRICALLY inside it (exact for
    log-uniform data, bounded by the bucket ratio otherwise), then clamps
    to the exactly-tracked [min, max] so point masses report exactly.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 lo: float = 1e-5, hi: float = 600.0,
                 growth: float = 2 ** 0.25):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError(
                f"need 0 < lo < hi and growth > 1 (got lo={lo}, hi={hi}, "
                f"growth={growth})")
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.lo = float(lo)
        self.hi = float(hi)
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.num_buckets = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_g))
        self._counts = [0] * (self.num_buckets + 2)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def observe(self, v) -> None:
        v = float(v)
        if v != v:          # NaN: drop rather than poison sum/percentiles
            return
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v < self.lo:
            i = 0
        elif v >= self.hi:
            i = self.num_buckets + 1
        else:
            i = 1 + min(int(math.log(v / self.lo) / self._log_g),
                        self.num_buckets - 1)
        self._counts[i] += 1

    def bucket_upper_bound(self, i: int) -> float:
        """Upper edge of counts[i] (inf for the overflow bucket)."""
        if i <= 0:
            return self.lo
        if i > self.num_buckets:
            return math.inf
        return self.lo * self.growth ** i

    def percentile(self, q: float) -> float:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile out of range: {q}")
        if self._count == 0:
            return 0.0
        target = max(1, math.ceil(q / 100.0 * self._count))
        cum = 0
        est = self._max
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                if i == 0:
                    est = self.lo
                elif i > self.num_buckets:
                    est = self.hi
                else:
                    lower = self.lo * self.growth ** (i - 1)
                    frac = (target - cum) / c
                    est = lower * self.growth ** frac
                break
            cum += c
        return max(min(est, self._max), self._min)

    def summary(self, percentiles=(50.0, 95.0, 99.0)) -> Dict[str, float]:
        """Compact stats()-ready view: count/sum/mean/min/max + p50/p95/
        p99 (seconds for the serving latency histograms)."""
        if self._count == 0:
            return self.empty_summary(percentiles)
        out = {"count": self._count, "sum": self._sum,
               "mean": self._sum / self._count,
               "min": self._min, "max": self._max}
        for p in percentiles:
            out[f"p{p:g}"] = self.percentile(p)
        return out

    @classmethod
    def empty_summary(cls, percentiles=(50.0, 95.0, 99.0)
                      ) -> Dict[str, float]:
        out = {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0, "max": 0.0}
        for p in percentiles:
            out[f"p{p:g}"] = 0.0
        return out


class MetricsRegistry:
    """Get-or-create registry of named (optionally labelled) metrics.

    One registry per ServingEngine by default (so per-engine stats never
    mix). The lock guards creation only — handles are meant to be resolved once
    and held, keeping the hot path lock-free.
    """

    def __init__(self):
        self._metrics: Dict[_Key, object] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._metrics)

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in (labels or {}):
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, labels=labels, **kwargs)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  lo: float = 1e-5, hi: float = 600.0,
                  growth: float = 2 ** 0.25) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   lo=lo, hi=hi, growth=growth)

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        """Existing metric or None — lookups never create."""
        return self._metrics.get((name, _label_key(labels)))
