"""Exporters over a MetricsRegistry: Prometheus text exposition + JSON
snapshot round-trip (the port's own copy of
paddle_tpu/observability/export.py; the same observations give the same
bytes in both packages).

Prometheus format follows the text exposition rules (one `# TYPE` /
optional `# HELP` per metric name, histogram as cumulative `_bucket{le=}`
series plus `_sum`/`_count`) so the output scrapes with a stock
Prometheus server; `registry_from_snapshot` is the inverse of
`MetricsRegistry.snapshot()` — bench JSON files embed snapshots and a
later analysis step can rebuild live histograms from them.
"""
from __future__ import annotations

import math
from typing import Dict

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["to_prometheus", "registry_from_snapshot"]


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return format(v, ".10g")


def _escape(s: str) -> str:
    """Label-VALUE escaping per the Prometheus text format: backslash
    first (so later substitutions don't double-escape), then newline,
    then double-quote — exactly these three, in exactly this order."""
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(s: str) -> str:
    """HELP-line escaping: the text format escapes ONLY backslash and
    newline there — HELP text is not quoted, so a literal `"` must
    pass through unescaped (through the label-value escaper it would
    come out as `\\"`, which scrapers render verbatim)."""
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def to_prometheus(registry: MetricsRegistry) -> str:
    """Text exposition of every metric in the registry."""
    lines = []
    seen = set()
    for m in registry.collect():
        if m.name not in seen:
            seen.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} "
                             f"{_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            cum = 0
            for i, c in enumerate(m._counts):
                cum += c
                le = m.bucket_upper_bound(i)
                labels = dict(m.labels)
                labels["le"] = _fmt_value(le)
                lines.append(f"{m.name}_bucket{_fmt_labels(labels)} {cum}")
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.sum)}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} "
                         f"{m.count}")
        else:
            lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.value)}")
    return "\n".join(lines) + "\n"


def registry_from_snapshot(snap: Dict[str, object]) -> MetricsRegistry:
    """Rebuild a registry from `MetricsRegistry.snapshot()` output (or
    its json.dumps/loads round-trip): the rebuilt registry's snapshot
    equals the input."""
    reg = MetricsRegistry()
    for d in snap["metrics"]:
        labels = dict(d.get("labels") or {}) or None
        help_ = d.get("help", "")
        kind = d["type"]
        if kind == "counter":
            reg.counter(d["name"], help_, labels)._value = d["value"]
        elif kind == "gauge":
            reg.gauge(d["name"], help_, labels)._value = d["value"]
        elif kind == "histogram":
            h = reg.histogram(d["name"], help_, labels, lo=d["lo"],
                              hi=d["hi"], growth=d["growth"])
            h._count = d["count"]
            h._sum = d["sum"]
            h._min = d["min"] if d["min"] is not None else math.inf
            h._max = d["max"] if d["max"] is not None else -math.inf
            for k, c in (d.get("buckets") or {}).items():
                h._counts[int(k)] = c
        else:
            raise ValueError(f"unknown metric type {kind!r}")
    return reg
