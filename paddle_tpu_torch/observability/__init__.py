"""Observability of the port: the metrics registry behind
`ServingEngine.stats()`."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
