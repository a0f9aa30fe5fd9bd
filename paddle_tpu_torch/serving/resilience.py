"""The part of paddle_tpu/serving/resilience.py:58-68 the scheduler uses:
the terminal request statuses and the backpressure error."""
from __future__ import annotations

__all__ = ["TERMINAL_STATUSES", "EngineOverloaded"]

# every way a request's lifecycle can end; `Request.status` lands on
# exactly one of these and never changes again
TERMINAL_STATUSES = frozenset(
    {"finished", "cancelled", "expired", "failed", "shed"})


class EngineOverloaded(RuntimeError):
    """`add_request` backpressure: the bounded waiting queue is full.

    Deliberately a distinct type (not ValueError) so callers can tell
    "malformed request" from "come back later" without string matching.
    """
