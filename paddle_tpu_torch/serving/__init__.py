"""Continuous-batching serving over a paged KV cache, on the card (port of
paddle_tpu.serving: engine, scheduler, paged pools, paged attention)."""
from .attention import advance_positions, paged_attend, paged_decode_attention
from .engine import PAD_TOKEN, ServingEngine
from .kv_cache import (NULL_PAGE, BlockAllocator, PagedKVCache,
                       PagedLayerCache, overflow_position, pages_for)
from .resilience import TERMINAL_STATUSES, EngineOverloaded
from .scheduler import Request, SamplingParams, ScheduleDecision, Scheduler

__all__ = ["advance_positions", "paged_attend", "paged_decode_attention",
           "PAD_TOKEN", "ServingEngine", "NULL_PAGE", "BlockAllocator",
           "PagedKVCache", "PagedLayerCache", "overflow_position",
           "pages_for", "TERMINAL_STATUSES", "EngineOverloaded", "Request",
           "SamplingParams", "ScheduleDecision", "Scheduler"]
