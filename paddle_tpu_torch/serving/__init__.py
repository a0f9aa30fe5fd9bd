"""Continuous-batching serving over a paged KV cache, on the card (port of
paddle_tpu.serving: engine, scheduler with chunked prefill, paged pools,
paged and ragged attention, the ragged step's packing). The quantized KV
helpers live in `serving.quant`, imported only by int8 / fp8 pools."""
from .attention import (advance_positions, paged_attend,
                        paged_decode_attention, ragged_paged_attention)
from .engine import PAD_TOKEN, ServingEngine
from .kv_cache import (NULL_PAGE, BlockAllocator, PagedKVCache,
                       PagedLayerCache, overflow_position, pages_for)
from .resilience import TERMINAL_STATUSES, EngineOverloaded
from .scheduler import (ChunkTask, Request, SamplingParams, ScheduleDecision,
                        Scheduler)

__all__ = ["advance_positions", "paged_attend", "paged_decode_attention",
           "ragged_paged_attention", "ChunkTask",
           "PAD_TOKEN", "ServingEngine", "NULL_PAGE", "BlockAllocator",
           "PagedKVCache", "PagedLayerCache", "overflow_position",
           "pages_for", "TERMINAL_STATUSES", "EngineOverloaded", "Request",
           "SamplingParams", "ScheduleDecision", "Scheduler"]
