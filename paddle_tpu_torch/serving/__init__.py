"""Continuous-batching serving over a paged KV cache, on the card (port of
paddle_tpu.serving: engine, scheduler with chunked prefill, paged pools,
paged and ragged attention, the ragged step's packing, the prefix cache
and speculative decoding). The quantized KV helpers live in
`serving.quant`, imported only by int8 / fp8 pools; the speculative
decoder's names (`SpecConfig`, ...) resolve lazily from `serving.spec`, so
a spec-off engine never imports it."""
from .attention import (advance_positions, paged_attend,
                        paged_decode_attention, ragged_paged_attention)
from .engine import PAD_TOKEN, ServingEngine
from .kv_cache import (NULL_PAGE, BlockAllocator, PagedKVCache,
                       PagedLayerCache, overflow_position, pages_for)
from .prefix_cache import PrefixCache, PrefixNode
from .resilience import TERMINAL_STATUSES, EngineOverloaded
from .scheduler import (ChunkTask, Request, SamplingParams, ScheduleDecision,
                        Scheduler)

_SPEC_EXPORTS = ("SpecConfig", "propose_drafts", "build_draft_buffer",
                 "parse_emitted_row")


def __getattr__(name):
    if name in _SPEC_EXPORTS:
        from . import spec

        return getattr(spec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["advance_positions", "paged_attend", "paged_decode_attention",
           "ragged_paged_attention", "ChunkTask",
           "PAD_TOKEN", "ServingEngine", "NULL_PAGE", "BlockAllocator",
           "PagedKVCache", "PagedLayerCache", "overflow_position",
           "pages_for", "PrefixCache", "PrefixNode", "TERMINAL_STATUSES",
           "EngineOverloaded", "Request", "SamplingParams",
           "ScheduleDecision", "Scheduler", *_SPEC_EXPORTS]
