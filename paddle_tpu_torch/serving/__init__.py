"""Continuous-batching serving over a paged KV cache, on the card (port of
paddle_tpu.serving: engine, scheduler with chunked prefill, paged pools,
paged and ragged attention, the ragged step's packing, the prefix cache,
speculative decoding, and the resilience and recovery layers). The
quantized KV helpers live in `serving.quant`, imported only by int8 / fp8
pools. The speculative decoder's names (`SpecConfig`, ...) resolve lazily
from `serving.spec`, and the recovery layer's (`EngineSupervisor`,
`RequestJournal`, ...) from `serving.recovery`, so a spec-off engine never
imports the first and an engine without a journal or supervisor never
imports the second."""
from .attention import (advance_positions, paged_attend,
                        paged_decode_attention, ragged_paged_attention)
from .engine import PAD_TOKEN, ServingEngine
from .kv_cache import (NULL_PAGE, BlockAllocator, PagedKVCache,
                       PagedLayerCache, overflow_position, pages_for)
from .prefix_cache import PrefixCache, PrefixNode
from .resilience import (TERMINAL_STATUSES, EngineDead, EngineOverloaded,
                         FaultInjector, InjectedFault, describe_fault,
                         is_fatal, is_transient)
from .scheduler import (ChunkTask, Request, SamplingParams, ScheduleDecision,
                        Scheduler, reserve_request_ids)

_SPEC_EXPORTS = ("SpecConfig", "propose_drafts", "build_draft_buffer",
                 "parse_emitted_row")
_RECOVERY_EXPORTS = ("EngineSnapshot", "EngineSupervisor", "RequestJournal",
                     "RequestRecord", "RequestSnapshot", "replay_key_state")


def __getattr__(name):
    if name in _SPEC_EXPORTS:
        from . import spec

        return getattr(spec, name)
    if name in _RECOVERY_EXPORTS:
        from . import recovery

        return getattr(recovery, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["advance_positions", "paged_attend", "paged_decode_attention",
           "ragged_paged_attention", "ChunkTask",
           "PAD_TOKEN", "ServingEngine", "NULL_PAGE", "BlockAllocator",
           "PagedKVCache", "PagedLayerCache", "overflow_position",
           "pages_for", "PrefixCache", "PrefixNode", "TERMINAL_STATUSES",
           "EngineDead", "EngineOverloaded", "FaultInjector",
           "InjectedFault", "describe_fault", "is_fatal", "is_transient",
           "Request", "SamplingParams", "ScheduleDecision", "Scheduler",
           "reserve_request_ids", *_SPEC_EXPORTS, *_RECOVERY_EXPORTS]
