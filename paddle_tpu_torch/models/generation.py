"""Cache protocol of the decoder models (ported from
paddle_tpu/models/generation.py:30-46, 81-87).

Only the paged branch of `attend_with_cache` is ported: the serving
engine's `PagedLayerCache`. The static-cache `generate` and beam search
are still to be ported (ROADMAP queue 1, S10).
"""
from __future__ import annotations

__all__ = ["attend_with_cache"]


def attend_with_cache(q, k, v, cache, start_pos, rep):
    """Write this block's K/V into `cache` at `start_pos`, then attend q
    over it. q: (b, s, heads, hd); k/v: (b, s, kv_heads, hd); cache: a
    serving `PagedLayerCache` (its pools are written in place). Returns
    (ctx (b, s, heads, hd), cache)."""
    if hasattr(cache, "page_table"):
        from ..serving.attention import paged_attend

        return paged_attend(q, k, v, cache, start_pos, rep)
    raise NotImplementedError(
        "only the paged KV cache is ported; the static (k, v) cache of "
        "models/generation.py is still to be ported (ROADMAP queue 1, S10)")


def _config_of(model):
    if hasattr(model, "llama"):
        return model.llama.config
    if hasattr(model, "config"):
        return model.config
    raise ValueError("model exposes no config for cache sizing")
