"""Speculative decoding: model-free drafts verified in batched windows (the
port of paddle_tpu/serving/spec.py).

Every target-model step of the plain decode block emits one token a row.
Here drafts come from the request's OWN token stream, n-gram prompt lookup
(the continuation of the most recent earlier occurrence of the stream's
trailing n-gram), or from a read-only probe of the engine's prefix cache
(a cached stream that shares the current one's tail predicts its
continuation), and one target pass over a (b, 1 + L) window - the row's
last token plus L drafts, at per-row positions - scores every draft at
once. Its attention is the paged prefill path (`_prefill_attention_paged`:
the whole page table gathered, K1 with a float mask).

Acceptance, on the device:

- greedy rows (temperature 0): draft d_i is accepted iff it is the target
  argmax, so the stream is identical to non-speculative decoding;
- stochastic rows: d_i is accepted with probability p(d_i) under the
  sampler's temperature / top-k / top-p distribution (the draft is a point
  mass, so min(1, p/q) = p(d)); on rejection the token is resampled from p
  with d removed. P(emit t) = p(t) [t = d] + (1 - p(d)) p(t) [t != d] /
  (1 - p(d)) = p(t): the target distribution is kept.

Draws. The port samples by Gumbel-max over a counter-based hash of (seed,
draw index, vocab index). Slot i of a window draws at `draws + i`: its
target sample and, on rejection, the resample (the same noise with d at
-inf) use the Gumbel noise of that index, and its accept test the uniform
at vocab index V of that index, which no Gumbel draw reads. The draw index
advances by exactly the tokens a row emitted, so a row without drafts
takes the plain decode step's sample, and the indices a window looked at
past its emitted tokens are never reused by a decision.

Rejected-suffix K/V never reaches an attend: a window writes all its lanes
before attending, and the next window re-writes every position past the
accepted frontier before any query reads it. The scheduler charges pages
for `horizon x (1 + lookahead)` tokens a block and reverts the unaccepted
part after the drain (`Scheduler.revert_spec_pages`).

The host side (proposal, the draft buffer, parsing the drain's windows) is
plain Python and numpy over host request state, between two dispatches.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .kv_cache import overflow_position
from .sampling import (PAD_TOKEN, gumbel, hashed_uniforms, sample_batch,
                       target_logits)

__all__ = ["SpecConfig", "propose_drafts", "build_draft_buffer",
           "parse_emitted_row", "verify_windows"]

_METHODS = ("ngram", "prefix_cache", "combined")


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (`ServingEngine(spec_config=...)`).

    `lookahead` is L, the drafts verified per target pass (a decode block
    runs `decode_horizon` windows). `method` picks the proposer: "ngram"
    (prompt lookup over the request's own prompt + generated tokens),
    "prefix_cache" (the radix tree's continuation), or "combined" (n-gram
    first, the tree when it proposes nothing)."""

    lookahead: int = 4
    method: str = "ngram"
    # n-gram lengths tried longest first: the trailing k-gram for k in
    # [ngram_min, ngram_max] is searched in the earlier stream
    ngram_max: int = 3
    ngram_min: int = 1

    def validate(self) -> "SpecConfig":
        if self.lookahead < 1:
            raise ValueError(
                f"spec lookahead must be >= 1, got {self.lookahead}")
        if self.method not in _METHODS:
            raise ValueError(
                f"unknown spec method {self.method!r}: expected one of "
                f"{_METHODS}")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"ngram_min={self.ngram_min} ngram_max={self.ngram_max}")
        return self


# ------------------------------------------------------- draft proposers
def _ngram_continuation(ctx: List[int], max_tokens: int,
                        ngram_max: int, ngram_min: int) -> List[int]:
    """Prompt-lookup drafts: the tokens that followed the most recent
    EARLIER occurrence of the stream's trailing k-gram, longest k first."""
    n = len(ctx)
    for k in range(min(ngram_max, n - 1), ngram_min - 1, -1):
        tail = ctx[n - k:]
        for j in range(n - k - 1, -1, -1):
            if ctx[j:j + k] == tail:
                cont = ctx[j + k:j + k + max_tokens]
                if cont:
                    return cont
                # the only match ends the stream: a shorter k would match
                # the same spot's suffix
                break
    return []


def propose_drafts(req, cfg: SpecConfig, prefix_cache=None,
                   max_tokens: Optional[int] = None) -> List[int]:
    """Up to `max_tokens` (default `cfg.lookahead`) draft tokens continuing
    `req`'s prompt + generated stream. Side-effect free: the prefix-cache
    probe is the read-only `continuation` walk."""
    limit = cfg.lookahead if max_tokens is None else max_tokens
    ctx = list(req.prompt) + list(req.generated)
    drafts: List[int] = []
    if cfg.method in ("ngram", "combined"):
        drafts = _ngram_continuation(ctx, limit, cfg.ngram_max,
                                     cfg.ngram_min)
    if not drafts and cfg.method in ("prefix_cache", "combined") \
            and prefix_cache is not None:
        drafts = prefix_cache.continuation(ctx, limit)
    return drafts[:limit]


def build_draft_buffer(reqs: Sequence, rows: int, width: int,
                       cfg: SpecConfig, prefix_cache=None) -> np.ndarray:
    """The block's (rows, width) int64 draft buffer: row i holds request
    i's proposed continuation, PAD-padded (PAD lanes verify as invalid, so
    a row without drafts runs plain decode steps). `width` is the block's
    emit capacity: each window slides its row's cursor by the emitted
    count, consuming drafts while the stream still matches the proposal."""
    buf = np.full((rows, width), PAD_TOKEN, np.int64)
    for i, req in enumerate(reqs):
        d = propose_drafts(req, cfg, prefix_cache, max_tokens=width)
        if d:
            buf[i, :len(d)] = d
    return buf


# ---------------------------------------------------------- drain parse
def parse_emitted_row(row, windows: Tuple[int, ...]) -> List[int]:
    """One row of a speculative block's emitted buffer -> its tokens. The
    buffer is a run of windows of the given widths; each window's emits
    are a PAD-terminated prefix, and a window that starts with PAD means
    the row was dead for the rest of the block (budgets only run down)."""
    out: List[int] = []
    i = 0
    for w in windows:
        seg = row[i:i + w]
        i += w
        if len(seg) == 0 or seg[0] == PAD_TOKEN:
            break
        for t in seg:
            t = int(t)
            if t == PAD_TOKEN:
                break
            out.append(t)
    return out


# ----------------------------------------------------- device-side verify
def _accept_uniform(knobs: dict, draws: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """(b,) uniforms of an accept test at draw index `draws`: the hash at
    vocab index V, which no Gumbel draw (indices 0..V-1) reads."""
    idx = torch.full((1, 1), vocab, dtype=torch.int64, device=draws.device)
    return hashed_uniforms(knobs["seeds"], draws, idx)[:, 0]


def accept_and_stop(logits: torch.Tensor, drafts: torch.Tensor,
                    valid: torch.Tensor, knobs: dict,
                    draws: torch.Tensor):
    """The rejection-sampling rule over one window's logits.

    logits (b, L+1, V); drafts (b, L) with `valid` (b, L) marking the lanes
    that carry a draft (a prefix of the lanes). Returns (k, stop): k (b,)
    the accepted drafts, stop (b,) the token emitted after them - the
    target sample at slot k when every valid draft was accepted (for a row
    without drafts the plain decode step's sample), else the resample at
    slot k with the refused draft removed."""
    b, slots, vocab = logits.shape
    lanes = slots - 1
    tgt = torch.stack([sample_batch(logits[:, i], knobs, draws + i)
                       for i in range(slots)], dim=1)            # (b, L+1)
    greedy_only = knobs["greedy_only"]
    if not greedy_only:
        temps = knobs["temps"]
        d_safe = torch.where(valid, drafts, torch.zeros_like(drafts))
    accepts = []
    for i in range(lanes):
        ok = drafts[:, i] == tgt[:, i]
        if not greedy_only:
            p = torch.softmax(target_logits(logits[:, i], knobs), dim=-1)
            p_d = p.gather(1, d_safe[:, i:i + 1])[:, 0]
            u = _accept_uniform(knobs, draws + i, vocab)
            ok = torch.where(temps == 0.0, ok, u < p_d)
        accepts.append(valid[:, i] & ok)
    k = torch.cumprod(torch.stack(accepts, dim=1).to(torch.int64),
                      dim=1).sum(dim=1)
    stop = tgt.gather(1, k[:, None])[:, 0]
    if greedy_only:
        return k, stop
    rejected = k < valid.sum(dim=1)
    logits_k = logits.gather(
        1, k[:, None, None].expand(b, 1, vocab))[:, 0]
    d_k = drafts.gather(1, k.clamp(max=lanes - 1)[:, None])[:, 0]
    refused = torch.arange(vocab, device=logits.device)[None, :] \
        == d_k.clamp(0, vocab - 1)[:, None]
    masked = target_logits(logits_k, knobs).masked_fill(refused,
                                                         float("-inf"))
    resample = (masked + gumbel(knobs, draws + k, vocab)).argmax(dim=-1)
    return k, torch.where((temps == 0.0) | ~rejected, stop, resample)


def _window(model, views, dbuf, tokens, positions, draws, knobs,
            remaining, cursor, matched, stats, lookahead: int, park: int):
    """One verify window: a (b, 1+L) target forward at per-row positions,
    the accept rule, then the decode body's EOS / budget masking over the
    up to L+1 emit slots. Returns the (b, L+1) PAD-terminated emits and
    the advanced carries.

    `cursor` is the row's progress through the block's draft buffer;
    `matched` whether the emitted stream still equals the proposal (after
    a rejection the later windows run without drafts)."""
    L = lookahead
    lanes = torch.arange(L + 1, device=tokens.device)
    take = dbuf.gather(1, cursor[:, None] + lanes[None, :])    # (b, L+1)
    drafts = take[:, :L]
    alive0 = remaining > 0
    valid = (matched & alive0)[:, None] & (
        torch.cumprod((drafts != PAD_TOKEN).to(torch.int64), dim=1) > 0)
    # lanes without a draft carry token 0: their K/V lands past the
    # accepted frontier, re-written by the next window before any query
    # reads it, and their logits are never consumed
    ids = torch.cat([tokens[:, None],
                     torch.where(valid, drafts, torch.zeros_like(drafts))],
                    dim=1)
    logits, _ = model(ids, caches=views, start_pos=positions)
    k, stop = accept_and_stop(logits.float(), drafts, valid, knobs, draws)

    # emit slots 0..L with the decode body's masking, one token at a time
    # (EOS inside an accepted run cuts it where plain decoding would)
    eos_ids = knobs["eos_ids"]
    rem, last, m = remaining, tokens, torch.zeros_like(k)
    pad = torch.full_like(tokens, PAD_TOKEN)
    emits = []
    for i in range(L + 1):
        cand = torch.where(i < k, drafts[:, i], stop) if i < L else stop
        can = (rem > 0) & (i <= k)
        hit_eos = can & (eos_ids >= 0) & (cand == eos_ids)
        emits.append(torch.where(can, cand, pad))
        rem = torch.where(can, rem - 1, rem)
        rem = torch.where(hit_eos, torch.zeros_like(rem), rem)
        last = torch.where(can, cand, last)
        m = m + can.to(m.dtype)
    # the emitted prefix below the stop slot is drafts, so only an
    # emitted stop token can break the match (against the next proposal
    # lane; PAD there matches no token)
    peek = take.gather(1, k[:, None])[:, 0]
    matched = matched & ((m <= k) | (stop == peek))
    positions = torch.where(rem > 0, positions + m.to(positions.dtype),
                            torch.full_like(positions, park))
    stats = stats + torch.stack(
        [valid.sum(dim=1), torch.minimum(k, m), alive0.to(k.dtype)], dim=1)
    return (torch.stack(emits, dim=1), last, positions, draws + m, rem,
            cursor + m, matched, stats)


def verify_windows(model, views, dbuf, tokens, positions, draws, knobs,
                   remaining, *, windows: int, lookahead: int,
                   page_size: int, max_pages: int, first=None, alive=None):
    """`windows` verify windows of (b, 1 + lookahead) tokens, all enqueued
    on the device with no host sync. Returns [emitted (b, windows * (L+1))
    int64, stats (b, 3) int64 of (drafted, accepted, target passes)].

    `first` / `alive`: a ragged step's iteration 0 already sampled `first`
    for its `alive` rows, consuming the proposal's first token as a window
    without drafts; the match state and the target-pass count start
    there. Without them the block starts at the proposal's first lane."""
    b = tokens.shape[0]
    L = lookahead
    # parked rows write past a (b, max_pages) table: the null page
    park = overflow_position(max_pages, page_size)
    # L+1 PAD lanes past the buffer: a window reads L+1 lanes at its cursor
    dbuf = torch.cat([dbuf, torch.full((b, L + 1), PAD_TOKEN,
                                       dtype=dbuf.dtype,
                                       device=dbuf.device)], dim=1)
    stats = torch.zeros((b, 3), dtype=torch.int64, device=tokens.device)
    if first is None:
        cursor = torch.zeros((b,), dtype=torch.int64, device=tokens.device)
        matched = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    else:
        cursor = alive.to(torch.int64)
        matched = torch.where(alive, first == dbuf[:, 0],
                              torch.ones_like(alive))
        stats[:, 2] = cursor
    emits = []
    for _ in range(windows):
        emit, tokens, positions, draws, remaining, cursor, matched, stats = \
            _window(model, views, dbuf, tokens, positions, draws, knobs,
                    remaining, cursor, matched, stats, L, park)
        emits.append(emit)
    emitted = (torch.cat(emits, dim=1) if emits else
               torch.zeros((b, 0), dtype=torch.int64, device=tokens.device))
    return [emitted, stats]
