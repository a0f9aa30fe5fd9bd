"""Autoregressive generation over a static KV cache (ported from
paddle_tpu/models/generation.py), and the cache protocol of the decoder
models.

`attend_with_cache` takes either of the reference's two caches: the
serving engine's `PagedLayerCache` (its pools are written in place by
`serving.attention.paged_attend`), or a static `(k_cache, v_cache)` pair
of (b, max_len, kv_heads, hd) tensors, which this module's `generate`
allocates once (`init_caches`) and writes in place at each step's
position.

`generate` runs one prefill over the whole prompt and then one decode
call a token, at `start_pos = prompt_len + step - 1`, all eager: there is
no counterpart of the reference's jit memo. The finished mask stays on the
device and the host polls it every 16 steps (`_EOS_POLL`), as the
reference does; after an early exit the rows are padded with eos.
Attention runs through `F.scaled_dot_product_attention` with a float
visibility mask, so through K1 (the flash forward) at the static decode
shape: one query row over the whole cache.

Sampling draws from an explicit source, never from a global generator: a
draw is Gumbel-max over the counter-based uniforms of
`serving.sampling.hashed_uniforms`, keyed by (seed, step) and indexed by
(row, vocab index), so the host never waits for it and a stream on the
card equals the stream on the CPU for the same logits. An unseeded call
takes fresh entropy, so two unseeded calls differ. The reference's
threefry streams do not carry over: only greedy streams cross packages.

Beam search keeps the k beams of each prompt on the batch axis; each step
reorders every layer's cache by the chosen parents, gathering into a
second set of preallocated buffers that then swaps with the first.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Tuple

import torch

from ..nn import functional as F
from ..serving.sampling import hashed_uniforms

__all__ = ["generate", "attend_with_cache", "init_caches"]

# host-side early-exit check cadence of `generate` and beam search
_EOS_POLL = 16

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def attend_with_cache(q, k, v, cache, start_pos, rep, bias=None):
    """Write this block's K/V into `cache` at `start_pos`, then attend q
    over the full (masked) cache.

    q: (b, s, heads, hd); k/v: (b, s, kv_heads, hd). cache: a serving
    `PagedLayerCache` (then `start_pos` may be a tensor of per-row or
    per-token positions, and `bias` must be None), or a static
    `(k_cache, v_cache)` pair of (b, max_len, kv_heads, hd) tensors with
    `start_pos` a host int. bias: an optional additive (1, heads, s,
    max_len) attention bias (T5's relative position bias), folded into the
    visibility mask. Returns (ctx (b, s, heads, hd), cache).

    The static branch computes attention in the cache's type: q is cast to
    it, and the context is cast back to q's type (the model's) before it
    leaves, so a bf16 model over an fp32 cache keeps a bf16 residual
    stream. (The reference promotes instead: JAX carries the fp32 context
    on into the output projection and the residual stream.)"""
    if hasattr(cache, "page_table"):
        if bias is not None:
            raise NotImplementedError(
                "an attention bias over the paged cache is not ported (the "
                "port serves no model with a position bias)")
        from ..serving.attention import paged_attend

        return paged_attend(q, k, v, cache, start_pos, rep)
    kc, vc = cache
    start = int(start_pos)
    b, s = q.shape[0], q.shape[1]
    max_len = kc.shape[1]
    if start + s > max_len:
        raise ValueError(f"positions {start}..{start + s - 1} do not fit a "
                         f"cache of {max_len}")
    kc[:, start:start + s] = k.to(kc.dtype)
    vc[:, start:start + s] = v.to(vc.dtype)
    kf, vf = kc, vc
    if rep > 1:  # GQA: expand kv heads to match q heads
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    # position j visible to query i iff j <= start_pos + i
    pos_q = start + torch.arange(s, device=q.device)
    allowed = torch.arange(max_len, device=q.device)[None, :] \
        <= pos_q[:, None]
    mask = torch.zeros(allowed.shape, dtype=torch.float32, device=q.device
                       ).masked_fill_(~allowed, -1e9)[None, None]
    if bias is not None:
        mask = mask + bias.float()
    ctx = F.scaled_dot_product_attention(q.to(kc.dtype), kf, vf,
                                         attn_mask=mask, is_causal=False,
                                         training=False)
    return ctx.to(q.dtype), (kc, vc)


def _resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _CACHE_DTYPES:
        raise ValueError(f"unsupported cache dtype {dtype!r}: expected one "
                         f"of {sorted(_CACHE_DTYPES)}")
    return _CACHE_DTYPES[name]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def init_caches(model, batch, max_len, dtype=torch.float32
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Zeroed (k, v) cache pair per decoder layer, sized from the config,
    on the model's device. `dtype` is a torch dtype or its name."""
    cfg = _config_of(model)
    kv_heads = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    head_dim = cfg.hidden_size // cfg.num_attention_heads
    shape = (batch, max_len, kv_heads, head_dim)
    fk = {"dtype": _resolve_dtype(dtype), "device": _model_device(model)}
    return [(torch.zeros(shape, **fk), torch.zeros(shape, **fk))
            for _ in range(cfg.num_hidden_layers)]


def _config_of(model):
    for attr in ("llama", "gpt"):
        if hasattr(model, attr):
            return getattr(model, attr).config
    if hasattr(model, "config"):
        return model.config
    raise ValueError("model exposes no config for cache sizing")


class _Draws:
    """The uniforms of a seeded stream: draw `step` of row r at vocab index
    j is `hashed_uniforms(seed, step, r * vocab + j)`."""

    def __init__(self, seed: int, b: int, vocab: int, device):
        self.seeds = torch.full((b,), int(seed), dtype=torch.int64,
                                device=device)
        self.idx = (torch.arange(b, dtype=torch.int64, device=device)[:, None]
                    * vocab + torch.arange(vocab, dtype=torch.int64,
                                           device=device)[None, :])

    def __call__(self, step: int) -> torch.Tensor:
        draws = torch.full_like(self.seeds, int(step))
        return hashed_uniforms(self.seeds, draws, self.idx)


def _filter(logits, temperature, top_k, top_p):
    """The fp32 logits a sampled draw picks from: temperature, then top-k,
    then top-p with the reference's cutoff rule (sort descending,
    `cutoff_idx = sum(cum < top_p)`, drop the logits below that one);
    dropped tokens at -inf."""
    logits = logits.float() / temperature
    vocab = logits.shape[-1]
    if top_k and top_k > 0:
        kth = logits.topk(min(int(top_k), vocab), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = sorted_logits.softmax(dim=-1).cumsum(dim=-1)
        # smallest set with cumulative prob >= top_p (first element always in)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(
            max=vocab - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, uniforms, temperature, top_k, top_p):
    """The next token of (b, vocab) logits: greedy argmax at temperature
    0, else a categorical draw from `_filter`'s logits by Gumbel-max over
    `uniforms` ((b, vocab) in (0, 1))."""
    if temperature == 0.0:  # greedy
        return logits.argmax(dim=-1)
    return (_filter(logits, temperature, top_k, top_p)
            - torch.log(-torch.log(uniforms))).argmax(dim=-1)


def _prompt(model, input_ids) -> torch.Tensor:
    ids = torch.as_tensor(input_ids, device=_model_device(model))
    return ids[None] if ids.dim() == 1 else ids


def _fresh_seed() -> int:
    return int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF


@contextlib.contextmanager
def _eval_mode(model):
    """The model in eval mode without autograd; train mode restored
    after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        if was_training:
            model.train()


def generate(model, input_ids, max_new_tokens=32, temperature=1.0,
             top_k=0, top_p=1.0, eos_token_id: Optional[int] = None,
             seed: Optional[int] = None, cache_dtype=torch.float32,
             num_beams: int = 1, length_penalty: float = 0.0):
    """Autoregressive generation. input_ids: a tensor or array of token
    ids, (b, prompt_len) or (prompt_len,). Returns a (b, prompt_len +
    max_new_tokens) tensor of token ids in the prompt's integer type on
    the model's device; rows that hit `eos_token_id` are padded with eos
    afterwards. `cache_dtype` is a torch dtype or its name.

    num_beams > 1 selects beam search (greedy within beams; temperature /
    top_k / top_p are sampling knobs and must stay at their defaults)."""
    if num_beams > 1:
        # temperature 0.0 (the library's greedy spelling) and 1.0 are both
        # fine: beam search is greedy within beams either way
        if temperature not in (0.0, 1.0) or top_k or top_p != 1.0:
            raise ValueError(
                "beam search (num_beams>1) does not combine with "
                "temperature/top_k/top_p sampling")
        return _beam_generate(model, input_ids, max_new_tokens, num_beams,
                              eos_token_id, cache_dtype, length_penalty)
    with _eval_mode(model):
        ids = _prompt(model, input_ids)
        b, prompt_len = ids.shape
        caches = init_caches(model, b, prompt_len + max_new_tokens,
                             cache_dtype)
        draws = None
        if temperature != 0.0:
            vocab = _config_of(model).vocab_size
            draws = _Draws(_fresh_seed() if seed is None else seed, b, vocab,
                           ids.device)

        def sample(logits, step):
            u = None if draws is None else draws(step)
            return _sample(logits, u, temperature, top_k, top_p)

        logits, caches = model(ids, caches=caches, start_pos=0)
        token = sample(logits[:, -1], 0)
        finished = None
        if eos_token_id is not None:
            finished = token == eos_token_id
        out = [ids, token[:, None].to(ids.dtype)]
        for step in range(1, max_new_tokens):
            logits, caches = model(token[:, None], caches=caches,
                                   start_pos=prompt_len + step - 1)
            token = sample(logits[:, 0], step)
            if finished is not None:
                # finished rows keep emitting eos; the mask stays on the
                # device, polled by the host every _EOS_POLL steps
                token = token.masked_fill(finished, eos_token_id)
                finished = finished | (token == eos_token_id)
            out.append(token[:, None].to(ids.dtype))
            if (finished is not None and step % _EOS_POLL == 0
                    and bool(finished.all())):
                # every row hit eos: pad the rest with eos and stop early
                remaining = max_new_tokens - 1 - step
                if remaining:
                    out.append(torch.full((b, remaining), eos_token_id,
                                          dtype=ids.dtype,
                                          device=ids.device))
                break
        return torch.cat(out, dim=1)


# ------------------------------------------------------------- beam search

def _beam_generate(model, input_ids, max_new_tokens, num_beams,
                   eos_token_id, cache_dtype, length_penalty):
    """Beam search over the same static KV cache: beams ride the batch
    axis (b * k rows, batch i in rows [i * k, (i + 1) * k)). Scores are
    summed token log-probs; finished beams (eos) are frozen and keep
    emitting eos with no score change. The final ranking divides by
    length ** length_penalty (0.0: the raw sum)."""
    with _eval_mode(model):
        ids = _prompt(model, input_ids)
        dev = ids.device
        b, prompt_len = ids.shape
        k = int(num_beams)
        total = prompt_len + max_new_tokens
        caches = init_caches(model, b * k, total, cache_dtype)
        # the reorder's destination: every layer's cache gathered by the
        # chosen parents into these, which then swap with `caches`
        spare = init_caches(model, b * k, total, cache_dtype)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        base = (torch.arange(b, device=dev) * k)[:, None]

        ids_rep = ids.repeat_interleave(k, dim=0)       # (b * k, prompt)
        logits, caches = model(ids_rep, caches=caches, start_pos=0)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        vocab = logp.shape[-1]
        # all k beams are identical after the prefill, so beam 0 keeps its
        # top-k candidates and the rest start at -inf (else the first step
        # would pick k copies of the same argmax)
        start_mask = torch.full((1, k, 1), float("-inf"), device=dev)
        start_mask[:, 0] = 0.0
        tok, scores, _ = _beam_select(logp.reshape(b, k, vocab) + start_mask)
        prev_tok = tok.reshape(-1)
        scores = scores.reshape(-1)
        finished = prev_tok == eos
        frozen = torch.full((vocab,), float("-inf"), device=dev)
        if eos >= 0:
            # a finished beam's one continuation: eos at zero cost
            frozen[eos] = 0.0
        histories = [prev_tok[:, None]]                 # per-step columns
        reorders = []                                   # per-step sources
        for step in range(1, max_new_tokens):
            logits, caches = model(prev_tok[:, None], caches=caches,
                                   start_pos=prompt_len + step - 1)
            logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
            if eos >= 0:
                logp = torch.where(finished[:, None], frozen, logp)
            tok, new_scores, beam_idx = _beam_select(
                (logp + scores[:, None]).reshape(b, k, vocab))
            flat_src = (base + beam_idx).reshape(-1)
            for (kc, vc), (kb, vb) in zip(caches, spare):
                torch.index_select(kc, 0, flat_src, out=kb)
                torch.index_select(vc, 0, flat_src, out=vb)
            caches, spare = spare, caches
            prev_tok = tok.reshape(-1)
            scores = new_scores.reshape(-1)
            if eos >= 0:
                finished = finished[flat_src] | (prev_tok == eos)
            reorders.append(flat_src)
            histories.append(prev_tok[:, None])
            if (eos >= 0 and step % _EOS_POLL == 0
                    and bool(finished.all())):
                break   # the history's length tracks the early exit

        # each surviving beam's history, by walking the reorder chain
        # backwards (beams swap parents every step)
        cols = [histories[-1]]
        src = torch.arange(b * k, device=dev)
        for step in range(len(reorders) - 1, -1, -1):
            src = reorders[step][src]
            cols.append(histories[step][src])
        cols.reverse()
        gen = torch.cat(cols, dim=1)                    # (b * k, steps run)
        if gen.shape[1] < max_new_tokens and eos >= 0:
            gen = torch.cat([gen, torch.full(
                (b * k, max_new_tokens - gen.shape[1]), eos,
                dtype=gen.dtype, device=dev)], dim=1)
        if eos >= 0:
            is_eos = gen == eos
            lengths = torch.where(is_eos.any(dim=1),
                                  is_eos.int().argmax(dim=1) + 1,
                                  gen.shape[1])
        else:
            lengths = torch.full((b * k,), gen.shape[1], device=dev)
        ranked = scores / lengths.float().clamp(min=1.0) ** length_penalty
        best = ranked.reshape(b, k).argmax(dim=1)
        gen_best = gen[torch.arange(b, device=dev) * k + best]
        if eos >= 0:
            # pad everything after the first eos with eos
            hit = (gen_best == eos).int().cumsum(dim=1) > 0
            after = torch.cat([torch.zeros((b, 1), dtype=torch.bool,
                                           device=dev), hit[:, :-1]], dim=1)
            gen_best = gen_best.masked_fill(after, eos)
        return torch.cat([ids, gen_best.to(ids.dtype)], dim=1)


def _beam_select(scored: torch.Tensor):
    """(b, k, V) cumulative scores -> the top k of the flattened k * V
    continuations: tokens (b, k), scores (b, k), parent beams (b, k).
    Ties go to the lower flat index, as `jax.lax.top_k` breaks them (a
    stable descending sort; `torch.topk` promises no order)."""
    b, k, v = scored.shape
    top_s, top_i = scored.reshape(b, k * v).sort(dim=1, descending=True,
                                                 stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    return top_i % v, top_s, top_i // v
