"""The serving engine's sampler: greedy argmax, or temperature -> top-k ->
top-p -> Gumbel-max over counter-based noise.

A request's n-th sampled token uses noise that is a hash of (request seed,
draw index n, vocab index), computed on the device, so a stream depends
neither on the decode horizon nor on the batch it rode in. The plain
decode step (`serving.engine`) and the speculative verify windows
(`serving.spec`) both sample here.
"""
from __future__ import annotations

import torch

from ..ops.dropout_mask import M32, fmix32, mul32

__all__ = ["PAD_TOKEN", "hashed_uniforms", "uniforms", "target_logits",
           "gumbel", "sample_batch"]

# emitted by dead rows inside a decode block or window (finished /
# padding); the host drain trims each row at its first PAD
PAD_TOKEN = -1


def hashed_uniforms(seeds: torch.Tensor, draws: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """fp32 uniforms in (0, 1), a counter-based function of (seed, draw
    index, index `idx`), identical on every device; `idx` broadcasts
    against the (b, 1) rows."""
    row = fmix32(fmix32((seeds & M32) ^ 0x9E3779B9) ^ (draws & M32))
    x = fmix32((row[:, None] + mul32(idx, 0x9E3779B9)) & M32)
    return ((x >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def uniforms(seeds: torch.Tensor, draws: torch.Tensor,
             vocab: int) -> torch.Tensor:
    """(b, vocab) fp32 uniforms of (seed, draw index, vocab index): the
    Gumbel noise of a draw."""
    idx = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    return hashed_uniforms(seeds, draws, idx[None, :])


def target_logits(logits: torch.Tensor, knobs: dict) -> torch.Tensor:
    """The sampler's temperature-scaled, top-k and top-p masked fp32
    logits: softmax of these is the distribution a stochastic row draws
    from (the reference's `_sample_batch` up to its categorical draw)."""
    logits = logits.float()
    temps, top_ks, top_ps = knobs["temps"], knobs["top_ks"], knobs["top_ps"]
    vocab = logits.shape[-1]
    t_safe = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    scaled = logits / t_safe[:, None]
    # top-k as a rank threshold (top_k <= 0 keeps all V)
    k_eff = torch.where(top_ks > 0, top_ks.clamp(max=vocab),
                        torch.full_like(top_ks, vocab))
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    masked = scaled.masked_fill(scaled < kth, float("-inf"))
    # top-p over the top-k-masked distribution
    sorted_m = masked.sort(dim=-1, descending=True).values
    cum = sorted_m.softmax(dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_ps[:, None]).sum(dim=-1, keepdim=True).clamp(
        max=vocab - 1)
    cutoff = sorted_m.gather(-1, cutoff_idx)
    return masked.masked_fill(masked < cutoff, float("-inf"))


def gumbel(knobs: dict, draws: torch.Tensor, vocab: int) -> torch.Tensor:
    return -torch.log(-torch.log(uniforms(knobs["seeds"], draws, vocab)))


def sample_batch(logits: torch.Tensor, knobs: dict,
                 draws: torch.Tensor) -> torch.Tensor:
    """Per-row sampling, mirroring the reference `_sample_batch`: greedy
    where temperature == 0, else temperature -> top-k -> top-p ->
    categorical, the last by Gumbel-max over `uniforms`."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    if knobs["greedy_only"]:
        return greedy
    masked = target_logits(logits, knobs)
    sampled = (masked + gumbel(knobs, draws, logits.shape[-1])).argmax(
        dim=-1)
    return torch.where(knobs["temps"] == 0.0, greedy, sampled)
