"""GPT-family decoder, ported from paddle_tpu/models/gpt.py, name for name.

Pre-LN causal transformer: token and position embeddings, blocks of
LayerNorm -> fused-QKV attention -> LayerNorm -> exact-GELU FFN with
hidden dropout, a final LayerNorm and the LM head tied to the token
embedding. Module paths and parameter names match the JAX package
(`gpt.blocks.0.attn.qkv.weight`, ...), so weights cross by name
(`weights.load_reference_state`). Attention runs through
`F.scaled_dot_product_attention` (K1 forward with dropout, K2 / K3
backward) and every LayerNorm through K4 / K5. Two forwards, as in the
reference: the causal no-cache forward (with `labels`, the shifted causal
LM loss, through the chunked `fused_linear_cross_entropy` head when the
config asks for it), and the cache forward over either the static
`(k, v)` caches of `generation.generate` or the serving engine's paged
views.

The forward takes the `torch.Generator` that hidden and attention dropout
draw from (`generator=`, on the model's device; needed in training when
dropout is on). Construction takes `device` (default: the port's default
device, "cuda", which raises when there is no card), `dtype` and `seed`:
weights are drawn on that device from a seeded `torch.Generator`, N(0,
0.02) for every Linear and Embedding weight as `_init_transformer_weights`
(paddle_tpu/models/ernie.py:128) does, biases zero, LayerNorm ones and
zeros.

Positions past the position table (`max_position_embeddings`) are clamped
to its last row before the lookup: the serving engine parks dead rows at
the table-overflow position, whose output is never read back, and
`F.embedding` on the card would stop the stream on an out-of-range index.
(The reference's `jnp.take` returns NaN rows there instead.)

Not ported: `tensor_parallel=True` (fleet's `VocabParallelEmbedding` and
column / row parallel layers, ROADMAP queue 1 item 5), the pipeline stages
`GPTEmbeddingPipe` / `GPTHeadPipe`, `gpt_pipe_layers` and
`gpt_spmd_pipeline_fn` (fleet). Tensor-parallel serving does not need the
first: it shards an ordinary model (serving/tp.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, Linear

__all__ = ["GPTConfig", "GPTAttention", "GPTBlock", "GPTModel",
           "GPTForCausalLM", "GPTPretrainingCriterion"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    # LM head via fused_linear_cross_entropy when labels ride into
    # forward: the (b*s, vocab) fp32 logits never materialize
    fused_lm_loss: bool = False

    @classmethod
    def gpt3_1p3b(cls):
        return cls(hidden_size=2048, num_hidden_layers=24,
                   num_attention_heads=16, intermediate_size=8192,
                   max_position_embeddings=2048)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=256,
                   max_position_embeddings=128)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **fk)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.dropout_p = cfg.attention_probs_dropout_prob

    def forward(self, x, cache=None, start_pos=0, generator=None):
        b, s, _ = x.shape
        # the reference's [b, s, 3, heads, hd] split of the fused product
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        if cache is not None:  # KV-cache decode (inference only)
            return self.attend(q, k, v, b, s, cache, start_pos)
        ctx = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout_p if self.training else 0.0,
            training=self.training, generator=generator)
        return self.out(ctx.reshape(b, s, self.num_heads * self.head_dim))

    def attend(self, q, k, v, b, s, cache, start_pos):
        """Cache-path tail of the block: cache attention, then the output
        projection. Returns (out, cache)."""
        from .generation import attend_with_cache

        ctx, cache = attend_with_cache(q, k, v, cache, start_pos, 1)
        return self.out(ctx.reshape(b, s, self.num_heads * self.head_dim)), \
            cache


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm(cfg.hidden_size, eps, **fk)
        self.attn = GPTAttention(cfg, **fk)
        self.ln2 = LayerNorm(cfg.hidden_size, eps, **fk)
        self.ffn_in = Linear(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.ffn_out = Linear(cfg.intermediate_size, cfg.hidden_size, **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def _ffn(self, x, generator):
        return self.dropout(self.ffn_out(F.gelu(self.ffn_in(self.ln2(x)))),
                            generator)

    def forward(self, x, cache=None, start_pos=0, generator=None):
        if cache is None:
            x = F.add(x, self.dropout(self.attn(self.ln1(x),
                                                generator=generator),
                                      generator))
            return F.add(x, self._ffn(x, generator))
        attn, cache = self.attn(self.ln1(x), cache, start_pos)
        x = x + self.dropout(attn, generator)
        return x + self._ffn(x, generator), cache


class GPTModel(nn.Module):
    def __init__(self, cfg: Optional[GPTConfig] = None,
                 tensor_parallel: bool = False, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if tensor_parallel:
            raise NotImplementedError(
                "GPTModel(tensor_parallel=True) is not ported yet (ROADMAP "
                "queue 1 item 5; S5's tensor-parallel serving shards an "
                "ordinary model through ServingEngine(tp_size=N) and never "
                "sets it: the flag belongs to fleet's VocabParallelEmbedding "
                "and parallel layers)")
        self.config = cfg = cfg or GPTConfig()
        fk = {"device": resolve_device(device), "dtype": dtype}
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.blocks = nn.ModuleList([GPTBlock(cfg, **fk)
                                     for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from `seed` on the model's device."""
        gen = torch.Generator(device=self.wte.weight.device)
        gen.manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    def _positions(self, s, caches, start_pos, device):
        """(1 or b, s) positions: 0..s-1 without caches; with caches,
        `start_pos` as a host int or 0-d tensor (every row at one offset),
        a (b,) tensor (per-row offsets) or a (b, s) tensor (a flat ragged
        step's own positions)."""
        steps = torch.arange(s, dtype=torch.int64, device=device)
        if caches is None:
            return steps[None]
        if isinstance(start_pos, int):
            return (steps + start_pos)[None]
        sp = start_pos.to(device=device, dtype=torch.int64)
        if sp.dim() == 2:
            return sp
        if sp.dim() == 1:
            return sp[:, None] + steps[None]
        return (steps + sp)[None]

    def forward(self, input_ids, position_ids=None,
                caches: Optional[Sequence] = None, start_pos=0,
                generator=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = self._positions(s, caches, start_pos,
                                           input_ids.device)
        position_ids = position_ids.clamp(
            0, self.config.max_position_embeddings - 1)
        x = self.dropout(F.add(F.embedding(input_ids, self.wte.weight),
                               F.embedding(position_ids, self.wpe.weight)),
                         generator)
        if caches is None:
            for blk in self.blocks:
                x = blk(x, generator=generator)
            return self.ln_f(x)
        if len(caches) != len(self.blocks):
            raise ValueError(f"got {len(caches)} caches for "
                             f"{len(self.blocks)} blocks")
        new_caches: List = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache, start_pos, generator)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


def _shifted_ce(logits, labels):
    vocab = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                           labels[:, 1:].reshape(-1))


class GPTPretrainingCriterion(nn.Module):
    """Shifted causal-LM cross entropy of (b, s, vocab) logits against
    (b, s) labels."""

    def forward(self, logits, labels):
        return _shifted_ce(logits, labels)


class GPTForCausalLM(nn.Module):
    def __init__(self, cfg: Optional[GPTConfig] = None, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.gpt = GPTModel(cfg, device=device, dtype=dtype, seed=seed)
        self.eval()

    def forward(self, input_ids, position_ids=None, caches=None,
                start_pos=0, labels=None, generator=None):
        wte = self.gpt.wte.weight
        if caches is None:
            h = self.gpt(input_ids, position_ids, generator=generator)
            if labels is not None and self.gpt.config.fused_lm_loss:
                # shifted causal CE fused with the tied head projection
                hidden = h.shape[-1]
                return F.fused_linear_cross_entropy(
                    h[:, :-1].reshape(-1, hidden), wte, None,
                    labels[:, 1:].reshape(-1), transpose_y=True)
            # tied LM head: one [h, vocab] product
            logits = F.matmul(h, wte, transpose_y=True)
            if labels is not None:
                return self.loss(logits, labels)
            return logits
        h, caches = self.gpt(input_ids, position_ids, caches, start_pos,
                             generator)
        return F.matmul(h, wte, transpose_y=True), caches

    def generate(self, input_ids, **kwargs):
        from .generation import generate

        return generate(self, input_ids, **kwargs)

    def loss(self, logits, labels):
        return _shifted_ce(logits, labels)
