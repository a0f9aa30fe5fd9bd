"""LLaMA-family decoder, ported from paddle_tpu/models/llama.py.

RMSNorm + rotary embeddings + SwiGLU + grouped-query attention. Module
paths and parameter names match the JAX package
(`llama.layers.0.self_attn.q_proj.weight`, ...), so weights cross by name
(`weights.load_reference_state`). Two forwards, as in the reference: the
no-cache causal forward, and the cache forward (`caches` = one cache per
layer, written in place: the static `(k, v)` pairs of
`generation.generate`, or the serving engine's `PagedLayerCache` views).

With `labels`, the no-cache forward returns the reference's shifted causal
LM loss: `loss` over the head's logits, or, with `fused_lm_loss`, the
chunked `fused_linear_cross_entropy` head, which never builds the (b*s,
vocab) logits. The projections are the port's `Linear`, so `amp.auto_cast`
O1 runs them in bf16 as the reference's dispatch does.

Construction takes `device` (default: the port's default device, "cuda",
which raises when there is no card), `dtype` and `seed`: weights are drawn
on that device from a seeded `torch.Generator`, N(0, 0.02) for the
decoder's Linear and Embedding weights as `_init_transformer_weights`
(paddle_tpu/models/ernie.py:128) does, Xavier-normal for `lm_head`, whose
JAX counterpart keeps Linear's default initializer. A 7B model in bf16 is
drawn directly on the card; nothing passes through host memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..nn import torch_functional as F
from ..nn.layers import Linear, RMSNorm
from ..ops.rope import apply_rope, rope_tables

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM"]

@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32          # < heads -> grouped-query attn
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    # LM head via fused_linear_cross_entropy when labels ride into
    # forward: the (b*s, vocab) fp32 logits never materialize
    fused_lm_loss: bool = False

    @classmethod
    def llama7b(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   intermediate_size=128, max_position_embeddings=64)


def _linear(i: int, o: int, fk) -> Linear:
    return Linear(i, o, bias=False, **fk)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.num_heads = cfg.num_attention_heads
        self.num_kv_heads = cfg.num_key_value_heads
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")
        if cfg.hidden_size % cfg.num_attention_heads != 0:
            raise ValueError("hidden_size must be divisible by "
                             "num_attention_heads")
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        if self.head_dim % 2 != 0:
            raise ValueError(f"RoPE needs an even head_dim, got "
                             f"{self.head_dim}")
        self.rope_theta = cfg.rope_theta
        h, kv = cfg.hidden_size, self.num_kv_heads * self.head_dim
        self.q_proj = _linear(h, h, fk)
        self.k_proj = _linear(h, kv, fk)
        self.v_proj = _linear(h, kv, fk)
        self.o_proj = _linear(h, h, fk)

    def forward(self, x, cache=None, start_pos=0, rope=None):
        """cache: an optional static (k, v) pair or PagedLayerCache (returns
        (out, cache) after writing this block's K/V into it in place).
        Without cache, the causal no-cache forward. rope: the
        (cos, sin) tables for these positions, when the caller computed
        them once for all layers."""
        from .generation import attend_with_cache

        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        if rope is None:
            rope = rope_tables(s, self.head_dim, self.rope_theta, start_pos,
                               x.device)
        q, k = apply_rope(q, k, *rope)
        rep = self.num_heads // self.num_kv_heads
        if cache is None:
            if rep > 1:  # GQA: expand KV to full heads for the flash kernel
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            ctx = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return self.o_proj(ctx.reshape(b, s,
                                           self.num_heads * self.head_dim))
        ctx, cache = attend_with_cache(q, k, v, cache, start_pos, rep)
        return self.o_proj(ctx.reshape(
            b, s, self.num_heads * self.head_dim)), cache


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.gate_proj = _linear(cfg.hidden_size, cfg.intermediate_size, fk)
        self.up_proj = _linear(cfg.hidden_size, cfg.intermediate_size, fk)
        self.down_proj = _linear(cfg.intermediate_size, cfg.hidden_size, fk)

    def forward(self, x):
        return self.down_proj(F.multiply(F.silu(self.gate_proj(x)),
                                         self.up_proj(x)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=device, dtype=dtype)
        self.self_attn = LlamaAttention(cfg, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg, device, dtype)

    def forward(self, x, cache=None, start_pos=0, rope=None):
        if cache is None:
            x = F.add(x, self.self_attn(self.input_layernorm(x), rope=rope))
            return F.add(x, self.mlp(self.post_attention_layernorm(x)))
        attn, cache = self.self_attn(self.input_layernorm(x), cache,
                                     start_pos, rope)
        x = x + attn
        return x + self.mlp(self.post_attention_layernorm(x)), cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: Optional[LlamaConfig] = None, device=None,
                 dtype=None):
        super().__init__()
        self.config = cfg or LlamaConfig()
        cfg = self.config
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device, dtype)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device=device,
                            dtype=dtype)

    def forward(self, input_ids, caches: Optional[Sequence] = None,
                start_pos=0):
        x = F.embedding(input_ids, self.embed_tokens.weight)
        cfg = self.config
        # one (cos, sin) table pair for every layer of this forward
        rope = rope_tables(input_ids.shape[1],
                           cfg.hidden_size // cfg.num_attention_heads,
                           cfg.rope_theta, start_pos, x.device)
        if caches is None:
            for layer in self.layers:
                x = layer(x, rope=rope)
            return self.norm(x)
        if len(caches) != len(self.layers):
            raise ValueError(f"got {len(caches)} caches for "
                             f"{len(self.layers)} decoder layers")
        new_caches: List = []
        for layer, cache in zip(self.layers, caches):
            x, cache = layer(x, cache, start_pos, rope)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: Optional[LlamaConfig] = None, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.llama = LlamaModel(cfg, dev, dtype)
        cfg = self.llama.config
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size,
                               {"device": dev, "dtype": dtype})
        self.init_weights(seed)
        self.eval()

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from `seed` on the model's device."""
        dev = self.lm_head.weight.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for mod in self.llama.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        out_f, in_f = self.lm_head.weight.shape
        self.lm_head.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                                    generator=gen)

    def forward(self, input_ids, caches=None, start_pos=0, labels=None):
        if caches is None:
            h = self.llama(input_ids)
            if labels is not None and self.llama.config.fused_lm_loss:
                # shifted causal CE fused with the head projection; the
                # port's head weight is torch's (vocab, hidden), the
                # transpose of paddle's (hidden, vocab), hence transpose_y
                hidden = h.shape[-1]
                return F.fused_linear_cross_entropy(
                    h[:, :-1].reshape(-1, hidden), self.lm_head.weight,
                    None, labels[:, 1:].reshape(-1), transpose_y=True)
            logits = self.lm_head(h)
            if labels is not None:
                return self.loss(logits, labels)
            return logits
        h, caches = self.llama(input_ids, caches, start_pos)
        return self.lm_head(h), caches

    def generate(self, input_ids, **kwargs):
        from .generation import generate

        return generate(self, input_ids, **kwargs)

    def loss(self, logits, labels):
        vocab = logits.shape[-1]
        return F.cross_entropy(logits[:, :-1].reshape(-1, vocab),
                               labels[:, 1:].reshape(-1))
