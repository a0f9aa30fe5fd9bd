"""T5-family encoder-decoder, ported from paddle_tpu/models/t5.py, name for
name.

RMS layer norm (T5's no-mean, no-bias variant), a bucketed relative
position bias shared from the first layer of each stack, bias-free
linears, a ReLU or gated-GELU FFN, cross-attention over the encoder
states, and tied embeddings with the d_model**-0.5 logit scale. Module
paths and parameter names match the JAX package
(`t5.encoder_layers.0.attn.relative_attention_bias.weight`, ...), so
weights cross by name (`weights.load_reference_state`; the bias tables and
the shared embedding are Embeddings and cross untransposed).

Attention runs through `F.scaled_dot_product_attention`, so through the
flash kernels: K1 forward, K2 / K3 backward. T5 omits the 1/sqrt(d)
attention scale, so queries are pre-multiplied by sqrt(d_kv) to cancel the
kernel's scale (:133-136) instead of forking the kernel. The relative
position bias enters as a trainable additive (1, heads, q, k) mask, and
its gradient comes from K2's d(mask). Every RMSNorm runs through K4 / K5.

The forward takes the `torch.Generator` that hidden and attention dropout
draw from (`generator=`, on the model's device; needed in training when
dropout is on). Construction takes `device` (default: the port's default
device, "cuda", which raises when there is no card), `dtype` and `seed`:
weights are drawn on that device from a seeded `torch.Generator` with the
reference init, `_init_transformer_weights(self, 0.02)`: N(0, 0.02) for
every Linear and Embedding weight of `T5Model` (the bias tables and the
shared embedding included), RMSNorm ones; an untied `lm_head` keeps paddle
Linear's default Xavier-normal init, as in the reference.

Generation (the `caches=` decode call and `generate`, over the static
(k, v) cache of `attend_with_cache`) is not ported yet (ROADMAP queue 1,
S10): those calls raise, and the arguments only they use (`start_pos`,
`enc`, `cross_kvs`, `kv_proj`, `q_offset`) are left out.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, Linear, RMSNorm

__all__ = ["T5Config", "T5Attention", "T5LayerFF", "T5EncoderLayer",
           "T5DecoderLayer", "T5Model", "T5ForConditionalGeneration"]

_S10 = ("T5 generation over the static (k, v) cache is not ported yet "
        "(ROADMAP queue 1, S10: generate and attend_with_cache's static "
        "branch)")


@dataclasses.dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64                    # per-head dim (not d_model/heads!)
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: Optional[int] = None
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"   # or "gated-gelu" (t5.1.1)
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    pad_token_id: int = 0

    @classmethod
    def t5_small(cls):
        return cls()

    @classmethod
    def t5_base(cls):
        return cls(d_model=768, d_ff=3072, num_layers=12, num_heads=12)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=256, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4,
                   relative_attention_num_buckets=8,
                   relative_attention_max_distance=16)


def _relative_position_bucket(relative_position: torch.Tensor,
                              bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (int32 in, int32 out), the
    reference's arithmetic exactly: the fp32 log term truncated to int32
    (:62-84)."""
    rp = relative_position
    bucket = torch.zeros_like(rp)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (rp > 0).to(torch.int32) * num_buckets
        rp = rp.abs()
    else:
        rp = -rp.clamp(max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    # log-spaced buckets for distant positions
    rp_large = max_exact + (
        torch.log(rp.clamp(min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    rp_large = rp_large.clamp(max=num_buckets - 1)
    return bucket + torch.where(is_small, rp, rp_large)


@functools.lru_cache(maxsize=64)
def _bucket_table(q_len: int, k_len: int, bidirectional: bool,
                  num_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    """The (q_len, k_len) int64 bucket of every (query, key) pair, on
    `device`. Computed once per shape on the host, so the card reads the
    very buckets of the CPU arithmetic that the reference's is held to
    (a log rounded otherwise would move a boundary), and copied through
    pinned memory without waiting for the stream."""
    ctx = torch.arange(q_len, dtype=torch.int32)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32)[None, :]
    table = _relative_position_bucket(mem - ctx, bidirectional, num_buckets,
                                      max_distance).long()
    if device.type == "cuda":
        return table.pin_memory().to(device, non_blocking=True)
    return table


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias=False, causal=False,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.causal = causal
        self.num_heads = cfg.num_heads
        self.d_kv = cfg.d_kv
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False, **fk)
        self.k = Linear(cfg.d_model, inner, bias=False, **fk)
        self.v = Linear(cfg.d_model, inner, bias=False, **fk)
        self.o = Linear(inner, cfg.d_model, bias=False, **fk)
        self.has_relative_bias = has_relative_bias
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **fk)

    def compute_bias(self, q_len, k_len):
        """(1, heads, q_len, k_len) trainable additive position bias:
        bidirectional buckets in the encoder, causal in the decoder."""
        cfg = self.cfg
        w = self.relative_attention_bias.weight
        buckets = _bucket_table(int(q_len), int(k_len), not self.causal,
                                cfg.relative_attention_num_buckets,
                                cfg.relative_attention_max_distance, w.device)
        vals = F.embedding(buckets, w)                        # (q, k, h)
        return vals.permute(2, 0, 1).unsqueeze(0)

    def project_kv(self, src):
        """Project K/V once for a fixed source (cross-attention: the
        encoder states never change, so neither do these)."""
        b, sk = src.shape[0], src.shape[1]
        k = self.k(src).reshape(b, sk, self.num_heads, self.d_kv)
        v = self.v(src).reshape(b, sk, self.num_heads, self.d_kv)
        return k, v

    def forward(self, x, kv=None, position_bias=None, cache=None,
                generator=None):
        """kv: encoder states for cross-attention (self-attention when
        None); a decode `cache` raises (S10). Returns (out, position_bias,
        None)."""
        if cache is not None:
            raise NotImplementedError(_S10)
        b, s = x.shape[0], x.shape[1]
        # T5 uses UNscaled dot-product attention; the kernels divide by
        # sqrt(d_kv), so pre-scale q to cancel it
        q = (self.q(x) * math.sqrt(self.d_kv)).reshape(
            b, s, self.num_heads, self.d_kv)
        k, v = self.project_kv(x if kv is None else kv)
        if position_bias is None and self.has_relative_bias:
            position_bias = self.compute_bias(s, k.shape[1])
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=position_bias, is_causal=self.causal,
            dropout_p=self.cfg.dropout_rate if self.training else 0.0,
            training=self.training, generator=generator)
        out = self.o(ctx.reshape(b, s, self.num_heads * self.d_kv))
        return out, position_bias, None


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False, **fk)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, generator=None):
        if self.gated:
            h = F.gelu(self.wi_0(x)) * self.wi_1(x)
        else:
            h = F.relu(self.wi(x))
        return self.wo(self.dropout(h, generator))


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias=False, device=None,
                 dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        eps = cfg.layer_norm_epsilon
        self.ln1 = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.attn = T5Attention(cfg, has_relative_bias, causal=False, **fk)
        self.ln2 = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.ff = T5LayerFF(cfg, **fk)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, position_bias=None, generator=None):
        a, position_bias, _ = self.attn(self.ln1(x),
                                        position_bias=position_bias,
                                        generator=generator)
        x = x + self.dropout(a, generator)
        f = self.ff(self.ln2(x), generator)
        return x + self.dropout(f, generator), position_bias


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias=False, device=None,
                 dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        eps = cfg.layer_norm_epsilon
        self.ln1 = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.self_attn = T5Attention(cfg, has_relative_bias, causal=True,
                                     **fk)
        self.ln2 = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.cross_attn = T5Attention(cfg, False, causal=False, **fk)
        self.ln3 = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.ff = T5LayerFF(cfg, **fk)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x, enc, self_bias=None, cache=None, generator=None):
        a, self_bias, _ = self.self_attn(
            self.ln1(x), position_bias=self_bias, cache=cache,
            generator=generator)
        x = x + self.dropout(a, generator)
        c, _, _ = self.cross_attn(self.ln2(x), kv=enc, generator=generator)
        x = x + self.dropout(c, generator)
        f = self.ff(self.ln3(x), generator)
        return x + self.dropout(f, generator), self_bias, None


class T5Model(nn.Module):
    def __init__(self, cfg: Optional[T5Config] = None, device=None,
                 dtype=None):
        super().__init__()
        self.config = cfg = cfg or T5Config()
        fk = {"device": device, "dtype": dtype}
        n_dec = cfg.num_decoder_layers or cfg.num_layers
        eps = cfg.layer_norm_epsilon
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **fk)
        self.encoder_layers = nn.ModuleList(
            [T5EncoderLayer(cfg, has_relative_bias=(i == 0), **fk)
             for i in range(cfg.num_layers)])
        self.encoder_norm = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.decoder_layers = nn.ModuleList(
            [T5DecoderLayer(cfg, has_relative_bias=(i == 0), **fk)
             for i in range(n_dec)])
        self.decoder_norm = RMSNorm(cfg.d_model, epsilon=eps, **fk)
        self.dropout = Dropout(cfg.dropout_rate)

    def encode(self, input_ids, generator=None):
        x = self.dropout(F.embedding(input_ids, self.shared.weight),
                         generator)
        bias = None
        for layer in self.encoder_layers:
            x, bias = layer(x, position_bias=bias, generator=generator)
        return self.encoder_norm(x)

    def decode(self, decoder_input_ids, enc, caches=None, generator=None):
        if caches is not None:
            raise NotImplementedError(_S10)
        x = self.dropout(F.embedding(decoder_input_ids, self.shared.weight),
                         generator)
        bias = None
        for layer in self.decoder_layers:
            x, bias, _ = layer(x, enc, self_bias=bias, generator=generator)
        return self.decoder_norm(x)

    def forward(self, input_ids, decoder_input_ids, generator=None):
        return self.decode(decoder_input_ids,
                           self.encode(input_ids, generator),
                           generator=generator)


class T5ForConditionalGeneration(nn.Module):
    def __init__(self, cfg: Optional[T5Config] = None, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        fk = {"device": dev, "dtype": dtype}
        self.t5 = T5Model(cfg, **fk)
        self.config = cfg = self.t5.config
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                  **fk)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from `seed` on the model's device."""
        dev = self.t5.shared.weight.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for mod in self.t5.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        if not self.config.tie_word_embeddings:        # Xavier-normal
            out_f, in_f = self.lm_head.weight.shape
            self.lm_head.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                                        generator=gen)

    def _logits(self, h):
        cfg = self.config
        if cfg.tie_word_embeddings:
            # tied head: scale by d_model**-0.5 (T5's rescaled logits)
            return F.matmul(h * (cfg.d_model ** -0.5), self.t5.shared.weight,
                            transpose_y=True)
        return self.lm_head(h)

    def forward(self, input_ids, decoder_input_ids=None, caches=None,
                generator=None):
        """Two call shapes of the reference's three:
        - (input_ids, decoder_input_ids): training / eval logits;
        - (input_ids) with decoder_input_ids None: encoder only, returns
          (encoder_states, per-layer cross-attention (k, v) projections).
        The decode step over `caches` raises (ROADMAP S10)."""
        if caches is not None:
            raise NotImplementedError(_S10)
        if decoder_input_ids is None:
            enc = self.t5.encode(input_ids, generator)
            cross = tuple(layer.cross_attn.project_kv(enc)
                          for layer in self.t5.decoder_layers)
            return enc, cross
        return self._logits(self.t5(input_ids, decoder_input_ids,
                                    generator))

    def loss(self, logits, labels, ignore_index=-100):
        vocab = logits.shape[-1]
        return F.cross_entropy(logits.reshape(-1, vocab), labels.reshape(-1),
                               ignore_index=ignore_index)

    def shift_right(self, labels: torch.Tensor) -> torch.Tensor:
        """Decoder inputs: labels shifted right behind the start token,
        -100 replaced by the pad token; on the labels' device, with no
        host copy."""
        cfg = self.config
        start = torch.full_like(labels[:, :1], cfg.decoder_start_token_id)
        out = torch.cat([start, labels[:, :-1]], dim=1)
        return out.masked_fill(out == -100, cfg.pad_token_id)

    def generate(self, *args, **kwargs):
        raise NotImplementedError(_S10)
