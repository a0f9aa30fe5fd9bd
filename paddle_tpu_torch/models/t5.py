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

Generation is greedy (`generate`): the encoder runs once and every
decoder layer's cross-attention K/V is projected once per prompt
(`project_kv`); then one decode call a token, whose self-attention writes
into and attends over a static (k, v) cache of `max_new_tokens` positions
through `generation.attend_with_cache` (K1 with the relative position
bias of the token's offset folded into the visibility mask). The finished
mask stays on the device and the host polls it every 8 steps.
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

    def compute_bias(self, q_len, k_len, q_offset=0):
        """(1, heads, q_len, k_len) trainable additive position bias of
        queries at q_offset.. against keys at 0..: bidirectional buckets
        in the encoder, causal in the decoder."""
        cfg = self.cfg
        w = self.relative_attention_bias.weight
        q_offset = int(q_offset)
        buckets = _bucket_table(q_offset + int(q_len), int(k_len),
                                not self.causal,
                                cfg.relative_attention_num_buckets,
                                cfg.relative_attention_max_distance,
                                w.device)[q_offset:]
        vals = F.embedding(buckets, w)                        # (q, k, h)
        return vals.permute(2, 0, 1).unsqueeze(0)

    def project_kv(self, src):
        """Project K/V once for a fixed source (cross-attention: the
        encoder states never change, so neither do these)."""
        b, sk = src.shape[0], src.shape[1]
        k = self.k(src).reshape(b, sk, self.num_heads, self.d_kv)
        v = self.v(src).reshape(b, sk, self.num_heads, self.d_kv)
        return k, v

    def forward(self, x, kv=None, kv_proj=None, position_bias=None,
                cache=None, start_pos=0, generator=None):
        """kv: encoder states for cross-attention (self-attention when
        None); kv_proj: pre-projected (k, v) from project_kv (overrides
        kv); cache: a static (k_cache, v_cache) pair for decode,
        self-attention only, written at `start_pos` (a host int). Returns
        (out, position_bias, new cache or None)."""
        b, s = x.shape[0], x.shape[1]
        # T5 uses UNscaled dot-product attention; the kernels divide by
        # sqrt(d_kv), so pre-scale q to cancel it
        q = (self.q(x) * math.sqrt(self.d_kv)).reshape(
            b, s, self.num_heads, self.d_kv)
        if kv_proj is not None:
            k, v = kv_proj
        else:
            k, v = self.project_kv(x if kv is None else kv)
        if cache is not None:
            from .generation import attend_with_cache

            if position_bias is None and self.has_relative_bias:
                position_bias = self.compute_bias(s, cache[0].shape[1],
                                                  q_offset=start_pos)
            ctx, cache = attend_with_cache(q, k, v, cache, start_pos, 1,
                                           bias=position_bias)
            out = self.o(ctx.reshape(b, s, self.num_heads * self.d_kv))
            return out, position_bias, cache
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

    def forward(self, x, enc, self_bias=None, cache=None, start_pos=0,
                cross_kv=None, generator=None):
        a, self_bias, cache = self.self_attn(
            self.ln1(x), position_bias=self_bias, cache=cache,
            start_pos=start_pos, generator=generator)
        x = x + self.dropout(a, generator)
        c, _, _ = self.cross_attn(self.ln2(x), kv=enc, kv_proj=cross_kv,
                                  generator=generator)
        x = x + self.dropout(c, generator)
        f = self.ff(self.ln3(x), generator)
        return x + self.dropout(f, generator), self_bias, cache


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

    def decode(self, decoder_input_ids, enc, caches=None, start_pos=0,
               cross_kvs=None, generator=None):
        """Decoder states; with `caches` (one static (k, v) pair per
        layer, written at `start_pos`), (states, caches)."""
        if caches is not None and len(caches) != len(self.decoder_layers):
            raise ValueError(f"got {len(caches)} caches for "
                             f"{len(self.decoder_layers)} decoder layers")
        x = self.dropout(F.embedding(decoder_input_ids, self.shared.weight),
                         generator)
        bias = None
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.decoder_layers):
            x, bias, cache = layer(
                x, enc, self_bias=bias,
                cache=caches[i] if caches is not None else None,
                start_pos=start_pos,
                cross_kv=cross_kvs[i] if cross_kvs is not None else None,
                generator=generator)
            if new_caches is not None:
                new_caches.append(cache)
        x = self.decoder_norm(x)
        if new_caches is not None:
            return x, new_caches
        return x

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
                start_pos=0, enc=None, cross_kvs=None, generator=None):
        """Three call shapes, as the reference's:
        - (input_ids, decoder_input_ids): training / eval logits;
        - (input_ids) with decoder_input_ids None: encoder only, returns
          (encoder_states, per-layer cross-attention (k, v) projections);
        - a decode step: decoder_input_ids with caches and enc / cross_kvs
          (input_ids unused), returns (logits, new caches)."""
        if decoder_input_ids is None:
            enc = self.t5.encode(input_ids, generator)
            cross = tuple(layer.cross_attn.project_kv(enc)
                          for layer in self.t5.decoder_layers)
            return enc, cross
        if caches is not None:
            h, caches = self.t5.decode(decoder_input_ids, enc, caches=caches,
                                       start_pos=start_pos,
                                       cross_kvs=cross_kvs,
                                       generator=generator)
            return self._logits(h), caches
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

    def generate(self, input_ids, max_new_tokens=32,
                 eos_token_id: Optional[int] = None, cache_dtype=None):
        """Greedy seq2seq decoding. One encoder pass (every decoder layer's
        cross-attention K/V projected once), then one decode call a token
        over per-layer self-attention caches of `max_new_tokens` positions
        (`cache_dtype`, a torch dtype or its name; fp32 by default). The
        finished mask stays on the device, polled every 8 steps. Returns
        the (b, steps run) generated ids (int32, no start token), as the
        reference does: an early exit leaves the columns it did not run
        out."""
        from .generation import _eval_mode, _resolve_dtype

        cfg = self.config
        dev = self.t5.shared.weight.device
        ids = torch.as_tensor(input_ids, device=dev)
        b = ids.shape[0]
        dt = _resolve_dtype(cache_dtype or torch.float32)
        with _eval_mode(self):
            shape = (b, max_new_tokens, cfg.num_heads, cfg.d_kv)
            caches = [(torch.zeros(shape, dtype=dt, device=dev),
                       torch.zeros(shape, dtype=dt, device=dev))
                      for _ in self.t5.decoder_layers]
            enc, cross = self(ids)
            cur = torch.full((b,), cfg.decoder_start_token_id,
                             dtype=torch.int32, device=dev)
            finished = torch.zeros((b,), dtype=torch.bool, device=dev)
            outs = []
            for step in range(max_new_tokens):
                logits, caches = self(None, cur[:, None], caches=caches,
                                      start_pos=step, enc=enc,
                                      cross_kvs=cross)
                cur = logits[:, 0].argmax(dim=-1).to(torch.int32)
                if eos_token_id is not None:
                    cur = cur.masked_fill(finished, eos_token_id)
                    finished = finished | (cur == eos_token_id)
                outs.append(cur)
                if (eos_token_id is not None and step % 8 == 7
                        and bool(finished.all())):
                    break
        return torch.stack(outs, dim=1)
