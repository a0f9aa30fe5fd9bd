"""ERNIE / BERT-family encoder for pretraining, ported from
paddle_tpu/models/ernie.py, name for name.

Post-LN transformer encoder with a fused QKV projection, an MLM head that
ties the word embeddings (plus `mlm_bias`) and an NSP head. Module paths
and parameter names match the JAX package
(`ernie.layers.0.attention.qkv.weight`, ...), so weights cross by name
(`weights.load_reference_state`). With `fused_mlm_loss` and
`masked_lm_labels`, the forward returns the MLM loss through the chunked
`fused_linear_cross_entropy` head, which never builds the (b*s, vocab)
logits.

The forward takes the `torch.Generator` that hidden and attention dropout
draw from (`generator=`, on the model's device; needed in training when
dropout is on). Attention runs through the flash kernels (K1 forward with
dropout, K2 / K3 backward) and every LayerNorm through K4 / K5.

Construction takes `device` (default: the port's default device, "cuda",
which raises when there is no card), `dtype` and `seed`: weights are drawn
on that device from a seeded `torch.Generator` with the reference init
(`_init_transformer_weights`, :128-143): N(0, initializer_range) for the
encoder's Linear and Embedding weights, zero biases, LayerNorm ones and
zeros; the pretraining heads' `transform` and `nsp` keep paddle Linear's
default Xavier-normal init, as in the reference, and `mlm_bias` is zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.layers import Dropout, LayerNorm, Linear

__all__ = ["ErnieConfig", "ErnieSelfAttention", "ErnieLayer",
           "ErnieEmbeddings", "ErnieModel", "ErnieForPretraining"]


@dataclasses.dataclass
class ErnieConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    recompute: bool = False
    fused_mlm_loss: bool = False

    @classmethod
    def ernie_base(cls):
        return cls(vocab_size=18000)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=256,
                   max_position_embeddings=128)


class ErnieSelfAttention(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.num_heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **fk)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.dropout_p = cfg.attention_probs_dropout_prob

    def forward(self, x, attn_mask=None, generator=None):
        b, s, h = x.shape
        # (b, s, 3, heads, hd) -> q, k, v in sdpa's (b, s, heads, hd)
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        ctx = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout_p if self.training else 0.0,
            training=self.training, generator=generator)
        return self.out(ctx.reshape(b, s, h))


class ErnieLayer(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.attention = ErnieSelfAttention(cfg, **fk)
        self.attn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.ffn_in = Linear(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.ffn_out = Linear(cfg.intermediate_size, cfg.hidden_size, **fk)
        self.ffn_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, x, attn_mask=None, generator=None):
        # post-LN (BERT convention)
        a = self.attention(x, attn_mask, generator)
        x = self.attn_norm(x + self.dropout(a, generator))
        f = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_norm(x + self.dropout(f, generator))


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **fk)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size, **fk)
        self.norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                generator=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(s, dtype=torch.int64,
                                        device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (F.embedding(input_ids, self.word_embeddings.weight)
               + F.embedding(position_ids, self.position_embeddings.weight)
               + F.embedding(token_type_ids,
                             self.token_type_embeddings.weight))
        return self.dropout(self.norm(emb), generator)


class ErnieModel(nn.Module):
    """Encoder stack; returns (sequence_output, pooled_output)."""

    def __init__(self, cfg: Optional[ErnieConfig] = None, device=None,
                 dtype=None):
        super().__init__()
        self.config = cfg or ErnieConfig.ernie_base()
        cfg = self.config
        if cfg.recompute:
            raise NotImplementedError(
                "ErnieConfig.recompute (activation checkpointing) is not "
                "ported yet (ROADMAP queue 1, T6: recompute via "
                "torch.utils.checkpoint)")
        fk = {"device": device, "dtype": dtype}
        self.embeddings = ErnieEmbeddings(cfg, **fk)
        self.layers = nn.ModuleList([ErnieLayer(cfg, **fk)
                                     for _ in range(cfg.num_hidden_layers)])
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **fk)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, generator=None):
        if attention_mask is not None:
            # [b, s] 1/0 mask -> additive [b, 1, 1, s]
            attention_mask = ((1.0 - attention_mask.float()) * -1e4
                              )[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            generator)
        for layer in self.layers:
            x = layer(x, attention_mask, generator)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(nn.Module):
    """MLM + NSP heads; forward returns (prediction_logits,
    seq_rel_logits), or (mlm_loss, seq_rel_logits) given
    `masked_lm_labels`."""

    def __init__(self, cfg: Optional[ErnieConfig] = None, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        fk = {"device": dev, "dtype": dtype}
        self.ernie = ErnieModel(cfg, **fk)
        cfg = self.ernie.config
        self.config = cfg
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **fk)
        self.mlm_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, **fk))
        self.nsp = Linear(cfg.hidden_size, 2, **fk)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw every weight from `seed` on the model's device."""
        dev = self.mlm_bias.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        std = self.config.initializer_range
        for mod in self.ernie.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=gen)
            if isinstance(mod, nn.Linear):
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in (self.transform, self.nsp):      # Xavier-normal
            out_f, in_f = mod.weight.shape
            mod.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                               generator=gen)
            mod.bias.zero_()
        self.mlm_norm.weight.fill_(1.0)
        self.mlm_norm.bias.zero_()
        self.mlm_bias.zero_()

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, masked_lm_labels=None, generator=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask, generator)
        h = self.mlm_norm(F.gelu(self.transform(seq)))
        word_emb = self.ernie.embeddings.word_embeddings.weight
        if masked_lm_labels is not None:
            if self.config.fused_mlm_loss:
                # tied-weight LM head + CE in one chunked pass: the fp32
                # (b*s, vocab) logits tensor never exists
                mlm_loss = F.fused_linear_cross_entropy(
                    h.reshape(-1, self.config.hidden_size), word_emb,
                    self.mlm_bias, masked_lm_labels.reshape(-1),
                    ignore_index=-100, transpose_y=True)
            else:
                logits = F.matmul(h, word_emb, transpose_y=True) + \
                    self.mlm_bias
                mlm_loss = F.cross_entropy(
                    logits.reshape(-1, self.config.vocab_size),
                    masked_lm_labels.reshape(-1), ignore_index=-100)
            return mlm_loss, self.nsp(pooled)
        logits = F.matmul(h, word_emb, transpose_y=True) + self.mlm_bias
        return logits, self.nsp(pooled)
