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

`tensor_parallel=True` (reference :50-60, :113-123, :141-204) builds the
Megatron blocks of fleet's mp layers over the mp group of the fleet
topology: `VocabParallelEmbedding` for the tokens, the fused QKV a
`ColumnParallelLinear` that keeps its output split by head (each rank runs
K1-K3 on its heads / mp heads; the full weight laid out (mp, 3, heads /
mp, hd) as `serving/tp.py`'s `interleave_qkv`, so a contiguous 1 / mp is
one rank's (3, heads / mp, hd) block), the attention output and
`ffn_out` `RowParallelLinear`, `ffn_in` a `ColumnParallelLinear`. The
output is the function of the reference's `gather_output=True` QKV. The
hidden dropout draws from the generator passed in (the same stream on
every mp rank; without one, the tracker's "global_seed" stream), the
attention dropout from the tracker's "model-parallel-rng" stream
(`fleet.meta_parallel.model_parallel_random_seed`). Weights are drawn
whole from the seeded generator in the dense model's order and cut, so a
tensor-parallel model built from a seed holds exactly the slices of the
dense model built from that seed. Tensor-parallel serving does not use
the flag: it shards an ordinary model (serving/tp.py).

The pipeline stages (reference :205-258): `GPTEmbeddingPipe` (token and
position embeddings), `GPTBlock` and `GPTHeadPipe` (final norm and an
untied LM head), listed by `gpt_pipe_layers` for fleet's `PipelineLayer`;
layer i of the list draws its weights from its own generator seeded
`seed + i`, so the list built at tp 1 on one rank and at any mp / pp
degree hold the same weights. `gpt_spmd_pipeline_fn` (reference
:306-384) runs the blocks through fleet's SPMD collective pipeline, one
stage's blocks a rank.
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
           "GPTForCausalLM", "GPTPretrainingCriterion", "GPTEmbeddingPipe",
           "GPTHeadPipe", "gpt_pipe_layers", "gpt_spmd_pipeline_fn"]


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


def _mp():
    from ..distributed.fleet import meta_parallel

    return meta_parallel


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, tensor_parallel: bool = False,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        h = cfg.hidden_size
        self._heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.tensor_parallel = tensor_parallel
        if tensor_parallel:
            mp = _mp()
            self.qkv = mp.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                               **fk)
            # the full weight's output dim is laid out (mp, 3, heads/mp, hd)
            # (the parameters carry it for the distributed checkpoint)
            self.qkv.interleave_heads = self._heads
            for p in self.qkv.parameters():
                p.interleave_heads = self._heads
            self.out = mp.RowParallelLinear(h, h, input_is_parallel=True,
                                            **fk)
        else:
            self.qkv = Linear(h, 3 * h, **fk)
            self.out = Linear(h, h, **fk)
        self.dropout_p = cfg.attention_probs_dropout_prob

    @property
    def num_heads(self) -> int:
        """The heads this module runs: all of them, or heads / mp under
        tensor parallelism (read from the QKV's mp group, so a model
        bound to a group later follows it)."""
        if self.tensor_parallel:
            return self._heads // self.qkv.mp_size
        return self._heads

    @num_heads.setter
    def num_heads(self, value: int) -> None:
        self._heads = value * (self.qkv.mp_size if self.tensor_parallel
                               else 1)

    def forward(self, x, cache=None, start_pos=0, generator=None):
        b, s, _ = x.shape
        # the reference's [b, s, 3, heads, hd] split of the fused product
        q, k, v = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        if cache is not None:  # KV-cache decode (inference only)
            return self.attend(q, k, v, b, s, cache, start_pos)
        if self.tensor_parallel and self.training and self.dropout_p > 0:
            generator = _mp().get_rng_state_tracker().generator(
                "model-parallel-rng")
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
    def __init__(self, cfg: GPTConfig, tensor_parallel: bool = False,
                 device=None, dtype=None, seed: Optional[int] = None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.tensor_parallel = tensor_parallel
        self.ln1 = LayerNorm(h, eps, **fk)
        self.attn = GPTAttention(cfg, tensor_parallel, **fk)
        self.ln2 = LayerNorm(h, eps, **fk)
        if tensor_parallel:
            mp = _mp()
            self.ffn_in = mp.ColumnParallelLinear(
                h, cfg.intermediate_size, gather_output=False, **fk)
            self.ffn_out = mp.RowParallelLinear(
                cfg.intermediate_size, h, input_is_parallel=True, **fk)
        else:
            self.ffn_in = Linear(h, cfg.intermediate_size, **fk)
            self.ffn_out = Linear(cfg.intermediate_size, h, **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        if seed is not None:
            init_gpt_weights(self, seed)

    def _ffn(self, x, generator):
        return self.dropout(self.ffn_out(F.gelu(self.ffn_in(self.ln2(x)))),
                            generator)

    def forward(self, x, cache=None, start_pos=0, generator=None):
        generator = _hidden_stream(self, generator)
        if cache is None:
            x = F.add(x, self.dropout(self.attn(self.ln1(x),
                                                generator=generator),
                                      generator))
            return F.add(x, self._ffn(x, generator))
        attn, cache = self.attn(self.ln1(x), cache, start_pos)
        x = x + self.dropout(attn, generator)
        return x + self._ffn(x, generator), cache


def _hidden_stream(module, generator):
    """The hidden dropout's generator: the one passed in, else (tensor
    parallel, training, dropout on) the tracker's "global_seed" stream."""
    if (generator is None and getattr(module, "tensor_parallel", False)
            and module.training and module.dropout.p > 0):
        return _mp().get_rng_state_tracker().generator("global_seed")
    return generator


def _embed_tokens(wte, ids):
    """The token lookup: fleet's VocabParallelEmbedding, or the port's
    `F.embedding` over a dense table."""
    if isinstance(wte, nn.Embedding):
        return F.embedding(ids, wte.weight)
    return wte(ids)


@torch.no_grad()
def init_gpt_weights(module: nn.Module, seed: int) -> None:
    """Redraw every weight of `module` from `seed` on its device, in
    `modules()` order: N(0, 0.02) for every Linear and Embedding weight (a
    tensor-parallel layer draws the whole weight, in the QKV's interleaved
    layout, and keeps its part), biases zero, LayerNorm ones and zeros."""
    from ..serving.tp import interleave_qkv

    mp = _mp().parallel_layers
    first = next(module.parameters())
    gen = torch.Generator(device=first.device)
    gen.manual_seed(int(seed))
    for mod in module.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.weight.normal_(0.0, 0.02, generator=gen)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, mp._MPLayer):
            w = mod.weight
            shape = list(w.shape)
            if w.split_axis is not None:
                shape[w.split_axis] *= mod.mp_size
            full = torch.empty(shape, device=w.device, dtype=w.dtype)
            full.normal_(0.0, 0.02, generator=gen)
            heads = getattr(mod, "interleave_heads", None)
            if heads is not None:
                full = interleave_qkv(full, heads, mod.mp_size)
            w.copy_(mod.shard_of("weight", full))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class GPTModel(nn.Module):
    def __init__(self, cfg: Optional[GPTConfig] = None,
                 tensor_parallel: bool = False, *, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = cfg = cfg or GPTConfig()
        self.tensor_parallel = tensor_parallel
        fk = {"device": resolve_device(device), "dtype": dtype}
        if tensor_parallel:
            self.wte = _mp().VocabParallelEmbedding(cfg.vocab_size,
                                                    cfg.hidden_size, **fk)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        self.blocks = nn.ModuleList([GPTBlock(cfg, tensor_parallel, **fk)
                                     for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        self.init_weights(seed)

    def init_weights(self, seed: int) -> None:
        """Redraw every weight from `seed` on the model's device."""
        init_gpt_weights(self, seed)

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
        x = self.dropout(F.add(_embed_tokens(self.wte, input_ids),
                               F.embedding(position_ids, self.wpe.weight)),
                         _hidden_stream(self, generator))
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


class GPTEmbeddingPipe(nn.Module):
    """The first pipeline stage: token and position embeddings, then the
    hidden dropout."""

    def __init__(self, cfg: GPTConfig, tensor_parallel: bool = False, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = None):
        super().__init__()
        fk = {"device": resolve_device(device), "dtype": dtype}
        self.config = cfg
        self.tensor_parallel = tensor_parallel
        if tensor_parallel:
            self.wte = _mp().VocabParallelEmbedding(cfg.vocab_size,
                                                    cfg.hidden_size, **fk)
        else:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                                **fk)
        self.dropout = Dropout(cfg.hidden_dropout_prob)
        if seed is not None:
            init_gpt_weights(self, seed)

    def forward(self, input_ids, generator=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        pos = pos.clamp(0, self.config.max_position_embeddings - 1)[None]
        return self.dropout(F.add(_embed_tokens(self.wte, input_ids),
                                  F.embedding(pos, self.wpe.weight)),
                            _hidden_stream(self, generator))


class GPTHeadPipe(nn.Module):
    """The last pipeline stage: the final LayerNorm and an untied LM head
    (column-parallel over the vocabulary, its output gathered, under
    tensor parallelism)."""

    def __init__(self, cfg: GPTConfig, tensor_parallel: bool = False, *,
                 device=None, dtype: torch.dtype = torch.float32,
                 seed: Optional[int] = None):
        super().__init__()
        fk = {"device": resolve_device(device), "dtype": dtype}
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **fk)
        if tensor_parallel:
            self.head = _mp().ColumnParallelLinear(
                cfg.hidden_size, cfg.vocab_size, has_bias=False, **fk)
        else:
            self.head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                               **fk)
        if seed is not None:
            init_gpt_weights(self, seed)

    def forward(self, x):
        return self.head(self.ln_f(x))


def gpt_pipe_layers(cfg: GPTConfig, tensor_parallel: bool = False, *,
                    device=None, dtype: torch.dtype = torch.float32,
                    seed: int = 0):
    """The `LayerDesc` list of fleet's `PipelineLayer`: the embeddings,
    the blocks, the head (the GPTForCausalLMPipe shape of the reference);
    layer i draws its weights from `seed + i`."""
    LayerDesc = _mp().LayerDesc
    fk = {"device": device, "dtype": dtype}
    descs = [LayerDesc(GPTEmbeddingPipe, cfg, tensor_parallel, seed=seed,
                       **fk)]
    descs += [LayerDesc(GPTBlock, cfg, tensor_parallel, seed=seed + 1 + i,
                        **fk) for i in range(cfg.num_hidden_layers)]
    descs.append(LayerDesc(GPTHeadPipe, cfg, tensor_parallel,
                           seed=seed + 1 + cfg.num_hidden_layers, **fk))
    return descs


def gpt_spmd_pipeline_fn(model: GPTModel, group=None, *, num_stages: int,
                         num_micro: int, data_group=None):
    """The blocks of `model` pipelined over the stage ranks of `group`
    (default: the fleet topology's pp group) by fleet's SPMD collective
    pipeline: this rank's stage runs blocks [s * n / S, (s + 1) * n / S);
    embeddings, the final norm and the tied head run replicated on every
    rank. Returns (fn, stage_params, embed_params), fn(stage_params,
    embed_params, input_ids) -> logits; gradients reach both parameter
    dicts. The blocks run in eval mode, as the reference's."""
    from torch.func import functional_call

    from ..distributed.fleet.meta_parallel.spmd_pipeline import (
        _pp_group, make_spmd_pipeline_fn)

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    if n_layers % num_stages:
        raise ValueError(f"{n_layers} blocks do not split over "
                         f"{num_stages} stages")
    per = n_layers // num_stages
    g = _pp_group(group)
    stage = g.rank if g is not None else 0
    blocks = list(model.blocks[stage * per:(stage + 1) * per])
    names = [[n for n, _ in blk.named_parameters()] for blk in blocks]
    stage_params = {f"{i}.{n}": p for i, blk in enumerate(blocks)
                    for n, p in blk.named_parameters()}
    model.eval()

    def stage_fn(params, x):
        for i, blk in enumerate(blocks):
            x = functional_call(blk, {n: params[f"{i}.{n}"]
                                      for n in names[i]}, (x,))
        return x

    pipe = make_spmd_pipeline_fn(stage_fn, g, num_stages=num_stages,
                                 num_micro=num_micro, data_group=data_group)
    embed_params = {"wte": model.wte.weight, "wpe": model.wpe.weight,
                    "g": model.ln_f.weight, "b": model.ln_f.bias}

    def fn(stage_params, embed_params, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, dtype=torch.int64, device=input_ids.device)
        h = F.add(F.embedding(input_ids, embed_params["wte"]),
                  F.embedding(pos[None], embed_params["wpe"]))
        h = pipe(stage_params, h)
        h = F.layer_norm(h, cfg.hidden_size, embed_params["g"],
                         embed_params["b"], cfg.layer_norm_eps)
        return F.matmul(h, embed_params["wte"], transpose_y=True)

    return fn, stage_params, embed_params
