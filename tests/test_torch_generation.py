"""paddle_tpu_torch's static-cache generation (models/generation.py)
against the JAX package's, on the same weights (carried by
`load_reference_state`), mirroring tests/test_generation.py.

- the static branch of `attend_with_cache` against the reference's (GQA,
  a T5-style bias, start_pos > 0): context within atol 1e-5, caches
  exact; a bf16 model over an fp32 cache follows the port's stated rule
  (attention in the cache's type, the context back in the model's type),
  held against the reference within one bf16 rounding;
- prefill logits against the no-cache forward (atol 2e-5 port against
  port, 1e-4 against JAX);
- greedy `generate` token-identical to the JAX `generate` for LLaMA tiny
  (GQA) and GPT tiny, eos padding included;
- sampling: seeded streams reproducible, another seed or no seed differs,
  top_k = 1 is greedy, and the kept set of temperature / top-k / top-p
  equal to the reference `_sample`'s on the same logits;
- beam search token-identical to the JAX `_beam_generate` (b 2, k 3, with
  and without eos, with length_penalty), the exhaustive oracle of
  test_generation.py, the tie rule of `_beam_select`, the knob refusal.

All fp32 on the CPU, where K1 runs its plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.models import generation as jgen

from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM, generate, init_caches)
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.weights import load_reference_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _beam_cfg(cls):
    # tests/test_generation.py TestBeamSearch's model: vocab 64, GQA
    return cls(vocab_size=64, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=64, max_position_embeddings=64)


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(JAX model, port model) on the same weights, both in eval mode."""
    paddle.seed({"llama": 1234, "gpt": 1234, "beam": 3}[kind])
    if kind == "llama":
        jm, pm = JLlama(JLlamaConfig.tiny()), LlamaForCausalLM(
            LlamaConfig.tiny(), device="cpu")
    elif kind == "gpt":
        jm, pm = JGPT(JGPTConfig.tiny()), GPTForCausalLM(GPTConfig.tiny(),
                                                         device="cpu")
    else:
        jm, pm = JLlama(_beam_cfg(JLlamaConfig)), LlamaForCausalLM(
            _beam_cfg(LlamaConfig), device="cpu")
    jm.eval()
    params, _ = extract_state(jm)
    load_reference_state(pm, {k: np.asarray(v) for k, v in params.items()})
    return jm, pm


def _vocab(kind):
    return {"llama": 512, "gpt": 1024, "beam": 64}[kind]


def _ids(kind, seed, shape):
    return np.random.RandomState(seed).randint(0, _vocab(kind), shape)


def _jax_generate(kind, ids, **kw):
    return jgen.generate(_pair(kind)[0], jnp.asarray(ids), **kw).numpy()


def _port_generate(kind, ids, **kw):
    return generate(_pair(kind)[1], torch.from_numpy(ids), **kw).numpy()


# ------------------------------------------------------- attend_with_cache

def _attend_inputs(seed, b, s, h, kvh, d, max_len, with_bias):
    r = np.random.RandomState(seed)
    q = r.randn(b, s, h, d).astype(np.float32)
    k, v = (r.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    kc, vc = (r.randn(b, max_len, kvh, d).astype(np.float32)
              for _ in range(2))
    bias = (r.randn(1, h, s, max_len).astype(np.float32)
            if with_bias else None)
    return q, k, v, kc, vc, bias


@pytest.mark.parametrize("rep,s,start,with_bias", [
    (1, 1, 0, False), (2, 1, 5, False), (2, 4, 3, False), (1, 3, 6, True),
    (1, 1, 9, True)])
def test_static_attend_matches_reference(rep, s, start, with_bias):
    h, d, max_len = 4, 16, 12
    q, k, v, kc, vc, bias = _attend_inputs(rep * 10 + start, 2, s, h,
                                           h // rep, d, max_len, with_bias)
    ref, (rkc, rvc) = jgen.attend_with_cache(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), (jnp.asarray(kc), jnp.asarray(vc)), start,
        rep, bias=None if bias is None else jnp.asarray(bias))
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    got, (gkc, gvc) = gen.attend_with_cache(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cache,
        start, rep, bias=None if bias is None else torch.from_numpy(bias))
    # written in place, not reallocated
    assert gkc is cache[0] and gvc is cache[1]
    np.testing.assert_array_equal(gkc.numpy(), np.asarray(rkc))
    np.testing.assert_array_equal(gvc.numpy(), np.asarray(rvc))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)


def test_bf16_model_over_fp32_cache_follows_the_stated_rule():
    """bf16 q / k / v over fp32 caches: the caches hold the fp32 values of
    k / v (as the reference's), attention runs in fp32 and the context
    comes back in bf16 -- the reference's fp32 context rounded once to bf16
    (within one bf16 rounding: 2^-8 of the largest output, stated)."""
    q, k, v, kc, vc, _ = _attend_inputs(7, 2, 3, 4, 2, 16, 10, False)
    bf = [x.astype(jnp.bfloat16) for x in (q, k, v)]
    ref, (rkc, _) = jgen.attend_with_cache(
        *(Tensor(jnp.asarray(x)) for x in bf),
        (jnp.asarray(kc), jnp.asarray(vc)), 4, 2)
    assert ref.numpy().dtype == np.float32       # the reference promotes
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    got, (gkc, _) = gen.attend_with_cache(tq, tk, tv, cache, 4, 2)
    assert got.dtype == torch.bfloat16 and gkc.dtype == torch.float32
    np.testing.assert_array_equal(gkc.numpy(), np.asarray(rkc))
    ref32 = np.asarray(ref.numpy(), np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref32, rtol=0,
                               atol=2 ** -8 * np.abs(ref32).max())


def test_bf16_llama_with_fp32_cache_against_reference():
    """The rule at model level: LLaMA tiny in bf16 on both sides, fp32
    caches. The reference's residual stream turns fp32 at the first
    attention block (its context stays fp32) while the port's stays bf16,
    so the prefill logits agree to bf16 rounding of the stream: atol 0.05
    against logits of magnitude ~1 (stated), and the greedy first tokens
    agree wherever the reference's top-2 margin exceeds 0.1."""
    paddle.seed(1234)
    jm = JLlama(JLlamaConfig.tiny())
    jm.eval()
    params = {k: np.asarray(v) for k, v in extract_state(jm)[0].items()}
    jm.bfloat16()
    pm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                          dtype=torch.bfloat16)
    load_reference_state(pm, params)
    ids = _ids("llama", 8, (2, 9))
    from paddle_tpu.jit.functional import call_functional

    jp, jb = extract_state(jm)

    @jax.jit
    def prefill(jp, jb, ids):
        (logits, _), _ = call_functional(
            jm, jp, jb, (Tensor(ids),),
            kwargs={"caches": jgen.init_caches(jm, 2, 12), "start_pos": 0},
            training=False)
        return logits

    ref = np.asarray(prefill(jp, jb, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got, caches = pm(torch.from_numpy(ids),
                         caches=init_caches(pm, 2, 12, "float32"),
                         start_pos=0)
    assert got.dtype == torch.bfloat16
    assert caches[0][0].dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=0.05)
    top2 = np.sort(ref[:, -1], axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 0.1
    np.testing.assert_array_equal(got.float().numpy()[sure, -1].argmax(-1),
                                  ref[sure, -1].argmax(-1))


# ------------------------------------------------------------ cache parity

@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_prefill_matches_no_cache_forward(kind):
    jm, pm = _pair(kind)
    ids = _ids(kind, 0, (2, 8))
    with torch.no_grad():
        full = pm(torch.from_numpy(ids)).numpy()
        cached, _ = pm(torch.from_numpy(ids), caches=init_caches(pm, 2, 16),
                       start_pos=0)
    np.testing.assert_allclose(cached.numpy(), full, rtol=0, atol=2e-5)
    from paddle_tpu.jit.functional import call_functional

    forward = jax.jit(lambda p, b, x: call_functional(
        jm, p, b, (Tensor(x),), training=False)[0])
    ref = forward(*extract_state(jm), jnp.asarray(ids))
    np.testing.assert_allclose(full, np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_greedy_generate_token_identical_to_jax(kind):
    ids = _ids(kind, 1, (3, 6))
    got = _port_generate(kind, ids, max_new_tokens=7, temperature=0.0)
    ref = _jax_generate(kind, ids, max_new_tokens=7, temperature=0.0)
    assert got.shape == (3, 13) and got.dtype == ids.dtype
    np.testing.assert_array_equal(got[:, :6], ids)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_eos_padding_identical_to_jax(kind):
    """Row 0's first greedy token is eos: it finishes at once, the other
    row later or never; 20 new tokens cross the 16-step host poll."""
    ids = _ids(kind, 5, (2, 4))
    free = _port_generate(kind, ids, max_new_tokens=20, temperature=0.0)
    eos = int(free[0, 4])
    got = _port_generate(kind, ids, max_new_tokens=20, temperature=0.0,
                         eos_token_id=eos)
    ref = _jax_generate(kind, ids, max_new_tokens=20, temperature=0.0,
                        eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 4:] == eos).all()
    # one row alone: every row finished, the early exit pads with eos
    one = _port_generate(kind, ids[:1], max_new_tokens=20, temperature=0.0,
                         eos_token_id=eos)
    assert one.shape == (1, 24) and (one[0, 4:] == eos).all()


def test_mismatched_cache_count_raises():
    for kind in ("llama", "gpt"):
        pm = _pair(kind)[1]
        caches = init_caches(pm, 1, 8)[:-1]          # one short
        with pytest.raises(ValueError, match="caches"):
            pm(torch.zeros((1, 4), dtype=torch.int64), caches=caches,
               start_pos=0)


def test_cache_dtype_by_name_and_train_mode_restored():
    pm = _pair("gpt")[1]
    caches = init_caches(pm, 2, 5, "bfloat16")
    assert len(caches) == 2 and caches[0][0].dtype == torch.bfloat16
    assert tuple(caches[0][0].shape) == (2, 5, 4, 32)
    ids = _ids("gpt", 2, (1, 3))
    a = _port_generate("gpt", ids, max_new_tokens=3, temperature=0.0,
                       cache_dtype="float32")
    b = _port_generate("gpt", ids, max_new_tokens=3, temperature=0.0,
                       cache_dtype=torch.float32)
    np.testing.assert_array_equal(a, b)
    pm.train()
    try:
        pm.generate(torch.from_numpy(ids), max_new_tokens=2,
                    temperature=0.0)
        assert pm.training
    finally:
        pm.eval()
    with pytest.raises(ValueError, match="cache dtype"):
        init_caches(pm, 1, 4, "int3")


# ---------------------------------------------------------------- sampling

def test_seeded_sampling_reproducible_and_seed_dependent():
    ids = _ids("llama", 2, (2, 4))
    kw = dict(max_new_tokens=8, temperature=0.8, top_k=50, top_p=0.9)
    a = _port_generate("llama", ids, seed=7, **kw)
    b = _port_generate("llama", ids, seed=7, **kw)
    c = _port_generate("llama", ids, seed=8, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_unseeded_sampling_differs_across_calls():
    ids = _ids("llama", 6, (1, 4))
    outs = {tuple(_port_generate("llama", ids, max_new_tokens=8,
                                 temperature=1.5)[0]) for _ in range(4)}
    assert len(outs) > 1


def test_top_k_one_is_greedy():
    ids = _ids("llama", 3, (2, 4))
    greedy = _port_generate("llama", ids, max_new_tokens=5, temperature=0.0)
    topk1 = _port_generate("llama", ids, max_new_tokens=5, temperature=0.5,
                           top_k=1, seed=0)
    np.testing.assert_array_equal(greedy, topk1)


def test_draws_differ_across_rows_and_steps():
    d = gen._Draws(11, 2, 50, torch.device("cpu"))
    u0, u1 = d(0), d(1)
    assert u0.shape == (2, 50) and bool(((u0 > 0) & (u0 < 1)).all())
    assert not torch.equal(u0[0], u0[1]) and not torch.equal(u0, u1)
    assert torch.equal(u0, gen._Draws(11, 2, 50, torch.device("cpu"))(0))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.0, 0, 0.6), (1.3, 8, 0.8),
    (0.9, 3, 0.05)])
def test_kept_set_equals_the_reference_rule(temperature, top_k, top_p,
                                            monkeypatch):
    """The logits the reference's `_sample` hands its categorical draw,
    against those the port's draws from, on the same logits (with ties)."""
    r = np.random.RandomState(int(temperature * 10) + top_k)
    logits = r.randn(4, 40).astype(np.float32)
    logits[:, 5] = logits[:, 6]                   # a tie
    seen = {}

    def capture(key, lg, axis=-1):
        seen["ref"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen._sample(jnp.asarray(logits), jax.random.key(0), temperature, top_k,
                 top_p)
    ref_kept = np.isfinite(seen["ref"])
    # the port's: a token can be drawn iff its masked logit is finite; a
    # uniform of 1 - eps everywhere leaves the draw to the masked logits
    got_kept = np.zeros_like(ref_kept)
    lg = torch.from_numpy(logits)
    for j in range(logits.shape[1]):
        u = torch.full(lg.shape, 1e-30)
        u[:, j] = 1.0 - 1e-7                      # Gumbel noise ~ +16
        pick = gen._sample(lg, u, temperature, top_k, top_p).numpy()
        got_kept[:, j] = pick == j
    np.testing.assert_array_equal(got_kept, ref_kept)


# ------------------------------------------------------------- beam search

@pytest.mark.parametrize("eos,length_penalty", [(None, 0.0), ("hit", 0.0),
                                                ("hit", 1.0)])
def test_beam_search_token_identical_to_jax(eos, length_penalty):
    ids = _ids("beam", 9, (2, 3))
    kw = dict(max_new_tokens=5, num_beams=3, length_penalty=length_penalty)
    if eos == "hit":
        # a token the free search emits, so eos freezing takes part
        free = _port_generate("beam", ids, **kw)
        kw["eos_token_id"] = int(free[0, 4])
    got = _port_generate("beam", ids, **kw)
    ref = _jax_generate("beam", ids, **kw)
    np.testing.assert_array_equal(got, ref)
    if eos == "hit":
        for row in got[:, 3:]:
            hit = np.flatnonzero(row == kw["eos_token_id"])
            if hit.size:
                assert (row[hit[0]:] == kw["eos_token_id"]).all()


def test_beam1_equals_greedy():
    ids = np.array([[1, 5, 9]], np.int64)
    greedy = _port_generate("beam", ids, max_new_tokens=6, temperature=0.0)
    beam1 = _port_generate("beam", ids, max_new_tokens=6, num_beams=1,
                           temperature=0.0)
    np.testing.assert_array_equal(greedy, beam1)


def test_beam_search_exhaustive_oracle():
    """With beam width V >= V^(T-1) nothing is pruned, so the beam must be
    the argmax over all V^T continuations, scored by teacher forcing
    (tests/test_generation.py's oracle)."""
    pm = _pair("beam")[1]
    prompt = np.array([[2, 7, 3]], np.int64)
    pl, vocab, t = 3, 64, 2
    beam = _port_generate("beam", prompt, max_new_tokens=t,
                          num_beams=vocab)[0]
    with torch.no_grad():
        seqs = torch.from_numpy(np.concatenate(
            [np.repeat(prompt, vocab, 0), np.arange(vocab)[:, None]], 1))
        logp = torch.log_softmax(pm(seqs).float(), dim=-1).numpy()
    # logp of t1 (same for every row), then the best t2 after each t1
    lp1 = logp[0, pl - 1]
    lp2 = logp[:, pl]
    scores = lp1[:, None] + lp2                     # (t1, t2)
    t1, t2 = np.unravel_index(np.argmax(scores), scores.shape)
    np.testing.assert_array_equal(beam, [2, 7, 3, t1, t2])


def test_beam_select_breaks_ties_toward_the_lower_index():
    """After eos freezing a row holds one 0.0 and the rest -inf, so ties
    occur; the port picks as jax.lax.top_k does."""
    frozen = np.full((2, 3, 5), -np.inf, np.float32)
    frozen[0, :, 2] = 0.0                          # three finished beams
    frozen[1, 0] = [0.5, 0.5, -1.0, 0.5, 0.2]      # ties within a beam
    frozen[1, 2] = [0.5, -np.inf, 0.5, 0.1, 0.5]   # and across beams
    ref = jgen._beam_select(jnp.asarray(frozen))
    got = gen._beam_select(torch.from_numpy(frozen))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_beam_rejects_sampling_knobs():
    for kw in (dict(top_k=5), dict(top_p=0.9), dict(temperature=0.7)):
        with pytest.raises(ValueError, match="beam search"):
            _port_generate("beam", np.array([[1]], np.int64), num_beams=2,
                           **kw)


def test_beam_reorder_swaps_preallocated_buffers(monkeypatch):
    """Every step's reorder gathers into the spare caches (index_select
    with out=): no cache is allocated after the two initial sets."""
    calls = {"init": 0, "out": 0}
    real_init, real_sel = gen.init_caches, torch.index_select

    def counting_init(*a, **k):
        calls["init"] += 1
        return real_init(*a, **k)

    def counting_sel(src, dim, index, out=None):
        calls["out"] += out is not None
        return real_sel(src, dim, index, out=out)

    monkeypatch.setattr(gen, "init_caches", counting_init)
    monkeypatch.setattr(torch, "index_select", counting_sel)
    _port_generate("beam", np.array([[4, 2]], np.int64), max_new_tokens=4,
                   num_beams=2)
    # 2 layers x (k, v) x 3 decode steps, all into preallocated buffers
    assert calls == {"init": 2, "out": 12}
