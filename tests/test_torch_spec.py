"""paddle_tpu_torch.serving.spec, speculative decoding in the port's
engine, against the JAX package and port against port.

- the host functions against the JAX module's on the same inputs:
  `_ngram_continuation`, `propose_drafts` (with a prefix cache built the
  same way), `build_draft_buffer`, `parse_emitted_row`, `SpecConfig`'s
  validation;
- greedy streams token-identical to the JAX engine with `spec_config` at
  decode horizons 1 and 8 and lookaheads 1, 2 and 4; under chunked prefill
  (the chained step), preemption pressure, int8 pools and `method=
  "combined"` with the prefix cache on;
- the ragged step with speculation against the JAX engine with
  speculation OFF: the JAX engine's ragged step drains a speculative
  record only after `schedule()` has charged the next block, so its
  revert pops pages that block writes through and its streams differ from
  its own spec-off streams (a fact of the reference, ROADMAP queue 3);
  the port drains such a record before `schedule()`, and
  `test_ragged_spec_matches_spec_off_and_the_chained_step` holds it to the
  spec-off streams of both engines;
- port invariants: spec-on == spec-off for greedy streams; seeded
  stochastic streams reproducible and independent of the horizon; the
  accept / resample rule keeps the target distribution (a unit test over
  many draw indices, and the engine-level marginal); a row without drafts
  takes the plain decode step's sample bit for bit; the page charge and
  its revert audited after every step; a spec-off engine never imports
  `serving.spec`.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import SpecConfig as JSpecConfig
from paddle_tpu.serving import spec as jspec
from paddle_tpu.serving.kv_cache import BlockAllocator as JBlockAllocator
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (BlockAllocator, PrefixCache,
                                      ServingEngine, SpecConfig)
from paddle_tpu_torch.serving import sampling as tsampling
from paddle_tpu_torch.serving import spec as tspec
from paddle_tpu_torch.weights import load_reference_state

VOCAB = 512
PAD = tsampling.PAD_TOKEN


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_llama():
    paddle.seed(1234)
    m = JLlama(JLlamaConfig.tiny())
    m.eval()
    return m


@functools.lru_cache(maxsize=None)
def _port_llama():
    params, _ = extract_state(_jax_llama())
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(m, {k: np.asarray(v) for k, v in params.items()})
    return m


def _prompts(n=3, repetitive=True, seed=53):
    """Repetitive prompts draft well (prompt lookup hits); random ones
    rarely draft, so their rows run as plain decode steps."""
    rng = np.random.RandomState(seed)
    if repetitive:
        pat = rng.randint(0, VOCAB, (8,)).tolist()
        return [pat * 3 + pat[:1 + i] for i in range(n)]
    return [rng.randint(0, VOCAB, (10 + 3 * i,)).tolist() for i in range(n)]


def _kw(prompts, kw):
    kw = dict(kw)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch_size", max(len(prompts), 1))
    kw.setdefault("max_seq_len", 160)
    return kw


def _run(prompts, nt=16, spec=None, jax=False, **kw):
    """Serve `prompts` greedily on the port's engine (or the JAX one);
    every page must be back in the pool at the end (once the prefix cache
    lets go of its tree)."""
    kw = _kw(prompts, kw)
    if jax:
        cfg = None if spec is None else JSpecConfig(**spec)
        eng = JServingEngine(_jax_llama(), spec_config=cfg, **kw)
    else:
        cfg = None if spec is None else SpecConfig(**spec)
        eng = ServingEngine(_port_llama(), device="cpu", spec_config=cfg,
                            **kw)
    rids = [eng.add_request(p, max_new_tokens=nt) for p in prompts]
    outs = eng.run()
    assert eng.scheduler.check_consistency()
    if eng.prefix_cache is not None:
        eng.prefix_cache.flush()      # the tree's pages are not a leak
    assert eng.cache.allocator.num_used == 0
    return [list(outs[r]) for r in rids], eng


@functools.lru_cache(maxsize=None)
def _jax_stream(key):
    """The JAX engine's greedy streams for a hashable knob set."""
    prompts, nt, spec, kw = key
    return _run([list(p) for p in prompts], nt, None if spec is None
                else dict(spec), jax=True, **dict(kw))[0]


def _key(prompts, nt, spec, kw):
    return (tuple(map(tuple, prompts)), nt,
            None if spec is None else tuple(sorted(spec.items())),
            tuple(sorted(kw.items())))


# ----------------------------------------------- host: against the JAX one

class _Req:
    def __init__(self, prompt, generated=()):
        self.prompt = list(prompt)
        self.generated = list(generated)


def _contexts(seed, n=60):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pat = rng.randint(0, 5, (rng.randint(1, 6),)).tolist()
        ctx = (pat * rng.randint(1, 4)
               + rng.randint(0, 5, (rng.randint(0, 6),)).tolist())
        out.append(ctx)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_ngram_continuation_matches_reference(seed):
    for ctx in _contexts(seed):
        for width, kmax, kmin in ((1, 3, 1), (4, 3, 1), (9, 2, 2),
                                  (5, 4, 1)):
            assert tspec._ngram_continuation(ctx, width, kmax, kmin) \
                == jspec._ngram_continuation(ctx, width, kmax, kmin)


@pytest.mark.parametrize("method", ["ngram", "prefix_cache", "combined"])
def test_propose_and_draft_buffer_match_reference(method):
    """The same trees (seeded inserts) and the same request streams: the
    proposals and the (rows, width) buffers agree value for value."""
    rng = np.random.RandomState(7)
    ta, ja = BlockAllocator(64), JBlockAllocator(64)
    tpc, jpc = PrefixCache(ta, 4), JPrefixCache(ja, 4)
    streams = [rng.randint(0, 6, (rng.randint(8, 24),)).tolist()
               for _ in range(6)]
    for s in streams[:4]:
        n = -(-len(s) // 4)
        tpc.insert(s, ta.alloc_n(n))
        jpc.insert(s, ja.alloc_n(n))
    reqs = [_Req(s[:rng.randint(1, len(s))], s[-2:]) for s in streams]
    for lookahead in (1, 2, 4):
        tcfg = SpecConfig(lookahead=lookahead, method=method)
        jcfg = JSpecConfig(lookahead=lookahead, method=method)
        for r in reqs:
            for limit in (None, 3, 11):
                assert tspec.propose_drafts(r, tcfg, tpc, limit) \
                    == jspec.propose_drafts(r, jcfg, jpc, limit)
        for rows, width in ((6, 5), (8, 12), (7, 1)):
            got = tspec.build_draft_buffer(reqs[:rows], rows, width, tcfg,
                                           tpc)
            ref = jspec.build_draft_buffer(reqs[:rows], rows, width, jcfg,
                                           jpc)
            assert got.shape == ref.shape and got.dtype == np.int64
            np.testing.assert_array_equal(got, ref)


def test_parse_emitted_row_matches_reference():
    rng = np.random.RandomState(3)
    for _ in range(200):
        windows = tuple(int(w) for w in rng.randint(1, 5, rng.randint(1, 5)))
        row = rng.randint(-1, 4, sum(windows)).tolist()
        row = [PAD if t < 0 else t for t in row]
        assert tspec.parse_emitted_row(np.asarray(row), windows) \
            == jspec.parse_emitted_row(np.asarray(row), windows)


@pytest.mark.parametrize("kw,match", [
    (dict(lookahead=0), "lookahead must be >= 1"),
    (dict(method="medusa"), "unknown spec method"),
    (dict(ngram_min=3, ngram_max=2), "ngram_min <= ngram_max"),
    (dict(ngram_min=0), "ngram_min <= ngram_max"),
])
def test_spec_config_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        SpecConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        JSpecConfig(**kw).validate()
    assert SpecConfig().validate() == SpecConfig(lookahead=4,
                                                 method="ngram")


# ------------------------------------------------- the accept / resample rule

def _knobs(b, temperature, top_k=0, top_p=1.0, seed=5):
    return {"seeds": torch.full((b,), seed, dtype=torch.int64),
            "temps": torch.full((b,), temperature),
            "top_ks": torch.full((b,), top_k, dtype=torch.int64),
            "top_ps": torch.full((b,), top_p),
            "eos_ids": torch.full((b,), PAD, dtype=torch.int64),
            "greedy_only": temperature == 0.0}


@pytest.mark.parametrize("knob", [dict(temperature=1.0),
                                  dict(temperature=0.7, top_k=5),
                                  dict(temperature=1.3, top_p=0.8)])
@pytest.mark.parametrize("draft", [1, 6])
def test_accept_rule_keeps_the_target_distribution(knob, draft):
    """One lane over a vocab of 8, the same logits at every draw index:
    the emitted token's histogram over 20000 draw indices is the target
    softmax within total variation 0.02 (the sampling noise of 20000 draws
    over 8 outcomes is ~0.01). A high-probability draft (1) and a
    low-probability one (6) both keep it."""
    n, vocab = 20000, 8
    base = torch.tensor([1.5, 2.0, 0.3, -0.5, 1.0, 0.0, -1.0, 0.8])
    logits = base.expand(n, 2, vocab).contiguous()
    knobs = _knobs(n, **knob)
    drafts = torch.full((n, 1), draft, dtype=torch.int64)
    valid = torch.ones((n, 1), dtype=torch.bool)
    draws = torch.arange(n, dtype=torch.int64) * 2
    k, stop = tspec.accept_and_stop(logits, drafts, valid, knobs, draws)
    emitted = torch.where(k > 0, drafts[:, 0], stop)
    target = torch.softmax(tsampling.target_logits(base[None], knobs), -1)[0]
    hist = torch.bincount(emitted, minlength=vocab).double() / n
    tv = 0.5 * float((hist - target.double()).abs().sum())
    assert tv < 0.02, (tv, hist, target)
    # a draft masked away by top-k / top-p is never accepted
    if float(target[draft]) == 0.0:
        assert int(k.sum()) == 0


def test_row_without_drafts_takes_the_plain_sample():
    """No valid lane: the stop token is `sample_batch` at the row's draw
    index, bit for bit, greedy and stochastic rows mixed."""
    g = torch.Generator().manual_seed(0)
    b, vocab = 64, 50
    logits = torch.randn(b, 3, vocab, generator=g)
    knobs = _knobs(b, 0.9, top_k=20)
    knobs["temps"][::3] = 0.0
    knobs["greedy_only"] = False
    draws = torch.arange(b, dtype=torch.int64) * 7
    drafts = torch.full((b, 2), PAD, dtype=torch.int64)
    valid = torch.zeros((b, 2), dtype=torch.bool)
    k, stop = tspec.accept_and_stop(logits, drafts, valid, knobs, draws)
    assert int(k.sum()) == 0
    assert torch.equal(stop, tsampling.sample_batch(logits[:, 0], knobs,
                                                   draws))


def test_accept_coin_reads_no_gumbel_index():
    """The accept test's uniform is the hash at vocab index V: it differs
    from every Gumbel uniform of the same (seed, draw index)."""
    knobs = _knobs(4, 1.0)
    draws = torch.arange(4, dtype=torch.int64)
    coin = tspec._accept_uniform(knobs, draws, 16)
    u = tsampling.uniforms(knobs["seeds"], draws, 17)
    assert torch.equal(coin, u[:, 16])
    assert not (u[:, :16] == coin[:, None]).any()


# ---------------------------------------------------------- greedy parity

def _parity(h, L, nt=24, n=4, repetitive=True, **kw):
    prompts = _prompts(n, repetitive=repetitive)
    spec = dict(lookahead=L)
    off, _ = _run(prompts, nt, None, decode_horizon=h, **kw)
    on, eng = _run(prompts, nt, spec, decode_horizon=h, **kw)
    assert on == off
    assert on == _jax_stream(_key(prompts, nt, spec,
                                  dict(kw, decode_horizon=h)))
    return eng


class TestGreedyParity:
    @pytest.mark.parametrize("h", [1, 8])
    @pytest.mark.parametrize("L", [1, 2, 4])
    def test_spec_on_equals_spec_off_and_jax(self, h, L):
        eng = _parity(h, L)
        assert eng.stats()["spec"]["drafted_tokens"] > 0

    def test_multiblock_charge_revert(self):
        """h 4, L 4, 16 tokens: blocks back to back across the charge ->
        drain -> revert boundary."""
        eng = _parity(4, 4, nt=16, n=2)
        assert eng.stats()["spec"]["drafted_tokens"] > 0

    def test_random_prompts_run_plain_steps(self):
        _parity(8, 2, repetitive=False)

    @pytest.mark.parametrize("h", [1, 8])
    @pytest.mark.parametrize("L", [1, 2, 4])
    def test_chunked_prefill_chained_step(self, h, L):
        _parity(h, L, enable_chunked_prefill=True, prefill_chunk_tokens=8,
                enable_ragged_step=False)

    def test_preemption_pressure(self):
        prompts = _prompts(3)
        kw = dict(page_size=8, max_batch_size=3, max_seq_len=64,
                  num_pages=14, decode_horizon=4)
        on, eng = _run(prompts, 12, dict(lookahead=4), **kw)
        off, _ = _run(prompts, 12, None, **kw)
        assert on == off
        assert on == _jax_stream(_key(prompts, 12, dict(lookahead=4), kw))
        assert eng.stats()["preemptions"] >= 1

    def test_int8_pools(self):
        prompts = _prompts(3)
        kw = dict(kv_dtype="int8", decode_horizon=8)
        on, _ = _run(prompts, 16, dict(lookahead=4), **kw)
        off, _ = _run(prompts, 16, None, **kw)
        assert on == off
        assert on == _jax_stream(_key(prompts, 16, dict(lookahead=4), kw))

    def test_prefix_cache_and_radix_drafts(self):
        """Two waves sharing prompts: wave 2 prefills from cached pages
        and the combined proposer probes the tree for drafts; the streams
        equal spec-off, and the JAX engine's, with the same hit counts."""
        prompts = _prompts(3)

        def run(spec, jax=False):
            kw = dict(page_size=8, max_batch_size=3, max_seq_len=160,
                      decode_horizon=8, enable_prefix_caching=True)
            if jax:
                eng = JServingEngine(_jax_llama(), spec_config=(
                    None if spec is None else JSpecConfig(**spec)), **kw)
            else:
                eng = ServingEngine(_port_llama(), device="cpu",
                                    spec_config=(None if spec is None
                                                 else SpecConfig(**spec)),
                                    **kw)
            first = [eng.add_request(p, max_new_tokens=16) for p in prompts]
            eng.run()
            second = [eng.add_request(p, max_new_tokens=16) for p in prompts]
            outs = eng.run()
            assert eng.scheduler.check_consistency()
            return [list(outs[r]) for r in first + second], eng

        spec = dict(lookahead=4, method="combined")
        on, eng = run(spec)
        ref, jeng = run(spec, jax=True)
        assert on == run(None)[0] == ref
        assert eng.stats()["prefix_cache"] == jeng.stats()["prefix_cache"]
        assert eng.stats()["prefix_cache"]["hit_tokens"] > 0
        assert eng.stats()["spec"]["drafted_tokens"] \
            == jeng.stats()["spec"]["drafted_tokens"]

    @pytest.mark.parametrize("h", [1, 4, 8])
    @pytest.mark.parametrize("L", [1, 2, 4])
    def test_ragged_spec_matches_spec_off_and_the_chained_step(self, h, L):
        prompts = _prompts(4)
        kw = dict(enable_chunked_prefill=True, prefill_chunk_tokens=8,
                  decode_horizon=h)
        spec = dict(lookahead=L)
        on, eng = _run(prompts, 24, spec, **kw)
        assert eng.stats()["ragged_steps"] > 0
        chained, _ = _run(prompts, 24, spec, enable_ragged_step=False, **kw)
        off, _ = _run(prompts, 24, None, **kw)
        assert on == chained == off
        assert on == _jax_stream(_key(prompts, 24, None, kw))

    def test_ragged_spec_with_the_prefix_cache_and_int8(self):
        prompts = _prompts(4)
        kw = dict(enable_chunked_prefill=True, prefill_chunk_tokens=8,
                  decode_horizon=8, kv_dtype="int8",
                  enable_prefix_caching=True)
        spec = dict(lookahead=2, method="combined")
        on, eng = _run(prompts, 16, spec, **kw)
        off, _ = _run(prompts, 16, None, **kw)
        assert on == off
        assert on == _jax_stream(_key(prompts, 16, None, kw))


# ------------------------------------------------------------- stochastic

def _sampled(h, seeds, spec=dict(lookahead=4), n=3, nt=12, **req_kw):
    prompts = _prompts(n)
    eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                        max_batch_size=n, max_seq_len=160,
                        decode_horizon=h, spec_config=(
                            None if spec is None else SpecConfig(**spec)))
    rids = [eng.add_request(p, max_new_tokens=nt, seed=s, **req_kw)
            for p, s in zip(prompts, seeds)]
    outs = eng.run()
    return [list(outs[r]) for r in rids]


class TestStochastic:
    def test_seeded_run_is_reproducible_and_not_greedy(self):
        a = _sampled(4, (7, 8, 9), temperature=0.8, top_k=40)
        assert a == _sampled(4, (7, 8, 9), temperature=0.8, top_k=40)
        greedy, _ = _run(_prompts(3), 12, None, decode_horizon=4)
        assert a != greedy

    def test_horizon_invariance(self):
        assert _sampled(1, (11, 12), n=2, nt=10, temperature=1.0) \
            == _sampled(4, (11, 12), n=2, nt=10, temperature=1.0)

    def test_accepted_marginal_matches_target_distribution(self):
        """Over 96 seeds, the second generated token (the first one a
        draft is verified for) with spec on and off: total variation over
        the observed support below 0.35, the reference's bound."""
        pat = _prompts(1)[0]

        def marginal(spec):
            eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                                max_batch_size=96, max_seq_len=48,
                                num_pages=256, decode_horizon=1,
                                spec_config=spec)
            rids = [eng.add_request(pat, max_new_tokens=2, temperature=1.0,
                                    seed=s) for s in range(96)]
            outs = eng.run()
            counts = {}
            for r in rids:
                t = outs[r][len(pat) + 1]
                counts[t] = counts.get(t, 0) + 1
            return counts

        on, off = marginal(SpecConfig(lookahead=4)), marginal(None)
        tv = 0.5 * sum(abs(on.get(t, 0) - off.get(t, 0))
                       for t in set(on) | set(off)) / 96
        assert tv < 0.35, f"TV distance {tv:.3f}: the accept rule is biased"


# --------------------------------------------------------- stats, surface

class TestSpecStats:
    def test_repetitive_prompt_beats_one_token_per_step(self):
        _, eng = _run(_prompts(4), 24, dict(lookahead=4), decode_horizon=1)
        st = eng.stats()["spec"]
        assert st["lookahead"] == 4 and st["method"] == "ngram"
        assert st["drafted_tokens"] > 0
        assert 0.0 < st["accept_rate"] <= 1.0
        assert st["accepted_tokens"] + st["wasted_tokens"] \
            == st["drafted_tokens"]
        assert st["tokens_per_target_step"] > 1.0
        assert st["tokens_per_step"]["count"] > 0
        reg = eng.metrics
        assert reg.get("serving_spec_drafted_tokens_total").value \
            == st["drafted_tokens"]
        assert reg.get("serving_spec_target_steps_total").value \
            == st["target_steps"]

    def test_stats_match_the_jax_engine(self):
        prompts = _prompts(4)
        _, eng = _run(prompts, 24, dict(lookahead=4), decode_horizon=1)
        _, jeng = _run(prompts, 24, dict(lookahead=4), jax=True,
                       decode_horizon=1)
        keys = ("drafted_tokens", "accepted_tokens", "target_steps",
                "tokens_per_target_step")
        assert {k: eng.stats()["spec"][k] for k in keys} \
            == {k: jeng.stats()["spec"][k] for k in keys}

    def test_spec_off_stats_have_no_spec_key(self):
        _, eng = _run(_prompts(1), 4)
        assert "spec" not in eng.stats()

    def test_stats_without_metrics_keep_their_shape(self):
        _, eng = _run(_prompts(4), 24, dict(lookahead=4),
                      decode_horizon=1, enable_metrics=False)
        st = eng.stats()["spec"]
        assert st["drafted_tokens"] > 0
        assert st["tokens_per_step"]["count"] == 0

    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(_port_llama(), spec_config=SpecConfig())


class TestZeroTouchSpecOff:
    def test_spec_off_never_imports_spec_module(self, monkeypatch):
        """Poison paddle_tpu_torch.serving.spec: a spec-off engine runs a
        request without touching it, and a spec-on engine trips it."""
        poison = types.ModuleType("paddle_tpu_torch.serving.spec")

        def _boom(name):
            raise AssertionError(f"spec module touched spec-off: {name}")

        poison.__getattr__ = _boom
        monkeypatch.setitem(sys.modules, "paddle_tpu_torch.serving.spec",
                            poison)
        import paddle_tpu_torch.serving as serving_pkg
        monkeypatch.setattr(serving_pkg, "spec", poison)
        outs, _ = _run(_prompts(1), 6)
        assert len(outs[0]) == len(_prompts(1)[0]) + 6
        eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                            max_batch_size=1, max_seq_len=160,
                            spec_config=SpecConfig(lookahead=4))
        eng.add_request(_prompts(1)[0], max_new_tokens=4)
        with pytest.raises(AssertionError, match="spec module touched"):
            eng.run()

    def test_package_import_leaves_spec_unloaded(self):
        probe = ("import sys, paddle_tpu_torch.serving as s; "
                 "print('paddle_tpu_torch.serving.spec' in sys.modules); "
                 "s.SpecConfig; "
                 "print('paddle_tpu_torch.serving.spec' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", probe],
                             capture_output=True, text=True, timeout=300,
                             cwd=Path(__file__).resolve().parent.parent)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False", "True"]


class TestPageAccounting:
    def test_charge_revert_audited_every_step(self):
        eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                            max_batch_size=3, max_seq_len=64, num_pages=14,
                            decode_horizon=4,
                            spec_config=SpecConfig(lookahead=4))
        for p in _prompts(3):
            eng.add_request(p, max_new_tokens=12)
        steps = 0
        while any(r.status in ("waiting", "running")
                  for r in eng.requests.values()):
            eng.step()
            assert eng.scheduler.check_consistency()
            for r in eng.scheduler.running:
                # never more than the worst-case charge of one block past
                # the host state and the undrained bound
                assert len(r.pages) <= (
                    eng.scheduler._block_pages(r) if r.prefill_done
                    else len(r.pages))
            steps += 1
            assert steps < 400, "engine stopped making progress"
        eng.drain_all()
        assert eng.cache.allocator.num_used == 0
        assert eng.scheduler.check_consistency()

    def test_mid_block_rejection_reverts_tail_pages(self):
        eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                            max_batch_size=1, max_seq_len=160,
                            decode_horizon=8,
                            spec_config=SpecConfig(lookahead=8))
        rid = eng.add_request(_prompts(1)[0], max_new_tokens=13)
        outs = eng.run()
        assert len(outs[rid]) == len(_prompts(1)[0]) + 13
        assert eng.cache.allocator.num_used == 0
        assert eng.scheduler.check_consistency()

    def test_revert_keeps_host_state_and_cursor_pages(self):
        eng = ServingEngine(_port_llama(), device="cpu", page_size=8,
                            max_batch_size=1, max_seq_len=160,
                            decode_horizon=4,
                            spec_config=SpecConfig(lookahead=4))
        sched = eng.scheduler
        assert sched.block_tokens == 20
        rid = eng.add_request(list(range(1, 11)), max_new_tokens=40)
        eng.step()                                   # prefill
        req = eng.requests[rid]
        assert len(req.pages) == 4                   # 10 + 20 - 1 tokens
        sched._ensure_decode_pages()
        assert sched.revert_spec_pages(req) == 2     # keep pages_for(11)
        assert len(req.pages) == 2 and sched.check_consistency()
