"""paddle_tpu_torch tensor-parallel serving (serving/tp.py, the sharded
pools of serving/kv_cache.py, parallel/mesh.py) against the JAX package's
tensor-parallel engine, and port against port, mirrored from
tests/test_serving_tp.py.

Against the JAX engine, on the same weights (`load_reference_state`), the
JAX side on 8 fake CPU devices: the port's tp=2 greedy streams equal the
JAX engine's tp=2 streams for LLaMA, for GPT (the fused-QKV interleave)
and with the quantized all-reduce. The JAX engine reaches `shard_map`
through `paddle_tpu.serving.tp._shard_map` with `check_rep=`; the
`jax_tp` fixture maps that keyword onto `check_vma=` where the installed
jax spells it so, and passes it through where it does not.

Port against port: tp 2 / 4 streams equal tp=1, greedy and seeded, at
decode horizons 1 and 4, chunked (ragged and chained), with the prefix
cache and over int8 pools; the TP model's logits equal tp=1's within
fp32 rounding; the shards' slices rebuild the full weights; validation;
device ordering and carving on shuffled `torch.device("cuda", i)` lists
(built without a card); a tp=2 snapshot restored at tp=4 exactly once; a
dead tp=2 cluster replica migrated to a tp=1 survivor, and a cluster of
two tp=2 replicas with one killed; tp=1 engines and clusters never import
serving.tp (poisoned module); the collective histogram, the per-shard
gauges and the `tp=N` tag read back through tools/trace_summary.py.

No counterpart: the reference's compile-count and jit-key tests
(test_serving_tp.py:240-271) pin `jax.jit` caches; the port runs eagerly
and keeps none.

All on the CPU: a CPU model's tensor-parallel group is tp CPU shards, and
every kernel wrapper runs its plain version.
"""
import functools
import importlib.util
import inspect
import os
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving.tp as jtp
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine

import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.parallel import (carve_submeshes, chunk_bounds,
                                       device_order, ordered_allreduce)
from paddle_tpu_torch.serving import (FaultInjector, RequestJournal,
                                      ServingCluster, ServingEngine)
from paddle_tpu_torch.weights import load_reference_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_tp(monkeypatch):
    """The JAX engine's shard_map with `check_rep=` spelled the way the
    installed jax takes it."""
    orig = jtp._shard_map
    params = inspect.signature(orig).parameters

    def shard_map(*args, check_rep=None, **kw):
        if check_rep is not None:
            kw["check_rep" if "check_rep" in params
               else "check_vma"] = check_rep
        return orig(*args, **kw)

    monkeypatch.setattr(jtp, "_shard_map", shard_map)


_LLAMA4 = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=4,
               intermediate_size=128, max_position_embeddings=64)


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    paddle.seed(1234)
    if family == "gpt":
        m = JGPT(JGPTConfig.tiny())
    else:
        m = JLlama(JLlamaConfig(**_LLAMA4) if family == "llama4"
                   else JLlamaConfig.tiny())     # tiny: 4 heads, 2 kv
    m.eval()
    return m


@functools.lru_cache(maxsize=None)
def _port(family):
    params, _ = extract_state(_jax_model(family))
    if family == "gpt":
        m = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    else:
        m = LlamaForCausalLM(LlamaConfig(**_LLAMA4) if family == "llama4"
                             else LlamaConfig.tiny(), device="cpu")
    load_reference_state(m, {k: np.asarray(v) for k, v in params.items()})
    return m


_ENGINE_KW = dict(page_size=4, num_pages=64, max_batch_size=4,
                  max_seq_len=48, decode_horizon=4)

_PROMPTS = [[7, 3, 9, 1, 4], [2, 8, 6, 5, 1, 9, 3, 7, 2],
            [4, 4, 1, 8, 8, 2, 6, 3, 9, 5, 1, 7, 3]]

# a two-page shared system prompt (page_size 4) for the prefix-cache cell
_SHARED = [6, 1, 6, 1, 8, 0, 3, 3]
_SHARED_PROMPTS = [_SHARED + [7, 3, 9], _SHARED + [2, 8, 6, 5, 1],
                   _SHARED + [4, 4, 1, 8, 8, 2, 6]]


def _sampling_kw(i, seeded):
    return (dict(temperature=0.8, top_k=5, seed=100 + i) if seeded
            else dict(seed=7))


def _drive(eng, prompts, seeded, max_new):
    """Staggered arrivals: two up front, the rest one a step after two
    steps. Returns the streams in arrival order."""
    rids = [eng.add_request(p, max_new_tokens=max_new,
                            **_sampling_kw(i, seeded))
            for i, p in enumerate(prompts[:2])]
    for _ in range(2):
        eng.step()
    for j, p in enumerate(prompts[2:], start=2):
        rids.append(eng.add_request(p, max_new_tokens=max_new,
                                    **_sampling_kw(j, seeded)))
        eng.step()
    outs = eng.run()
    return [outs[r] for r in rids]


def _staggered(model, prompts=_PROMPTS, seeded=False, max_new=6, **kw):
    eng = ServingEngine(model, device="cpu", **{**_ENGINE_KW, **kw})
    out = _drive(eng, prompts, seeded, max_new)
    assert eng.scheduler.check_consistency()
    return eng, out


@functools.lru_cache(maxsize=None)
def _tp1(family, seeded=False, horizon=4, chunked=False):
    kw = dict(decode_horizon=horizon)
    if chunked:
        kw.update(enable_chunked_prefill=True, prefill_chunk_tokens=8)
    return _staggered(_port(family), seeded=seeded, **kw)[1]


# ------------------------------------------------- against the JAX engine

class TestAgainstJaxEngine:
    @pytest.mark.parametrize("family,qar", [("llama", False), ("gpt", False),
                                            ("llama", True)])
    def test_tp2_greedy_streams_equal_the_jax_tp2_engine(self, family, qar,
                                                         jax_tp):
        jeng = JServingEngine(_jax_model(family), tp_size=2,
                              tp_quantized_allreduce=qar, **_ENGINE_KW)
        want = _drive(jeng, _PROMPTS, False, 6)
        eng, got = _staggered(_port(family), tp_size=2,
                              tp_quantized_allreduce=qar)
        assert got == want
        assert eng.stats()["tp"]["quantized_allreduce"] is qar

    def test_interleave_matches_the_reference(self):
        """The port's (out, in) weight interleaved along dim 0 is the
        transpose of the reference's (in, out) weight interleaved along
        its last dim."""
        from paddle_tpu.serving.tp import TPContext as JTPContext

        from paddle_tpu_torch.serving.tp import interleave_qkv

        cfg = JGPTConfig.tiny()
        jctx = JTPContext.__new__(JTPContext)
        jctx.cfg, jctx.tp_size = cfg, 2
        h = cfg.hidden_size
        w = np.random.RandomState(0).randn(h, 3 * h).astype(np.float32)
        b = np.random.RandomState(1).randn(3 * h).astype(np.float32)
        want_w = np.asarray(jctx._interleave_qkv(w))
        want_b = np.asarray(jctx._interleave_qkv(b))
        got_w = interleave_qkv(torch.from_numpy(w.T.copy()),
                               cfg.num_attention_heads, 2)
        got_b = interleave_qkv(torch.from_numpy(b), cfg.num_attention_heads,
                               2)
        np.testing.assert_array_equal(got_w.numpy().T, want_w)
        np.testing.assert_array_equal(got_b.numpy(), want_b)


# ------------------------------------------------------------ token parity

class TestTokenParity:
    @pytest.mark.parametrize("horizon", [1, 4])
    @pytest.mark.parametrize("seeded", [False, True])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_llama_matches_tp1(self, tp, seeded, horizon):
        _, got = _staggered(_port("llama4"), seeded=seeded, tp_size=tp,
                            decode_horizon=horizon)
        assert got == _tp1("llama4", seeded, horizon)

    @pytest.mark.parametrize("seeded", [False, True])
    def test_gpt_matches_tp1(self, seeded):
        """The fused qkv = Linear(h, 3h): a contiguous shard of the raw
        (3, heads, hd) layout would give garbage, not an error."""
        _, got = _staggered(_port("gpt"), seeded=seeded, tp_size=2)
        assert got == _tp1("gpt", seeded)

    @pytest.mark.parametrize("ragged", [True, False])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_chunked_matches_tp1(self, tp, ragged):
        eng, got = _staggered(_port("llama4"), seeded=True, tp_size=tp,
                              enable_chunked_prefill=True,
                              prefill_chunk_tokens=8,
                              enable_ragged_step=ragged)
        assert got == _tp1("llama4", True, chunked=True)
        assert eng.stats()["ragged_steps" if ragged
                           else "prefill_chunks"] > 0

    def test_prefix_cache_matches_tp1(self):
        """Page ids are single, so the radix tree and the offset prefill
        behave as on the single-device engine."""
        _, want = _staggered(_port("llama"), prompts=_SHARED_PROMPTS,
                             enable_prefix_caching=True)
        eng, got = _staggered(_port("llama"), prompts=_SHARED_PROMPTS,
                              enable_prefix_caching=True, tp_size=2)
        assert got == want
        assert eng.prefix_cache.stats()["hit_tokens"] >= len(_SHARED)

    def test_int8_pools_match_tp1(self):
        _, want = _staggered(_port("llama4"), kv_dtype="int8")
        eng, got = _staggered(_port("llama4"), kv_dtype="int8", tp_size=4)
        assert got == want
        assert all(len(p) == 4 for shard in eng.cache.shards
                   for p in shard)

    def test_shuffled_devices_same_group_same_tokens(self):
        _, want = _staggered(_port("llama"), tp_size=2)
        eng, got = _staggered(_port("llama"), tp_size=2,
                              devices=["cpu", torch.device("cpu"), "cpu"])
        assert got == want
        assert eng._tp.devices == (CPU, CPU)


# ----------------------------------------------------------- the TP model

def _tp_logits(model, tp, ids, **kw):
    """One prefill of `ids` through a fresh engine's TP runner, then one
    decode step: (prefill logits, decode logits)."""
    eng = ServingEngine(model, device="cpu", tp_size=tp, **_ENGINE_KW, **kw)
    return _logits(eng, ids)


def _logits(eng, ids):
    b, s = ids.shape
    pages = [eng.cache.allocator.alloc_n(4) for _ in range(b)]
    table = eng.cache.page_table_array(pages, eng.max_pages_per_seq)
    with torch.no_grad():
        pre, _ = eng._fwd(ids, caches=eng.cache.layer_views(table),
                          start_pos=0)
        dec, _ = eng._fwd(ids[:, -1:], caches=eng.cache.layer_views(table),
                          start_pos=torch.full((b,), s, dtype=torch.int32))
    return pre, dec


class TestTPModel:
    @pytest.mark.parametrize("family,tp", [("llama4", 2), ("llama4", 4),
                                           ("gpt", 2), ("gpt", 4)])
    def test_logits_match_tp1_within_fp32_rounding(self, family, tp):
        """Row-parallel partial sums round otherwise than the full product:
        held at 1e-5 absolute + 1e-5 relative in fp32 (logits ~1)."""
        ids = torch.from_numpy(np.random.RandomState(3).randint(
            0, 512, (2, 9)))
        want = _tp_logits(_port(family), 1, ids)
        got = _tp_logits(_port(family), tp, ids)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("family", ["llama4", "gpt"])
    def test_shard_slices_rebuild_the_weights(self, family):
        model = _port(family)
        eng = ServingEngine(model, device="cpu", tp_size=4, **_ENGINE_KW)
        shards = eng._tp.runner.shards
        if family == "gpt":
            from paddle_tpu_torch.serving.tp import interleave_qkv

            full = model.gpt.blocks[1]
            qkv = torch.cat([s[1].attn.qkv.weight for s in shards])
            torch.testing.assert_close(qkv, interleave_qkv(
                full.attn.qkv.weight, 4, 4), rtol=0, atol=0)
            out = torch.cat([s[1].attn.out.weight for s in shards], dim=1)
            assert torch.equal(out, full.attn.out.weight)
            assert all(s[1].attn.out.bias is None and s[1].ffn_out.bias is
                       None for s in shards)
            assert all(s[1].attn.num_heads == 1 for s in shards)
        else:
            full = model.llama.layers[1]
            q = torch.cat([s[1].self_attn.q_proj.weight for s in shards])
            assert torch.equal(q, full.self_attn.q_proj.weight)
            down = torch.cat([s[1].mlp.down_proj.weight for s in shards],
                             dim=1)
            assert torch.equal(down, full.mlp.down_proj.weight)
            att = shards[0][1].self_attn
            assert (att.num_heads, att.num_kv_heads) == (1, 1)
        # the skeleton's own weights were never drawn: every parameter is
        # a shard slice, none on the meta device
        assert not any(p.is_meta for p in shards.parameters())

    def test_pools_split_by_kv_head(self):
        eng = ServingEngine(_port("llama4"), device="cpu", tp_size=2,
                            **_ENGINE_KW)
        c = eng.cache
        assert c.pools == [] and len(c.shards) == 2
        kp = c.shards[1][0][0]
        assert kp.shape == (2, 64, 4, 16)
        assert c.shard_pool_bytes * 2 == c.pool_bytes
        assert eng.stats()["tp"]["shard_pool_bytes"] == c.shard_pool_bytes
        eng.release_pools()
        assert c.shards == [] and c.pools == []


# -------------------------------------------------------------- validation

class TestValidation:
    def test_gqa_requires_kv_heads_divisible(self):
        with pytest.raises(ValueError, match="num_key_value_heads"):
            ServingEngine(_port("llama"), device="cpu", tp_size=4,
                          **_ENGINE_KW)

    def test_heads_divisibility(self):
        with pytest.raises(ValueError, match="num_attention_heads"):
            ServingEngine(_port("llama4"), device="cpu", tp_size=3,
                          **_ENGINE_KW)

    def test_needs_enough_devices(self):
        with pytest.raises(ValueError, match="devices"):
            ServingEngine(_port("llama"), device="cpu", tp_size=2,
                          devices=["cpu"], **_ENGINE_KW)

    def test_tp_size_must_be_positive(self):
        with pytest.raises(ValueError, match="tp_size"):
            ServingEngine(_port("llama"), device="cpu", tp_size=0,
                          **_ENGINE_KW)

    @pytest.mark.parametrize("knob", ["tp_quantized_allreduce",
                                      "tp_overlap"])
    def test_tp_knobs_need_tp(self, knob):
        with pytest.raises(ValueError, match="tp_size >= 2"):
            ServingEngine(_port("llama"), device="cpu", **{knob: True},
                          **_ENGINE_KW)

    def test_zero_chunks_rejected(self):
        with pytest.raises(ValueError, match="chunks"):
            ServingEngine(_port("llama"), device="cpu", tp_size=2,
                          tp_overlap=True, tp_overlap_chunks=0,
                          **_ENGINE_KW)

    def test_cuda_devices_for_a_cpu_model(self):
        """A CUDA name raises on a machine without a card, and a group must
        be of the model's device type."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(_port("llama"), device="cpu", tp_size=2,
                          devices=["cuda:0", "cuda:1"], **_ENGINE_KW)

    def test_unsupported_family(self):
        from paddle_tpu_torch.serving.tp import TPContext

        other = torch.nn.Linear(2, 2)
        other.config = LlamaConfig.tiny()
        with pytest.raises(ValueError, match="LLaMA / GPT"):
            TPContext(other, 2)


# ----------------------------------------------------------- device order

def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


class TestDeviceOrdering:
    def test_device_order_sorts_shuffled_cards(self):
        assert device_order(_cuda(2, 0, 3, 1)) == _cuda(0, 1, 2, 3)
        assert device_order(["cuda:3", "cuda:0"]) == _cuda(0, 3)
        # repeats stay, cpu before cuda
        assert device_order(_cuda(1, 0, 0) + [CPU]) == [CPU] + _cuda(0, 0, 1)

    def test_carve_sorted_disjoint_groups(self):
        carved = carve_submeshes(2, 2, _cuda(3, 1, 2, 0))
        assert carved == [tuple(_cuda(0, 1)), tuple(_cuda(2, 3))]
        # one card repeated holds every group
        assert carve_submeshes(2, 2, _cuda(0) * 4) == [tuple(_cuda(0, 0))] * 2
        with pytest.raises(ValueError, match="devices"):
            carve_submeshes(8, 2, _cuda(0, 1, 2, 3))

    def test_chunk_bounds(self):
        assert chunk_bounds(2, 5) == [(0, 2), (2, 5)]
        assert chunk_bounds(3, 2) == [(0, 1), (1, 2)]
        assert chunk_bounds(4, 1) == [(0, 1)]

    def test_ordered_allreduce_sums_in_shard_order(self):
        rng = np.random.RandomState(0)
        parts = [torch.from_numpy(rng.randn(3, 17).astype(np.float32))
                 for _ in range(4)]
        out = ordered_allreduce(parts, [CPU] * 4)
        assert list(out) == [CPU]
        want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
        assert torch.equal(out[CPU], want)


# ------------------------------------------- snapshot across tp degrees

class TestSnapshotCrossDegree:
    def test_tp2_snapshot_restores_on_tp4_exactly_once(self):
        want = _tp1("llama4")
        eng = ServingEngine(_port("llama4"), device="cpu",
                            journal=RequestJournal(), tp_size=2,
                            **_ENGINE_KW)
        rids = [eng.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        delivered = {r: [] for r in rids}
        for _ in range(3):               # part-way: some tokens delivered
            for rid, tok in eng.step():
                delivered[rid].append(tok)
        snap = eng.snapshot()
        assert snap.config["tp_size"] == 2
        eng.release_pools()
        eng2 = ServingEngine(_port("llama4"), device="cpu",
                             journal=eng._journal, tp_size=4, **_ENGINE_KW)
        eng2.restore(snap)
        for rid, tok, _ in eng2.stream():
            delivered[rid].append(tok)
        # every token reaches the caller exactly once
        for rid, prompt, full in zip(rids, _PROMPTS, want):
            assert delivered[rid] == full[len(prompt):]
        out = eng2.run()
        assert [out[r] for r in rids] == want
        eng2.scheduler.check_consistency()
        eng._journal.check_consistency()


# --------------------------------------------------- zero touch at tp=1

def _tp_factory(**overrides):
    kw = dict(_ENGINE_KW, retry_backoff_s=0.0, **overrides)

    def make(replica=None, fault_injector=None, tp_size=1, devices=None):
        return ServingEngine(_port("llama"), device="cpu",
                             fault_injector=fault_injector, tp_size=tp_size,
                             devices=devices, **kw)
    return make


class TestZeroTouchAtTp1:
    def test_tp1_never_imports_tp_module(self, monkeypatch):
        """Poison serving.tp: a tp_size=1 engine and cluster run a full
        request without it, and a tp_size=2 engine trips the poison."""
        poison = types.ModuleType("paddle_tpu_torch.serving.tp")

        def _boom(name):
            raise AssertionError(f"tp module touched at tp_size=1: {name}")

        poison.__getattr__ = _boom
        monkeypatch.setitem(sys.modules, "paddle_tpu_torch.serving.tp",
                            poison)
        monkeypatch.setattr(tserving, "tp", poison, raising=False)
        _, out = _staggered(_port("llama"), prompts=_PROMPTS[:1])
        assert len(out[0]) > len(_PROMPTS[0])
        cl = ServingCluster(_tp_factory(), num_replicas=2)
        assert cl.tp_size == 1
        rid = cl.add_request(_PROMPTS[1], max_new_tokens=3, seed=7)
        assert len(cl.run()[rid]) == len(_PROMPTS[1]) + 3
        with pytest.raises(AssertionError, match="tp module touched"):
            ServingEngine(_port("llama"), device="cpu", tp_size=2,
                          **_ENGINE_KW)


# ----------------------------------------------------------- observability

def _load_trace_summary():
    spec = importlib.util.spec_from_file_location(
        "_trace_summary_tp", os.path.join(REPO, "tools", "trace_summary.py"))
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    return ts


class TestObservability:
    def test_collective_histogram_and_per_shard_gauges(self):
        eng, _ = _staggered(_port("llama"), tp_size=2)
        reg = eng.metrics
        h = reg.get("serving_tp_collective_seconds",
                    labels={"overlap": "off"})
        assert h is not None and h.count >= 3 and h.sum > 0.0
        g0 = reg.get("serving_kv_pages_free", labels={"shard": "0"})
        g1 = reg.get("serving_kv_pages_free", labels={"shard": "1"})
        # page accounting is single: both shards read the same number
        assert g0 is not None and g1 is not None
        assert g0.value == g1.value > 0
        st = eng.stats()
        assert st["tp_size"] == 2
        assert st["tp"]["devices"] == ["cpu", "cpu"]
        assert st["tp"]["kv_heads_per_shard"] == 1
        assert st["tp"]["heads_per_shard"] == 2
        assert "tp" not in _staggered(_port("llama"))[0].stats()

    def test_tagged_spans_read_back_through_trace_summary(self, monkeypatch):
        """The lifecycle spans a tp=2 engine emits carry `@tp=2`; the
        retained stages stay plain; tools/trace_summary.py strips the tag
        back out and reports it."""
        from paddle_tpu_torch import profiler

        spans = []
        monkeypatch.setattr(
            profiler, "add_host_span",
            lambda name, t0, t1, event_type=None: spans.append(
                (name, t0, t1)))
        eng, _ = _staggered(_port("llama"), prompts=_PROMPTS[:1], tp_size=2)
        lc = eng._obs.lifecycle
        assert lc.tag == "tp=2"
        rid = lc.request_ids()[-1]
        assert "finished" in lc.stages(rid)
        assert not any("@" in s for s in lc.stages(rid))
        assert spans and all(n.endswith("@tp=2") for n, _, _ in spans)
        ts = _load_trace_summary()
        evs = [dict(ph="X", pid=1, tid=1, ts=t0 * 1e6,
                    dur=max(t1 - t0, 0.0) * 1e6, name=n)
               for n, t0, t1 in spans]
        tl = ts.request_timelines(evs)
        assert list(tl) == [rid]
        stages = [s for s, _, _ in tl[rid]]
        assert stages[0] == "enqueued" and stages[-1] == "finished"
        assert "first_token" in stages
        tags = ts.request_tags(evs)
        assert tags == {rid: "tp=2"}
        out = ts.format_requests(tl, tags=tags)
        assert out.splitlines()[0] == "tensor-parallel: tp=2"
        assert f"request {rid} @tp=2:" in out


# ------------------------------------------------------------------ cluster

class TestCluster:
    def test_cluster_carves_groups_and_serves(self):
        cl = ServingCluster(_tp_factory(), num_replicas=2, tp_size=2,
                            devices=["cpu"] * 4)
        engines = [r.supervisor.engine for r in cl.replicas]
        assert [e.tp_size for e in engines] == [2, 2]
        assert all(e._tp.devices == (CPU, CPU) for e in engines)
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        out = cl.run()
        assert [out[r] for r in rids] == _tp1("llama")
        with pytest.raises(ValueError, match="devices"):
            ServingCluster(_tp_factory(), num_replicas=8, tp_size=2,
                           devices=["cpu"] * 4)

    def test_cluster_tp_requires_capable_factory(self):
        with pytest.raises(ValueError, match="tp_size"):
            ServingCluster(lambda: ServingEngine(_port("llama"),
                                                 device="cpu", **_ENGINE_KW),
                           num_replicas=2, tp_size=2, devices=["cpu"] * 4)

    @pytest.mark.parametrize("kv", ["fp32", "int8"])
    def test_dead_tp2_replica_migrates_to_tp1_survivor(self, kv):
        """Replica 0 at tp=2, replica 1 at tp=1: killing replica 0 moves
        its requests onto the survivor through the journal's
        device-independent token record, every stream identical to an
        uninterrupted tp=1 run."""
        _, want = _staggered(_port("llama"), kv_dtype=kv)

        def make(replica=None, fault_injector=None):
            return ServingEngine(
                _port("llama"), device="cpu", fault_injector=fault_injector,
                tp_size=2 if replica == 0 else 1, kv_dtype=kv,
                retry_backoff_s=0.0, **_ENGINE_KW)

        inj = [FaultInjector().fail_at("device_lost", 2), FaultInjector()]
        cl = ServingCluster(make, num_replicas=2, fault_injectors=inj,
                            placement="round_robin",
                            supervisor_kw=dict(max_restarts=0))
        assert cl.replicas[0].supervisor.engine.tp_size == 2
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        out = cl.run()
        assert cl.health().count("dead") == 1
        assert [out[r] for r in rids] == want
        assert cl.check_consistency()

    def test_killed_tp2_replica_of_two_migrates_exactly_once(self):
        inj = [FaultInjector(), FaultInjector().fail_at("device_lost", 3)]
        cl = ServingCluster(_tp_factory(), num_replicas=2, tp_size=2,
                            devices=["cpu"] * 4, fault_injectors=inj,
                            placement="round_robin",
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        seen = {r: [] for r in rids}
        for rid, tok, _ in cl.stream():
            seen[rid].append(tok)
        assert cl.health().count("dead") == 1
        for rid, prompt, full in zip(rids, _PROMPTS, _tp1("llama")):
            assert seen[rid] == full[len(prompt):]
        assert cl.check_consistency()
