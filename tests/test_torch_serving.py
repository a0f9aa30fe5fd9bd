"""paddle_tpu_torch.serving: the port's ServingEngine against the JAX
ServingEngine on the same weights, plus the port's own invariants.

- the staggered-arrival script of tests/test_serving.py: the port's
  greedy streams are token-identical to the JAX engine's, and the port's
  logits over each final sequence agree with JAX's within atol 1e-4;
- decode_horizon 1 == 8; sampled streams reproducible from their seed and
  independent of the horizon and of the batch they ride in; streams
  unchanged under page pressure (preemption);
- allocator and scheduler unit cases mirrored from tests/test_serving.py;
- the engine knobs that are not ported raise NotImplementedError naming
  their ROADMAP item; `cache_dtype` is the reference's legacy spelling of
  fp32 / bf16 pools, with its conflict rule.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (
    NULL_PAGE, BlockAllocator, EngineOverloaded, PagedKVCache, Request,
    SamplingParams, Scheduler, ServingEngine, pages_for,
)
from paddle_tpu_torch.weights import load_reference_state

VOCAB = 512


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


def _engine(model, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_seq_len", 32)
    kw.setdefault("prefill_buckets", (16, 32))
    return ServingEngine(model, device="cpu", **kw)


def _staggered(eng, prompts, **req_kw):
    """The arrival script of test_serving.py's staggered-arrival test: two
    requests up front, three steps, a third, one step, a fourth."""
    rids = [eng.add_request(p, **req_kw) for p in prompts[:2]]
    for _ in range(3):
        eng.step()
    rids.append(eng.add_request(prompts[2], **req_kw))
    eng.step()
    rids.append(eng.add_request(prompts[3], **req_kw))
    outs = eng.run()
    return [outs[r] for r in rids]


def _prompts(seed=0, lens=(5, 11, 3, 8)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)) for n in lens]


class TestAgainstJaxEngine:
    def test_staggered_arrivals_token_identical_to_jax_engine(self):
        prompts = _prompts()
        jeng = JServingEngine(_jax_llama(), page_size=8, max_batch_size=4,
                              max_seq_len=32, prefill_buckets=(16, 32))
        ref = _staggered(jeng, prompts, max_new_tokens=6, temperature=0.0)
        eng = _engine(_port_llama())
        got = _staggered(eng, prompts, max_new_tokens=6, temperature=0.0)
        assert got == ref
        stats = eng.stats()
        assert stats["num_finished"] == 4
        assert stats["tokens_generated"] == 24
        for per in stats["requests"].values():
            assert per["ttft_s"] is not None and per["ttft_s"] >= 0
            assert per["latency_s"] is not None and per["tokens"] == 6
        assert stats["latency"]["ttft"]["count"] == 4
        # the logits behind those tokens agree too
        for seq in got:
            ids = np.asarray(seq)[None]
            jl = _jax_llama()(paddle.to_tensor(ids)).numpy()
            with torch.no_grad():
                tl = _port_llama()(torch.from_numpy(ids)).numpy()
            np.testing.assert_allclose(tl, jl, atol=1e-4)


class TestPortInvariants:
    def test_horizon_1_equals_horizon_8(self):
        prompts = _prompts(1)
        outs = {h: _staggered(_engine(_port_llama(), decode_horizon=h),
                              prompts, max_new_tokens=9)
                for h in (1, 8)}
        assert outs[1] == outs[8]

    def test_sampled_stream_reproducible_and_horizon_independent(self):
        prompts = _prompts(2)
        kw = dict(max_new_tokens=10, temperature=0.8, top_k=40, top_p=0.9)
        runs = []
        for h in (1, 8, 8):
            eng = _engine(_port_llama(), decode_horizon=h)
            rids = [eng.add_request(p, seed=100 + i, **kw)
                    for i, p in enumerate(prompts)]
            outs = eng.run()
            runs.append([outs[r] for r in rids])
        assert runs[0] == runs[1] == runs[2]
        # alone in the engine, a request draws the same stream as in a batch
        eng = _engine(_port_llama(), decode_horizon=4)
        rid = eng.add_request(prompts[2], seed=102, **kw)
        assert eng.run()[rid] == runs[0][2]
        # and the seed matters
        eng = _engine(_port_llama(), decode_horizon=4)
        rid = eng.add_request(prompts[2], seed=999, **kw)
        assert eng.run()[rid] != runs[0][2]

    def test_streams_unchanged_under_page_pressure(self):
        prompts = _prompts(3, lens=(9, 7, 12, 5))
        roomy = _engine(_port_llama(), decode_horizon=4)
        ref = _staggered(roomy, prompts, max_new_tokens=12)
        tight = _engine(_port_llama(), decode_horizon=4, num_pages=8)
        got = _staggered(tight, prompts, max_new_tokens=12)
        assert got == ref
        assert tight.stats()["preemptions"] > 0
        assert tight.cache.allocator.num_used == 0
        tight.scheduler.check_consistency()

    def test_greedy_matches_the_no_cache_argmax(self):
        model = _port_llama()
        for seq in _staggered(_engine(model), _prompts(4),
                              max_new_tokens=7):
            with torch.no_grad():
                logits = model(torch.tensor([seq]))[0]
            n = len(seq) - 7
            assert logits[n - 1:-1].argmax(-1).tolist() == seq[n:]

    def test_eos_stops_a_request(self):
        model = _port_llama()
        prompt = _prompts(5)[0]
        eng = _engine(model)
        rid = eng.add_request(prompt, max_new_tokens=8)
        first = eng.run()[rid][len(prompt)]
        eng = _engine(model)
        rid = eng.add_request(prompt, max_new_tokens=8, eos_token_id=first)
        assert eng.run()[rid] == list(prompt) + [first]

    def test_cancel_running_request_releases_pages(self):
        eng = _engine(_port_llama())
        a = eng.add_request(_prompts(6)[0], max_new_tokens=20)
        b = eng.add_request(_prompts(6)[1], max_new_tokens=5)
        for _ in range(4):
            eng.step()
        assert eng.cancel(a)
        assert eng.status(a) == ("cancelled", None)
        assert not eng.cancel(a)
        eng.run()
        assert eng.status(b)[0] == "finished"
        assert eng.cache.allocator.num_used == 0

    def test_stats_without_metrics_keep_their_shape(self):
        eng = _engine(_port_llama(), enable_metrics=False)
        rid = eng.add_request(_prompts(7)[0], max_new_tokens=3)
        eng.run()
        s = eng.stats()
        assert s["tokens_generated"] == 0 and s["num_finished"] == 1
        assert s["requests"][rid]["tokens"] == 3


class TestEngineSurface:
    @pytest.mark.parametrize("knob,value,item", [
        ("tp_size", 2, "S5"), ("devices", ["cuda:0", "cuda:1"], "S5"),
        ("tp_quantized_allreduce", True, "S5"), ("tp_overlap", True, "S5"),
        ("tp_overlap_chunks", 2, "S5"), ("slo_classes", [object()], "S9"),
        ("slo_refresh_every", 64, "S9"), ("flight_recorder", object(), "S9"),
        ("postmortem_dir", "/tmp/x", "S9"),
    ])
    def test_unported_knobs_raise_naming_the_roadmap(self, knob, value,
                                                     item):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
            _engine(_port_llama(), **{knob: value})

    def test_deadline_raises(self):
        # deadlines are ported: only a non-positive one is refused
        eng = _engine(_port_llama())
        for bad in (0.0, -1.0):
            with pytest.raises(ValueError, match="deadline_s"):
                eng.add_request([1, 2], deadline_s=bad)
        assert not eng.requests

    def test_slo_class_raises_naming_the_roadmap(self):
        eng = _engine(_port_llama())
        with pytest.raises(NotImplementedError, match="ROADMAP.*S9"):
            eng.add_request([1, 2], slo_class="interactive")
        assert not eng.requests

    @pytest.mark.parametrize("knob", ["fused_lm_loss", "labels"])
    def test_llama_loss_surface_raises_naming_the_roadmap(self, knob):
        with pytest.raises(NotImplementedError, match="ROADMAP.*S11"):
            if knob == "fused_lm_loss":
                LlamaConfig(fused_lm_loss=True)
            else:
                _port_llama()(torch.zeros((1, 4), dtype=torch.int64),
                              labels=torch.zeros((1, 4), dtype=torch.int64))

    @pytest.mark.parametrize("cache_dtype,kv_dtype,pool", [
        (torch.bfloat16, "fp32", torch.bfloat16),
        ("bfloat16", "fp32", torch.bfloat16),
        (torch.float32, "fp32", torch.float32),
        ("float32", "bf16", torch.bfloat16),
        ("bfloat16", "bf16", torch.bfloat16),
        (torch.float32, "int8", torch.int8),
    ])
    def test_cache_dtype_is_the_legacy_pool_spelling(self, cache_dtype,
                                                     kv_dtype, pool):
        eng = _engine(_port_llama(), cache_dtype=cache_dtype,
                      kv_dtype=kv_dtype)
        assert eng.cache.pools[0][0].dtype == pool

    def test_cache_dtype_streams_equal_kv_dtype_streams(self):
        prompts = _prompts(9)
        outs = [_staggered(_engine(_port_llama(), **kw), prompts,
                           max_new_tokens=6)
                for kw in (dict(cache_dtype="bfloat16"),
                           dict(kv_dtype="bf16"))]
        assert outs[0] == outs[1]

    @pytest.mark.parametrize("cache_dtype,kv_dtype", [
        ("bfloat16", "int8"), (torch.bfloat16, "fp8"),
        (torch.float16, "fp32"), ("int8", "fp32"),
    ])
    def test_cache_dtype_conflicts_raise(self, cache_dtype, kv_dtype):
        with pytest.raises(ValueError, match="cache_dtype"):
            _engine(_port_llama(), cache_dtype=cache_dtype,
                    kv_dtype=kv_dtype)

    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(_port_llama())

    def test_kv_cache_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            PagedKVCache(2, 4, 8, 2, 16)

    def test_kv_cache_on_the_cpu_when_asked(self):
        cache = PagedKVCache(2, 4, 8, 2, 16, kv_dtype="bf16", device="cpu")
        assert cache.device == torch.device("cpu")
        assert all(t.device.type == "cpu" for layer in cache.pools
                   for t in layer)

    def test_request_validation_and_backpressure(self):
        eng = _engine(_port_llama(), max_waiting=1)
        with pytest.raises(ValueError, match="empty"):
            eng.add_request([])
        with pytest.raises(ValueError, match="max_seq_len"):
            eng.add_request([1] * 30, max_new_tokens=10)
        eng.add_request([1, 2], max_new_tokens=2)
        with pytest.raises(EngineOverloaded):
            eng.add_request([3, 4], max_new_tokens=2)
        assert len(eng.requests) == 1

    def test_bf16_pools(self):
        eng = _engine(_port_llama(), kv_dtype="bf16")
        assert eng.cache.pools[0][0].dtype == torch.bfloat16
        rid = eng.add_request(_prompts(8)[0], max_new_tokens=4)
        assert len(eng.run()[rid]) == 5 + 4


# ------------------------------------- mirrored from tests/test_serving.py

class TestBlockAllocator:
    def test_alloc_free_roundtrip(self):
        a = BlockAllocator(8)
        assert a.num_free == 7           # page 0 reserved
        pages = [a.alloc() for _ in range(7)]
        assert sorted(pages) == list(range(1, 8))
        assert a.alloc() is None         # exhausted
        for p in pages:
            a.free(p)
        assert a.num_free == 7 and a.num_used == 0
        assert a.check_consistency()

    def test_double_free_raises(self):
        a = BlockAllocator(4)
        p = a.alloc()
        a.free(p)
        with pytest.raises(ValueError, match="double free"):
            a.free(p)

    def test_null_page_is_never_handed_out_and_unfreeable(self):
        a = BlockAllocator(4)
        assert NULL_PAGE not in [a.alloc() for _ in range(3)]
        with pytest.raises(ValueError, match="null page"):
            a.free(NULL_PAGE)

    def test_alloc_n_all_or_nothing(self):
        a = BlockAllocator(4)
        assert a.alloc_n(4) is None      # only 3 allocatable
        assert a.num_free == 3           # failed batch leaks nothing
        got = a.alloc_n(3)
        assert len(got) == 3 and a.num_free == 0

    def test_pages_for(self):
        assert pages_for(1, 8) == 1
        assert pages_for(8, 8) == 1
        assert pages_for(9, 8) == 2
        assert pages_for(17, 8) == 3


class TestScheduler:
    @pytest.mark.parametrize("prompt_len", [7, 8, 9, 15, 16, 17])
    def test_admission_matches_first_decode_demand(self, prompt_len):
        sched = Scheduler(BlockAllocator(64), page_size=8,
                          max_batch_size=2, max_pages_per_seq=8)
        req = Request(prompt=[1] * prompt_len, max_new_tokens=4,
                      sampling=SamplingParams())
        sched.add(req)
        assert sched.schedule().kind == "prefill"
        assert len(req.pages) == sched._admission_pages(req)
        req.generated.append(0)          # the token prefill emitted
        free_before = sched.allocator.num_free
        sched._ensure_decode_pages()     # first decode's page demand
        assert sched.allocator.num_free == free_before
        assert len(req.pages) == pages_for(prompt_len + 1, 8)

    def test_idle_too_large_check_counts_allocatable(self):
        sched = Scheduler(BlockAllocator(4), page_size=8,
                          max_batch_size=2, max_pages_per_seq=8)
        sched.add(Request(prompt=[1] * 30, max_new_tokens=4,
                          sampling=SamplingParams()))
        with pytest.raises(RuntimeError, match="3 allocatable"):
            sched.schedule()

    def test_youngest_is_preempted_and_requeued_at_the_front(self):
        sched = Scheduler(BlockAllocator(4), page_size=4,
                          max_batch_size=2, max_pages_per_seq=4)
        old = Request(prompt=[1] * 4, max_new_tokens=8,
                      sampling=SamplingParams())
        young = Request(prompt=[2] * 3, max_new_tokens=8,
                        sampling=SamplingParams())
        for r in (old, young):
            sched.add(r)
            assert sched.schedule().kind == "prefill"
            r.generated.append(9)
        old.generated += [9] * 4         # old now needs a third page
        decision = sched.schedule()
        assert decision.kind == "decode" and decision.decode == [old]
        assert young.status == "waiting" and sched.waiting[0] is young
        assert young.prompt == [2, 2, 2, 9] and young.generated == []
        assert young.preemptions == 1 and young.pages == []
        sched.check_consistency()
