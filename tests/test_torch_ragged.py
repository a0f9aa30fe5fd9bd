"""paddle_tpu_torch chunked prefill and the ragged mixed step against the
JAX package, plus the port's own invariants.

- K7's plain version (`_ragged_attention_reference`) against the TPU
  kernel `_ragged_paged_pallas` in interpret mode on every token, parked
  padding tokens included (both emit zeros there), over fp32 pools and,
  with scale slabs, int8 / fp8 pools; and against the JAX reference on the
  real tokens only (the JAX reference leaves padding rows unspecified);
- `build_ragged_inputs` arrays identical to JAX's for the same requests;
- the chunked scheduler cases of tests/test_chunked_prefill.py;
- greedy streams token-identical to the JAX engine under the staggered
  script, chunked with the ragged step and chained;
- port against port: ragged == chained == unchunked, horizon 1 == 8 under
  chunking, seeded sampled streams identical chunked and unchunked,
  streams unchanged under page pressure with preemptions, pool drained.

All on the CPU (small sizes: LlamaConfig.tiny(), page 8, chunk 8 or 16).
Tolerances: fp32 on both sides with JAX matmuls at "highest" precision
(conftest), atol 1e-5 (summation order only); the quantized cases compare
dequantized fp32 values, so the same limit holds.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import attention as satt
from paddle_tpu.serving import quant as jquant
from paddle_tpu.serving import ragged as jragged
from paddle_tpu.serving import scheduler as jsched
from paddle_tpu.serving.kv_cache import PagedLayerCache as JPagedLayerCache

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (
    BlockAllocator, ChunkTask, Request, SamplingParams, Scheduler,
    ServingEngine, pages_for,
)
from paddle_tpu_torch.serving import attention as tatt
from paddle_tpu_torch.serving import ragged as tragged
from paddle_tpu_torch.serving.kv_cache import PagedLayerCache
from paddle_tpu_torch.weights import load_reference_state

ATOL = 1e-5
VOCAB = 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    """numpy / jax array -> torch tensor; float8 crosses as its bytes."""
    a = np.array(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.ascontiguousarray(a.view(np.uint8))).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- K7 plain

def _flat_case(r, kv=None, heads=4, kvh=2, hd=32, ps=8, num_pages=12,
               max_pages=3, rows=4, t=16):
    """Rows 0/1 decode (positions 5 and 13), row 2 a 6-token chunk at
    positions 8..13, one token of row 3 parked mid-batch, the rest padding
    parked at the table capacity."""
    kp = r.standard_normal((kvh, num_pages, ps, hd)).astype(np.float32)
    vp = r.standard_normal((kvh, num_pages, ps, hd)).astype(np.float32)
    scales = (None, None)
    if kv is not None:
        spec = jquant.resolve_kv_dtype(kv)
        (kq, ks), (vq, vs) = (jquant.quantize_tokens(jnp.asarray(x), spec)
                              for x in (kp, vp))
        kp, vp, scales = kq, vq, (ks, vs)
    pt = r.randint(1, num_pages, (rows, max_pages)).astype(np.int32)
    cap = max_pages * ps
    pos = np.full((t,), cap, np.int32)
    row_ids = np.zeros((t,), np.int32)
    pos[0], row_ids[0] = 5, 0
    pos[1], row_ids[1] = 13, 1
    pos[2:8], row_ids[2:8] = np.arange(8, 14), 2
    row_ids[8] = 3                       # parked token of a real row
    q = r.standard_normal((1, t, heads, hd)).astype(np.float32)
    return q, kp, vp, scales, pt, pos, row_ids, heads // kvh


def _port_cache(kp, vp, scales, pt, row_ids):
    ks, vs = scales
    return PagedLayerCache(_t(kp), _t(vp), _t(pt), _t(row_ids),
                           k_scale=None if ks is None else _t(ks),
                           v_scale=None if vs is None else _t(vs))


class TestRaggedKernelPlain:
    @pytest.mark.parametrize("kv", [None, "int8", "fp8"])
    @pytest.mark.parametrize("shape", [
        dict(heads=4, kvh=2, hd=32),        # GQA rep 2
        dict(heads=2, kvh=2, hd=128, ps=16, num_pages=9, max_pages=2),
    ])
    def test_matches_pallas_on_every_token(self, kv, shape):
        r = np.random.RandomState(11)
        q, kp, vp, scales, pt, pos, rows, rep = _flat_case(r, kv, **shape)
        ref = satt._ragged_paged_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(rows),
            k_scale=scales[0], v_scale=scales[1], interpret=True)
        cache = _port_cache(kp, vp, scales, pt, rows)
        got = tatt.ragged_paged_attention(_t(q), cache, _t(pos)[None], rep)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        parked = pos >= pt.shape[1] * kp.shape[2]
        assert parked.sum() == 8
        np.testing.assert_array_equal(got.numpy()[0][parked], 0.0)

    def test_matches_jax_reference_on_real_tokens(self):
        r = np.random.RandomState(12)
        q, kp, vp, scales, pt, pos, rows, rep = _flat_case(r)
        jcache = JPagedLayerCache(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(pt), jnp.asarray(rows))
        ref = satt._ragged_attention_reference(
            Tensor(jnp.asarray(q)), jcache, jnp.asarray(pos)[None], rep)
        got = tatt._ragged_attention_reference(
            _t(q), _port_cache(kp, vp, scales, pt, rows), _t(pos)[None], rep)
        real = pos < pt.shape[1] * kp.shape[2]
        np.testing.assert_allclose(got.numpy()[0][real],
                                   ref.numpy()[0][real], atol=ATOL)

    def test_decode_token_matches_decode_plain_version(self):
        """A decode token of the flat batch computes what the (b, 1)
        decode plain version computes for its row."""
        r = np.random.RandomState(13)
        q, kp, vp, scales, pt, pos, rows, rep = _flat_case(r)
        flat = tatt._ragged_attention_reference(
            _t(q), _port_cache(kp, vp, scales, pt, rows), _t(pos)[None], rep)
        dec = tatt._paged_decode_reference(
            _t(q[0][:2][:, None]),
            PagedLayerCache(_t(kp), _t(vp), _t(pt[:2])), _t(pos[:2]), rep)
        np.testing.assert_allclose(flat.numpy()[0][:2], dec.numpy()[:, 0],
                                   atol=ATOL)

    def test_cpu_tensor_never_counts_a_launch(self):
        r = np.random.RandomState(14)
        q, kp, vp, scales, pt, pos, rows, rep = _flat_case(r)
        before = (tatt.ragged_paged_attention.launches,
                  tatt.ragged_paged_attention.quant_launches)
        tatt.ragged_paged_attention(
            _t(q), _port_cache(kp, vp, scales, pt, rows), _t(pos)[None], rep)
        assert (tatt.ragged_paged_attention.launches,
                tatt.ragged_paged_attention.quant_launches) == before

    def test_query_tile_plan(self):
        """The device-side plan cuts runs of one row into tiles of at most
        `tq` tokens; entry `count` of the starts is T."""
        rows = torch.tensor([0, 1, 2, 2, 2, 2, 2, 0, 0, 0], dtype=torch.int32)
        pos = torch.zeros_like(rows)
        starts, count = tatt._ragged_plan(rows, pos, 2, 16, 3)
        n = int(count[0])
        assert starts[:n + 1].tolist() == [0, 1, 2, 4, 6, 7, 9, 10]


# --------------------------------------------------------- host packing

def _jreq(n, max_new=6, computed=0, generated=(), pages=(1,), temp=0.0,
          eos=None):
    r = jsched.Request(prompt=list(range(1, n + 1)), max_new_tokens=max_new,
                       sampling=jsched.SamplingParams(temp, 5, 0.9),
                       eos_token_id=eos)
    r.status, r.generated = "running", list(generated)
    r.num_computed_tokens, r.pages = computed, list(pages)
    return r


def _treq(j):
    r = Request(prompt=list(j.prompt), max_new_tokens=j.max_new_tokens,
                sampling=SamplingParams(j.sampling.temperature,
                                        j.sampling.top_k, j.sampling.top_p),
                eos_token_id=j.eos_token_id)
    r.status, r.generated = "running", list(j.generated)
    r.num_computed_tokens, r.pages = j.num_computed_tokens, list(j.pages)
    return r


class TestRaggedPacking:
    def test_token_buckets_match_jax(self):
        for args in ((4, 40), (8, 320), (8, 256 + 64), (2, 7)):
            assert tragged.token_buckets(*args) == \
                jragged.token_buckets(*args)
        bks = tragged.token_buckets(4, 40)
        assert tragged.bucket_for(bks, 17) == 32
        with pytest.raises(ValueError):
            tragged.bucket_for(bks, 45)

    def test_arrays_identical_to_jax(self):
        jdec = [_jreq(10, computed=10, generated=[3, 4], pages=[1, 2]),
                _jreq(7, computed=7, generated=[9], eos=5, temp=0.7)]
        jfin, jmid = (_jreq(12, computed=8, pages=[3, 4]),
                      _jreq(30, computed=8, pages=[5, 6]))
        jchunks = [jsched.ChunkTask(req=jfin, start=8, length=4),
                   jsched.ChunkTask(req=jmid, start=8, length=8)]
        tdec = [_treq(r) for r in jdec]
        tfin, tmid = _treq(jfin), _treq(jmid)
        tchunks = [ChunkTask(req=tfin, start=8, length=4),
                   ChunkTask(req=tmid, start=8, length=8)]
        kw = dict(buckets=(16, 32), max_batch=5, horizon=8, page_size=8,
                  max_pages=8)
        jb = jragged.build_ragged_inputs(jdec, jchunks, **kw)
        draws = {tdec[0].request_id: 2, tdec[1].request_id: 1}
        tb = tragged.build_ragged_inputs(tdec, tchunks, draws=draws, **kw)
        assert tb.t_bucket == jb.t_bucket == 16
        for name in ("flat_ids", "flat_pos", "row_ids", "last_idx", "tokens",
                     "positions", "remaining", "temps", "top_ks", "top_ps",
                     "eos_ids", "decode_mask", "final_mask"):
            np.testing.assert_array_equal(getattr(tb, name),
                                          getattr(jb, name), err_msg=name)
        assert tb.incr == jb.incr == [4, 5, 1, 0]
        assert [list(p) for p in tb.page_lists] == \
            [list(p) for p in jb.page_lists]
        assert tb.reqs == tdec + [tfin, tmid]
        # the port's rows carry their next draw index: decode rows and the
        # final chunk's row; the intermediate chunk and padding draw nothing
        assert tb.draws.tolist() == [2, 1, 0, 0, 0]

    def test_overfull_step_returns_none(self):
        reqs = [_treq(_jreq(10, computed=10)) for _ in range(3)]
        chunks = [ChunkTask(req=_treq(_jreq(30, computed=8)), start=8,
                            length=8) for _ in range(2)]
        assert tragged.build_ragged_inputs(
            reqs, chunks, buckets=(64,), max_batch=4, horizon=8,
            page_size=8, max_pages=8) is None


# ------------------- mirrored from tests/test_chunked_prefill.py:111-209

class TestChunkedScheduler:
    def _sched(self, num_pages=64, chunk=8, budget=None, batch=4,
               horizon=1, ragged=False):
        return Scheduler(BlockAllocator(num_pages), page_size=8,
                         max_batch_size=batch, max_pages_per_seq=8,
                         decode_horizon=horizon, prefill_chunk_tokens=chunk,
                         max_num_batched_tokens=budget or 8 + batch,
                         ragged_steps=ragged)

    def _req(self, n, max_new=4):
        return Request(prompt=[1] * n, max_new_tokens=max_new,
                       sampling=SamplingParams())

    def test_admission_charges_first_chunk_only(self):
        sched = self._sched()
        req = self._req(30)
        sched.add(req)
        dec = sched.schedule()
        assert dec.kind == "mixed" and not dec.decode
        [task] = dec.chunks
        assert (task.req, task.start, task.length) == (req, 0, 8)
        assert len(req.pages) == 1
        assert req.num_computed_tokens == 0   # the engine advances it

    def test_chunk_topup_and_final_chunk_reserves_decode_block(self):
        sched = self._sched(horizon=4)
        req = self._req(30, max_new=8)
        sched.add(req)
        sched.schedule()
        used = []
        for computed in (8, 16, 24):
            req.num_computed_tokens = computed
            [task] = sched.schedule().chunks
            assert task.start == computed
            used.append(len(req.pages))
        assert used == [2, 3, sched._admission_pages(req)]
        assert used[-1] == pages_for(30 + 4, 8)

    def test_multi_request_admission_per_step(self):
        sched = self._sched(budget=24)
        reqs = [self._req(6) for _ in range(3)]
        for r in reqs:
            sched.add(r)
        dec = sched.schedule()
        assert dec.kind == "mixed"
        assert [t.req for t in dec.chunks] == reqs
        assert all(r.status == "running" for r in reqs)

    def test_budget_bounds_chunks_per_step(self):
        sched = self._sched(budget=16)
        for _ in range(3):
            sched.add(self._req(6))
        assert len(sched.schedule().chunks) == 2
        assert len(sched.running) == 2 and len(sched.waiting) == 1

    def test_decoders_schedule_every_step_ahead_of_prefill(self):
        sched = self._sched(budget=16, horizon=1)
        decoder = self._req(8)
        decoder.status = "running"
        decoder.pages = sched.allocator.alloc_n(2)
        decoder.num_computed_tokens = 8
        decoder.generated.append(0)
        sched.running.append(decoder)
        sched.add(self._req(40))
        dec = sched.schedule()
        assert dec.kind == "mixed"
        assert dec.decode == [decoder]
        assert len(dec.chunks) == 1 and dec.chunks[0].length == 8

    def test_mid_prefill_requests_never_join_decode(self):
        sched = self._sched(budget=64, horizon=1)
        sched.add(self._req(30))
        dec = sched.schedule()
        assert not dec.decode
        [task] = dec.chunks
        task.req.num_computed_tokens = 8
        dec = sched.schedule()
        assert not dec.decode and dec.chunks[0].start == 8

    def test_pool_exhaustion_defers_chunk_losslessly(self):
        sched = self._sched(num_pages=2, budget=64)   # 1 allocatable
        a, b = self._req(12, max_new=2), self._req(12, max_new=2)
        sched.add(a)
        sched.add(b)
        dec = sched.schedule()
        assert [t.req for t in dec.chunks] == [a]
        assert b.status == "waiting" and not b.pages
        sched.check_consistency()

    def test_preempt_resets_cursor(self):
        sched = self._sched()
        req = self._req(30)
        sched.add(req)
        sched.schedule()
        req.num_computed_tokens = 8
        sched._preempt(req)
        assert req.status == "waiting"
        assert req.num_computed_tokens == 0 and not req.pages

    def test_ragged_kind_and_chunk_free_steps_stay_decode(self):
        sched = self._sched(ragged=True)
        req = self._req(6)
        sched.add(req)
        first = sched.schedule()
        assert first.kind == "ragged" and len(first.chunks) == 1
        assert first.flat_tokens == 6
        req.num_computed_tokens = 6
        assert sched.schedule().kind == "decode"


# ------------------------------------------------------------ engines

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


def _prompts(seed=3, lens=(5, 19, 33, 11)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).tolist() for n in lens]


def _staggered(eng, prompts, max_new=10, temperature=0.0, stagger=(3, 2)):
    """The arrival script of tests/test_chunked_prefill.py: request 0
    alone, the rest a few steps apart, mid-decode of their elders."""
    rids = [eng.add_request(prompts[0], max_new_tokens=max_new,
                            temperature=temperature, seed=101)]
    for i, p in enumerate(prompts[1:], start=1):
        for _ in range(stagger[(i - 1) % len(stagger)]):
            eng.step()
        rids.append(eng.add_request(p, max_new_tokens=max_new,
                                    temperature=temperature, seed=101 + i))
    out = eng.run()
    return [out[r] for r in rids]


def _kw(chunk, horizon, **kw):
    kw.setdefault("page_size", 8)
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_seq_len", 64)
    if chunk is not None:
        kw.update(enable_chunked_prefill=True, prefill_chunk_tokens=chunk)
    kw["decode_horizon"] = horizon
    return kw


def _port(chunk=8, horizon=8, **kw):
    return ServingEngine(_port_llama(), device="cpu",
                         **_kw(chunk, horizon, **kw))


@functools.lru_cache(maxsize=None)
def _jax_streams(chunk, ragged, kv_dtype="fp32"):
    eng = JServingEngine(_jax_llama(), kv_dtype=kv_dtype,
                         **_kw(chunk, 8, enable_ragged_step=ragged))
    return _staggered(eng, _prompts())


@functools.lru_cache(maxsize=None)
def _port_run(chunk=8, ragged=True, horizon=8, kv_dtype="fp32"):
    eng = _port(chunk, horizon, enable_ragged_step=ragged,
                kv_dtype=kv_dtype)
    return _staggered(eng, _prompts()), eng


class TestAgainstJaxEngine:
    @pytest.mark.parametrize("ragged", [True, False])
    def test_chunked_streams_token_identical_to_jax(self, ragged):
        got, eng = _port_run(ragged=ragged)
        assert got == _jax_streams(8, ragged)
        s = eng.stats()
        assert s["num_finished"] == 4 and s["prefill_chunks"] > 0
        assert (s["ragged_steps"] > 0) == ragged
        assert eng.cache.allocator.num_used == 0


class TestPortInvariants:
    def test_ragged_equals_chained_equals_unchunked(self):
        unchunked = _staggered(_port(chunk=None), _prompts())
        assert _port_run(ragged=True)[0] == _port_run(ragged=False)[0] \
            == unchunked

    def test_horizon_1_equals_horizon_8_under_chunking(self):
        assert _port_run(chunk=16, horizon=1)[0] == \
            _port_run(chunk=16, horizon=8)[0]

    def test_seeded_sampled_streams_identical_chunked_and_unchunked(self):
        prompts = _prompts(4)
        kw = dict(max_new=9, temperature=0.8)
        runs = [_staggered(eng, prompts, **kw)
                for eng in (_port(chunk=None), _port(chunk=8),
                            _port(chunk=8, enable_ragged_step=False))]
        assert runs[0] == runs[1] == runs[2]

    def test_streams_unchanged_under_page_pressure(self):
        prompts = _prompts(5, lens=(30, 25, 20, 28))
        ref = _staggered(_port(chunk=8, horizon=4), prompts, max_new=12)
        tight = _port(chunk=8, horizon=4, num_pages=8)
        got = _staggered(tight, prompts, max_new=12)
        assert got == ref
        assert tight.stats()["preemptions"] > 0
        assert tight.cache.allocator.num_used == 0
        tight.scheduler.check_consistency()

    def test_stats_and_decode_stall(self):
        _, eng = _port_run()
        s = eng.stats()
        assert s["ragged_steps"] > 0 and s["decode_steps"] > 0
        assert s["latency"]["decode_stall"]["count"] > 0
        assert "quant" not in s


class TestEngineKnobs:
    def test_chunk_must_be_a_page_multiple(self):
        with pytest.raises(ValueError, match="multiple of page_size"):
            _port(chunk=12)

    def test_budget_must_fit_a_chunk(self):
        with pytest.raises(ValueError, match="max_num_batched_tokens"):
            _port(chunk=16, max_num_batched_tokens=8)

    def test_defaults_follow_the_reference(self):
        eng = _port(chunk=16, horizon=4)
        assert eng.max_num_batched_tokens == 16 + 4 * 4
        assert eng.enable_ragged_step
        assert eng.token_buckets == (16, 32, 36)
        eng = _port(chunk=16, enable_ragged_step=False)
        assert eng.token_buckets is None

    def test_bucket_ceiling_binds_only_unchunked(self):
        prompt = list(range(30))
        for chunk in (None, 8):
            eng = _port(chunk=chunk)
            eng.prefill_buckets = (16,)
            if chunk is None:
                with pytest.raises(ValueError, match="prefill bucket"):
                    eng.add_request(prompt, max_new_tokens=4)
            else:
                rid = eng.add_request(prompt, max_new_tokens=4)
                assert len(eng.run()[rid]) == 34
