"""paddle_tpu_torch quantized KV pools (int8 / fp8 with per-slot scales)
against the JAX package, plus the port's own invariants.

- `quantize_tokens` writes the JAX package's bytes and scales (compared
  exactly, round-half-to-even ties included), `dequantize` and the
  construction-time round-trip probe agree;
- page and pool bytes count the 4-byte scale of every slot and head, as
  the JAX pools do;
- K6q's plain version (`_paged_decode_reference` over int8 / fp8 pools
  and their scale slabs) against `_paged_decode_pallas(k_scale=, v_scale=,
  interpret=True)`: both dequantize to fp32 and compute in fp32 (JAX
  matmuls at "highest" precision, conftest), so atol 1e-5 (summation order
  only);
- greedy streams token-identical to the JAX engine at the same kv_dtype,
  chunked with the ragged step and unchunked; every quantized path of the
  port (unchunked, ragged, chained) emits the same stream;
- an fp32 / bf16 engine never imports `serving.quant`;
- the quantized all-reduce of tensor-parallel serving: `block_quantize`
  writes the JAX package's int8 blocks and scales, `block_dequant_sum`
  equals the JAX one, `quantized_allreduce` stays within the reference's
  bound of the plain sum (half an int8 step of each block's amax a
  shard) and gives every device the same bits; tp=2 engines over int8
  pools, with and without the int8 all-reduce, emit the tp=1 int8 stream
  (and the JAX engine's), and a tp=2 int8 stream folded onto a tp=1
  int8 survivor through `adopt_request` completes it exactly.
"""
import functools
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import attention as satt
from paddle_tpu.serving import quant as jquant
from paddle_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache
from paddle_tpu.serving.kv_cache import PagedLayerCache as JPagedLayerCache

import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import attention as tatt
from paddle_tpu_torch.serving import quant as tquant
from paddle_tpu_torch.serving.kv_cache import PagedKVCache, PagedLayerCache
from paddle_tpu_torch.weights import load_reference_state

ATOL = 1e-5
VOCAB = 512
KINDS = ["int8", "fp8"]


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
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _bytes(x):
    """The raw bytes of a torch or jax quantized array, as uint8 numpy."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


# -------------------------------------------------------------- primitives

def _inputs(seed=0):
    r = np.random.RandomState(seed)
    x = (r.standard_normal((40, 3, 32)) * 3).astype(np.float32)
    x[0, 0] = 0.0                          # all-zero slot: scale 1, zeros
    # amax 127 makes the int8 scale exactly 1, so x / scale keeps the .5
    # ties: round half to even must agree
    x[1, 0] = 0.0
    x[1, 0, :8] = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -2.5]
    x[2, 1, :] = 1e-30                     # tiny amax
    return x


class TestQuantizeTokens:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bytes_and_scales_identical_to_jax(self, kind, dtype):
        x = _inputs()
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        jq, js = jquant.quantize_tokens(jx, jquant.resolve_kv_dtype(kind))
        tq, ts = tquant.quantize_tokens(tx, tquant.resolve_kv_dtype(kind))
        assert tq.dtype == (torch.int8 if kind == "int8"
                            else torch.float8_e4m3fn)
        assert ts.dtype == torch.float32 and ts.shape == (40, 3, 1)
        np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ts.numpy()[0, 0], 1.0)
        np.testing.assert_array_equal(_bytes(tq)[0, 0], 0)

    @pytest.mark.parametrize("kind", KINDS)
    def test_dequantize_and_roundtrip_probe_match_jax(self, kind):
        x = _inputs(1)
        jspec, tspec = (m.resolve_kv_dtype(kind) for m in (jquant, tquant))
        jq, js = jquant.quantize_tokens(jnp.asarray(x), jspec)
        tq, ts = tquant.quantize_tokens(torch.from_numpy(x), tspec)
        np.testing.assert_array_equal(tquant.dequantize(tq, ts).numpy(),
                                      np.asarray(jquant.dequantize(jq, js)))
        jerr = jquant.measure_roundtrip_error(jspec, 64)
        terr = tquant.measure_roundtrip_error(tspec, 64)
        assert abs(jerr - terr) < 1e-6
        assert 0 < terr < (0.01 if kind == "int8" else 0.05)

    def test_resolve_validates(self):
        assert tquant.resolve_kv_dtype("int8").qmax == 127.0
        assert tquant.resolve_kv_dtype("fp8").qmax == 448.0
        assert tquant.resolve_kv_dtype("fp8").storage_itemsize == 1
        with pytest.raises(ValueError, match="int8"):
            tquant.resolve_kv_dtype("int4")
        with pytest.raises(ValueError, match="float32/bfloat16"):
            tquant.resolve_kv_dtype("int8", torch.float16)


class TestPoolBytes:
    @pytest.mark.parametrize("kind", ["fp32", "bf16"] + KINDS)
    def test_page_and_pool_bytes_match_jax(self, kind):
        port = PagedKVCache(2, 8, 8, 2, 16, kv_dtype=kind, device="cpu")
        ref = JPagedKVCache(2, 8, 8, 2, 16, kv_dtype=kind)
        assert port.page_bytes == ref.page_bytes
        assert port.pool_bytes == ref.pool_bytes
        assert port.kv_dtype == ref.kv_dtype and port.quantized == \
            ref.quantized
        actual = sum(t.numel() * t.element_size()
                     for layer in port.pools for t in layer)
        assert actual == port.pool_bytes
        if port.quantized:
            assert port.pool_bytes == tquant.kv_pool_bytes(
                2, 8, 8, 2, 16, itemsize=1, quantized=True)
            k, v, ks, vs = port.pools[0]
            assert ks.shape == (2, 8, 8, 1) and ks.dtype == torch.float32
            assert bool((ks == 1).all()) and bool((k.view(torch.uint8)
                                                   == 0).all())

    def test_int8_page_is_0_52_of_bf16_at_llama7b_width(self):
        """128 B of data + 4 B of scale per slot and head, against 256 B."""
        bf16, int8, fp8 = (PagedKVCache(1, 2, 16, 32, 128, kv_dtype=k,
                                        device="cpu").page_bytes
                           for k in ("bf16", "int8", "fp8"))
        assert int8 / bf16 == fp8 / bf16 == 264 / 512


# ---------------------------------------------------------- K6q plain

def _quant_case(r, kind, b, heads, kvh, hd, ps, num_pages, max_pages, pos):
    spec = jquant.resolve_kv_dtype(kind)
    (kq, ks), (vq, vs) = (jquant.quantize_tokens(jnp.asarray(
        r.standard_normal((kvh, num_pages, ps, hd)).astype(np.float32)),
        spec) for _ in range(2))
    pt = r.randint(1, num_pages, (b, max_pages)).astype(np.int32)
    q = r.standard_normal((b, 1, heads, hd)).astype(np.float32)
    return q, (kq, vq, ks, vs), pt, np.asarray(pos, np.int32)


class TestK6q:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("case", [
        dict(b=3, heads=8, kvh=2, hd=16, ps=4, num_pages=12, max_pages=5,
             pos=[0, 9, 20]),                # GQA rep 4, a parked row
        dict(b=3, heads=2, kvh=2, hd=128, ps=16, num_pages=9, max_pages=4,
             pos=[64, 0, 33]),
    ])
    def test_plain_version_matches_pallas(self, kind, case):
        r = np.random.RandomState(21)
        q, (kq, vq, ks, vs), pt, pos = _quant_case(r, kind, **case)
        ref = satt._paged_decode_pallas(
            jnp.asarray(q), kq, vq, jnp.asarray(pt), jnp.asarray(pos),
            k_scale=ks, v_scale=vs, interpret=True)
        cache = PagedLayerCache(_t(kq), _t(vq), _t(pt), k_scale=_t(ks),
                                v_scale=_t(vs))
        got = tatt.paged_decode_attention(_t(q), cache, _t(pos),
                                          case["heads"] // case["kvh"])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("kind", KINDS)
    def test_plain_version_matches_jax_reference(self, kind):
        from paddle_tpu.core.tensor import Tensor

        r = np.random.RandomState(22)
        q, (kq, vq, ks, vs), pt, pos = _quant_case(r, kind, 2, 4, 2, 8, 4,
                                                   6, 3, [2, 11])
        jcache = JPagedLayerCache(kq, vq, jnp.asarray(pt), k_scale=ks,
                                  v_scale=vs)
        ref = satt._paged_decode_reference(Tensor(jnp.asarray(q)), jcache,
                                           jnp.asarray(pos), 2)
        got = tatt._paged_decode_reference(
            _t(q), PagedLayerCache(_t(kq), _t(vq), _t(pt), k_scale=_t(ks),
                                   v_scale=_t(vs)), _t(pos), 2)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)

    def test_cpu_tensor_never_counts_a_launch(self):
        r = np.random.RandomState(23)
        q, (kq, vq, ks, vs), pt, pos = _quant_case(r, "int8", 1, 2, 2, 8, 4,
                                                   3, 2, [1])
        before = tatt.paged_decode_attention.quant_launches
        tatt.paged_decode_attention(
            _t(q), PagedLayerCache(_t(kq), _t(vq), _t(pt), k_scale=_t(ks),
                                   v_scale=_t(vs)), _t(pos), 1)
        assert tatt.paged_decode_attention.quant_launches == before


# -------------------------------------------------------------- engines

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


PROMPTS = tuple(tuple(np.random.RandomState(6).randint(0, VOCAB, (n,))
                      .tolist()) for n in (7, 21, 13))


def _kw(chunk, **kw):
    kw.update(page_size=8, max_batch_size=4, max_seq_len=64,
              decode_horizon=4)
    if chunk is not None:
        kw.update(enable_chunked_prefill=True, prefill_chunk_tokens=chunk)
    return kw


def _staggered(eng, max_new=8):
    """Request 0 alone, request 1 two steps later, request 2 one step after
    that: prompts arrive while elders decode."""
    rids = [eng.add_request(list(PROMPTS[0]), max_new_tokens=max_new)]
    for p, wait in zip(PROMPTS[1:], (2, 1)):
        for _ in range(wait):
            eng.step()
        rids.append(eng.add_request(list(p), max_new_tokens=max_new))
    out = eng.run()
    return [out[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _jax_streams(kind, chunk):
    return _staggered(JServingEngine(_jax_llama(), kv_dtype=kind,
                                     **_kw(chunk)))


@functools.lru_cache(maxsize=None)
def _port_run(kind, chunk, ragged=True):
    eng = ServingEngine(_port_llama(), device="cpu", kv_dtype=kind,
                        **_kw(chunk, enable_ragged_step=ragged))
    return _staggered(eng), eng


class TestQuantizedEngine:
    @pytest.mark.parametrize("kind,chunk", [("int8", 8), ("fp8", 8),
                                            ("int8", None)])
    def test_streams_token_identical_to_jax(self, kind, chunk):
        got, eng = _port_run(kind, chunk)
        assert got == _jax_streams(kind, chunk)
        assert eng.cache.quantized and eng.cache.kv_dtype == kind
        assert eng.cache.allocator.num_used == 0

    @pytest.mark.parametrize("kind", KINDS)
    def test_every_quantized_path_emits_the_same_stream(self, kind):
        assert _port_run(kind, None)[0] == _port_run(kind, 8)[0] == \
            _port_run(kind, 8, ragged=False)[0]

    def test_quant_stats_section(self):
        _, eng = _port_run("int8", 8)
        q = eng.stats()["quant"]
        assert q["kv_dtype"] == "int8"
        assert q["pool_bytes"] == eng.cache.pool_bytes
        assert q["page_bytes"] == eng.cache.page_bytes
        assert q["fp32_pool_bytes"] > 2 * q["pool_bytes"]
        reg = eng.metrics
        assert reg.get("serving_kv_pool_bytes",
                       {"kv_dtype": "int8"}).value == eng.cache.pool_bytes
        assert 0 < reg.get("serving_kv_quant_rms_error").value < 0.01


class TestZeroImport:
    def _poison(self, monkeypatch):
        def _boom(name):
            raise AssertionError(f"serving.quant touched: {name}")

        poison = types.ModuleType("paddle_tpu_torch.serving.quant")
        poison.__getattr__ = _boom
        monkeypatch.setitem(sys.modules, "paddle_tpu_torch.serving.quant",
                            poison)
        monkeypatch.setattr(tserving, "quant", poison, raising=False)

    @pytest.mark.parametrize("kind", ["fp32", "bf16"])
    def test_plain_engine_imports_zero_quant_code(self, kind, monkeypatch):
        """A full chunked request lifecycle over fp32 / bf16 pools never
        touches serving.quant."""
        self._poison(monkeypatch)
        eng = ServingEngine(_port_llama(), device="cpu", kv_dtype=kind,
                            **_kw(8))
        rid = eng.add_request(list(PROMPTS[1]), max_new_tokens=4)
        assert len(eng.run()[rid]) == len(PROMPTS[1]) + 4

    def test_int8_engine_does_touch_quant(self, monkeypatch):
        self._poison(monkeypatch)
        with pytest.raises(AssertionError, match="quant touched"):
            ServingEngine(_port_llama(), device="cpu", kv_dtype="int8",
                          **_kw(None))


# ------------------------------------------ the quantized all-reduce (S5)

class TestQuantizedAllReduce:
    @pytest.mark.parametrize("shape", [(2, 4, 300), (5, 256), (3, 1, 64)])
    def test_block_quantize_matches_jax(self, shape):
        x = np.random.RandomState(3).standard_normal(shape).astype(
            np.float32)
        x[0] = 0.0                        # an all-zero row: scale 1
        q, scale = tquant.block_quantize(torch.from_numpy(x))
        jq, js = jquant.block_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))

    def test_block_dequant_sum_matches_jax(self):
        rng = np.random.RandomState(4)
        parts = [rng.standard_normal((3, 300)).astype(np.float32)
                 for _ in range(2)]
        packed = [tquant.block_quantize(torch.from_numpy(p)) for p in parts]
        got = tquant.block_dequant_sum([q for q, _ in packed],
                                       [s for _, s in packed], 300,
                                       torch.float32)
        jpacked = [jquant.block_quantize(jnp.asarray(p)) for p in parts]
        want = jquant.block_dequant_sum(
            jnp.stack([q for q, _ in jpacked]),
            jnp.stack([s for _, s in jpacked]), 300, jnp.float32)
        assert got.shape == (3, 300)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("tp", [2, 4])
    def test_quantized_allreduce_within_the_reference_bound(self, tp):
        rng = np.random.RandomState(3)
        cpu = torch.device("cpu")
        parts = [torch.from_numpy(rng.standard_normal((4, 300)).astype(
            np.float32)) for _ in range(tp)]
        out = tquant.quantized_allreduce(parts, [cpu] * tp)
        exact = sum(p.double() for p in parts).float()
        # half an int8 step of the block amax a shard; amax of N(0,1) over
        # 256 is ~4 (tests/test_quant.py's bound, per shard)
        np.testing.assert_allclose(out[cpu].numpy(), exact.numpy(),
                                   atol=tp * 4 / 254, rtol=3e-2)
        assert out[cpu].dtype == torch.float32

    def test_every_target_holds_the_same_bits(self):
        rng = np.random.RandomState(5)
        cpu = torch.device("cpu")
        parts = [torch.from_numpy(rng.standard_normal((2, 64)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(2)]
        out = tquant.quantized_allreduce(parts, [cpu, cpu])
        again = tquant.quantized_allreduce(list(reversed(parts))[::-1],
                                           [cpu])
        assert list(out) == [cpu] and out[cpu].dtype == torch.bfloat16
        assert torch.equal(out[cpu], again[cpu])

    @pytest.mark.parametrize("qar", [False, True])
    def test_tp2_int8_streams_equal_tp1(self, qar):
        eng = ServingEngine(_port_llama(), device="cpu", kv_dtype="int8",
                            tp_size=2, tp_quantized_allreduce=qar,
                            **_kw(None))
        got = _staggered(eng)
        assert got == _port_run("int8", None)[0] == \
            _jax_streams("int8", None)
        probe = eng.metrics.get("serving_tp_collective_seconds",
                                labels={"overlap": "off"})
        assert probe is not None and probe.count > 0
        assert eng.stats()["quant"]["tp_quantized_allreduce"] is qar

    def test_tp2_int8_migrates_onto_tp1_survivor(self):
        """The fold of a tp=2 int8 engine's delivered tokens into a tp=1
        int8 survivor (`adopt_request`) completes the same stream."""
        prompt = list(PROMPTS[1])
        src = ServingEngine(_port_llama(), device="cpu", kv_dtype="int8",
                            tp_size=2, **_kw(None))
        rid = src.add_request(prompt, max_new_tokens=10, seed=0)
        full = src.run()[rid]
        survivor = ServingEngine(_port_llama(), device="cpu",
                                 kv_dtype="int8", **_kw(None))
        new = survivor.adopt_request(prompt=prompt,
                                     delivered=full[len(prompt):][:3],
                                     max_new_tokens=10, seed=0)
        assert survivor.run()[new] == full
