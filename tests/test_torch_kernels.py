"""paddle_tpu_torch kernels' plain versions against the JAX package's
Pallas kernels run in interpret mode, on the same numpy inputs.

Each hand-written Hopper kernel of the port (fused norm forward, flash
attention forward, paged decode) has a plain PyTorch version that the
wrapper runs for CPU tensors; the card compares kernel and plain version
in chip_smoke.py. Here the plain versions are held to the TPU kernels'
semantics: fp32 on both sides, JAX matmuls at "highest" precision
(conftest), atol 1e-5 unless stated. Also RoPE against the ops.yaml op
for its three offset kinds.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import tensor as ptensor
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.serving import attention as satt

from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import norm as tnorm
from paddle_tpu_torch.ops import rope as trope
from paddle_tpu_torch.serving import attention as tatt
from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ K4 norm

class TestNormForward:
    @pytest.mark.parametrize("rows", [(13,), (3, 5), (1,)])
    def test_rms_norm_matches_pallas(self, rows):
        r = np.random.RandomState(0)
        x = r.standard_normal((*rows, 256)).astype(np.float32)
        w = (r.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
        ref = pk.rms_norm_fused(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                interpret=True)
        y, mean, rstd = tnorm.norm_forward(_t(x), _t(w), None, 1e-6, False)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref), atol=ATOL)
        assert y.shape == x.shape and mean.shape == rstd.shape == (
            int(np.prod(rows)),)
        np.testing.assert_array_equal(mean.numpy(), 0.0)
        np.testing.assert_allclose(
            rstd.numpy(),
            1.0 / np.sqrt((x.reshape(-1, 256) ** 2).mean(1) + 1e-6),
            rtol=1e-5)

    @pytest.mark.parametrize("with_bias", [True, False])
    def test_layer_norm_matches_pallas(self, with_bias):
        r = np.random.RandomState(1)
        x = (r.standard_normal((9, 384)) * 2 + 0.5).astype(np.float32)
        w = (r.standard_normal(384) * 0.1 + 1.0).astype(np.float32)
        b = (r.standard_normal(384) * 0.1).astype(np.float32)
        jb = jnp.asarray(b) if with_bias else None
        ref = pk.layer_norm_fused(jnp.asarray(x), jnp.asarray(w), jb, 1e-5,
                                  interpret=True)
        got = tnorm.layer_norm(_t(x), _t(w), _t(b) if with_bias else None,
                               1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_bf16_plain_computes_in_fp32(self):
        r = np.random.RandomState(2)
        x = r.standard_normal((4, 128)).astype(np.float32)
        w = np.ones(128, np.float32)
        y32 = tnorm.rms_norm(_t(x), _t(w))
        y16 = tnorm.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
        assert y16.dtype == torch.bfloat16
        # bf16 keeps 8 mantissa bits: one rounding of the fp32 result
        np.testing.assert_allclose(y16.float().numpy(), y32.numpy(),
                                   rtol=1e-2, atol=1e-2)

    def test_cpu_tensor_never_counts_a_launch(self):
        before = tnorm.norm_forward.launches
        tnorm.rms_norm(torch.ones(2, 128), torch.ones(128))
        assert tnorm.norm_forward.launches == before


# --------------------------------------------------------- K1 flash forward

def _qkv(r, b, sq, sk, h, d):
    return (r.standard_normal((b, sq, h, d)).astype(np.float32),
            r.standard_normal((b, sk, h, d)).astype(np.float32),
            r.standard_normal((b, sk, h, d)).astype(np.float32))


# mask pattern, then "sq x sk" where it is not 37 x 45: the Hopper kernel's
# tile edges (64 / 128 rows, 64 / 128 keys), sk = 114 (a 456-byte mask row,
# no multiple of 16 bytes) and a query row that sees no key ("dead row")
MASK_CASES = ["b11k", "1hqk", "bhqk", "11qk", "b11k 1x114", "1hqk 63x114",
              "bhqk 114x114", "11qk 129x114", "1hqk 65x65 dead row",
              "b11k 200x200"]


class TestFlashForward:
    @pytest.mark.parametrize("mask_shape", MASK_CASES)
    def test_masked_matches_pallas(self, mask_shape):
        r = np.random.RandomState(3)
        pattern, *size = mask_shape.split(" ", 2)
        sq, sk = (int(n) for n in size[0].split("x")) if size else (37, 45)
        b, h, d = 2, 3, 32
        q, k, v = _qkv(r, b, sq, sk, h, d)
        shape = {"b11k": (b, 1, 1, sk), "1hqk": (1, h, sq, sk),
                 "bhqk": (b, h, sq, sk), "11qk": (1, 1, sq, sk)}[pattern]
        mask = np.where(r.random_sample(shape) < 0.2, -1e9,
                        r.standard_normal(shape)).astype(np.float32)
        if mask_shape.endswith("dead row"):
            mask[:, :, 3] = -np.inf   # query row 3 sees no key: out 0
        ref = pk._flash_attention_data(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), has_mask=True, interpret=True)
        got = tflash.flash_attention(_t(q), _t(k), _t(v), _t(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    @pytest.mark.parametrize("s", [29, 64, 1, 63, 65, 127, 129, 200])
    def test_causal_matches_pallas(self, s):
        r = np.random.RandomState(4)
        q, k, v = _qkv(r, 1, s, s, 2, 64)
        ref = pk._flash_attention_data(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), is_causal=True,
                                       interpret=True)
        got = tflash.flash_attention(_t(q), _t(k), _t(v), is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_causal_plus_float_mask_matches_pallas(self):
        r = np.random.RandomState(5)
        q, k, v = _qkv(r, 1, 21, 21, 2, 16)
        mask = r.standard_normal((1, 1, 21, 21)).astype(np.float32)
        ref = pk._flash_attention_data(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), is_causal=True, has_mask=True,
            interpret=True)
        got = tflash.flash_attention(_t(q), _t(k), _t(v), _t(mask),
                                     is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_lse_is_row_logsumexp(self):
        r = np.random.RandomState(6)
        q, k, v = _qkv(r, 1, 10, 10, 2, 8)
        out, lse = tflash.flash_attention(_t(q), _t(k), _t(v),
                                          is_causal=True, return_lse=True)
        logits = torch.einsum("bqhd,bkhd->bhqk", _t(q), _t(k)) / np.sqrt(8)
        logits = logits.masked_fill(
            ~torch.ones(10, 10, dtype=torch.bool).tril(), float("-inf"))
        np.testing.assert_allclose(lse.numpy(),
                                   torch.logsumexp(logits, -1).numpy(),
                                   atol=ATOL)
        assert out.shape == (1, 10, 2, 8) and lse.shape == (1, 2, 10)

    def test_fully_masked_row_gives_zero_and_lse_zero(self):
        q = torch.ones(1, 2, 1, 4)
        mask = torch.tensor([[[[float("-inf"), float("-inf")],
                               [0.0, 0.0]]]])
        out, lse = tflash.flash_attention(q, q, q, mask, return_lse=True)
        assert torch.all(out[0, 0] == 0) and float(lse[0, 0, 0]) == 0.0
        assert torch.all(torch.isfinite(out))


# ---------------------------------------------------------- K6 paged decode

def _paged_case(r, b, heads, kvh, hd, ps, num_pages, max_pages, pos):
    kp = r.standard_normal((kvh, num_pages, ps, hd)).astype(np.float32)
    vp = r.standard_normal((kvh, num_pages, ps, hd)).astype(np.float32)
    pt = r.randint(1, num_pages, (b, max_pages)).astype(np.int32)
    q = r.standard_normal((b, 1, heads, hd)).astype(np.float32)
    return q, kp, vp, pt, np.asarray(pos, np.int32)


class TestPagedDecode:
    @pytest.mark.parametrize("case", [
        # the test_serving.py kernel-parity shapes
        dict(b=4, heads=4, kvh=2, hd=32, ps=8, num_pages=10, max_pages=3,
             pos=[3, 7, 14, 21]),
        # GQA rep=4, pages past pos skipped, one parked row (pos = maxP*ps)
        dict(b=3, heads=8, kvh=2, hd=16, ps=4, num_pages=12, max_pages=5,
             pos=[0, 9, 20]),
        # the main path's head_dim / page_size, rep=1, parked + position 0
        dict(b=3, heads=2, kvh=2, hd=128, ps=16, num_pages=9, max_pages=4,
             pos=[64, 0, 33]),
    ])
    def test_matches_pallas(self, case):
        r = np.random.RandomState(7)
        q, kp, vp, pt, pos = _paged_case(r, **case)
        ref = satt._paged_decode_pallas(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(pt), jnp.asarray(pos), interpret=True)
        rep = case["heads"] // case["kvh"]
        cache = PagedLayerCache(_t(kp), _t(vp), _t(pt))
        got = tatt.paged_decode_attention(_t(q), cache, _t(pos), rep)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    def test_matches_reference_gather(self):
        """The plain version is also the JAX engine's own reference path
        (gather + sdpa with the -1e9 floor)."""
        r = np.random.RandomState(8)
        q, kp, vp, pt, pos = _paged_case(r, 2, 4, 2, 8, 4, 6, 3, [2, 11])
        jcache = satt.PagedLayerCache(jnp.asarray(kp), jnp.asarray(vp),
                                      jnp.asarray(pt))
        ref = satt._paged_decode_reference(Tensor(jnp.asarray(q)), jcache,
                                           jnp.asarray(pos), 2)
        got = tatt._paged_decode_reference(
            _t(q), PagedLayerCache(_t(kp), _t(vp), _t(pt)), _t(pos), 2)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)

    def test_cpu_tensor_never_counts_a_launch(self):
        r = np.random.RandomState(9)
        q, kp, vp, pt, pos = _paged_case(r, 1, 2, 2, 8, 4, 3, 2, [1])
        before = tatt.paged_decode_attention.launches
        tatt.paged_decode_attention(
            _t(q), PagedLayerCache(_t(kp), _t(vp), _t(pt)), _t(pos), 1)
        assert tatt.paged_decode_attention.launches == before


# --------------------------------------------------------------------- RoPE

class TestRope:
    @pytest.mark.parametrize("kind", ["scalar", "rows", "positions"])
    def test_matches_ops_yaml_op(self, kind):
        r = np.random.RandomState(10)
        b, s, h, d = 2, 5, 3, 16
        q = r.standard_normal((b, s, h, d)).astype(np.float32)
        k = r.standard_normal((b, s, h, d)).astype(np.float32)
        if kind == "scalar":
            off_j, off_t = 7, 7
        elif kind == "rows":
            off = np.asarray([3, 40], np.int32)
            off_j, off_t = jnp.asarray(off), _t(off)
        else:
            off = r.randint(0, 60, (b, s)).astype(np.int32)
            off_j, off_t = jnp.asarray(off), _t(off)
        rq, rk = ptensor.rotary_position_embedding(
            Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)), theta=10000.0,
            position_offset=off_j)
        tq, tk = trope.rotary_position_embedding(_t(q), _t(k), 10000.0,
                                                 off_t)
        np.testing.assert_allclose(tq.numpy(), rq.numpy(), atol=ATOL)
        np.testing.assert_allclose(tk.numpy(), rk.numpy(), atol=ATOL)

    def test_bf16_casts_back(self):
        q = torch.randn(1, 3, 2, 8).bfloat16()
        rq, rk = trope.rotary_position_embedding(q, q, position_offset=2)
        assert rq.dtype == torch.bfloat16 and rk.shape == q.shape
