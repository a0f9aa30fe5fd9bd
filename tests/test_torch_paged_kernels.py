"""The Hopper paged attention kernels' host-side logic and arithmetic, on the
CPU (the kernels themselves run only on the card, in chip_smoke.py).

- K7's query-tile plan (`_ragged_plan`) over many seeded row layouts:
  decode-only, one chunk, chunk plus decode, parked padding between and
  after, at rep 1 and 4: every token in exactly one tile, no tile crossing
  rows or mixing live and parked tokens, single-token tiles exactly the
  tokens alone in their run, no tile above the cap; the cap
  (`RAGGED_TILE_ROWS`) is read without loading the CUDA library;
- the element conversions the kernels rely on: every int8 code and every
  finite fp8 e4m3 value is exact in bf16 and in fp16, and the kernels'
  int8 -> fp32 trick (2^23 + code + 128 as a float's bits, minus
  2^23 + 128) gives every code exactly;
- at LLaMA width (32 heads of 128) over int8 / fp8 pools quantized by the
  port's `quantize_tokens`: a plain torch rendering of the kernels'
  rounding (codes to bf16, S x k_scale; on K7's tensor-core tiles p x
  v_scale over the tile's largest v_scale as a sum of two fp16 terms, on
  the decode walk in fp32; fp32 sums) against the plain versions
  `_ragged_attention_reference` / `_paged_decode_reference`: before the
  output's bf16 rounding (the plain versions in fp32) within a third of
  K7q / K6q's 1e-2 limit on the card, and rounded (the plain versions on
  bf16 q, as the card compares) within the limit; and those plain
  versions against the JAX package's on the same numpy inputs (fp32 on
  both sides, atol 1e-5).

Sizes are cut in depth (a capacity of 128 or 256 positions) so that the
gathered (kvh, T, L, hd) views stay around 100 MB.
"""
import math

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.serving import attention as satt
from paddle_tpu.serving.kv_cache import PagedLayerCache as JPagedLayerCache

from paddle_tpu_torch.serving import attention as tatt
from paddle_tpu_torch.serving.kv_cache import PagedLayerCache
from paddle_tpu_torch.serving.quant import quantize_tokens, resolve_kv_dtype

# a third of the card's K6q / K7q limit (chip_smoke.TOL, bf16 outputs)
RENDER_ATOL = 1e-2 / 3
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- the plan

def _layout(kind, r, cap=256, rows=12):
    """(row_ids, pos) of a flat step of `kind`, drawn from `r`."""
    rid, pos = [], []

    def decode(n):
        for row in r.choice(rows, n, replace=False):
            rid.append(int(row))
            pos.append(int(r.randint(0, cap)))

    def chunk(row):
        n = int(r.choice([2, 15, 16, 17, 33, 64, 65, 100, 129]))
        start = int(r.randint(0, cap - n + 1))
        rid.extend([row] * n)
        pos.extend(range(start, start + n))

    def park(n, row=None):
        for _ in range(n):
            rid.append(int(r.randint(0, rows)) if row is None else row)
            pos.append(cap + int(r.randint(0, 2)))

    if kind == "decode":
        decode(int(r.randint(1, 9)))
    elif kind == "chunk":
        chunk(int(r.randint(0, rows)))
    elif kind == "chunk_decode":
        decode(int(r.randint(1, 9)))
        chunk(rows - 1)
    elif kind == "parked_between":
        decode(3)
        park(int(r.randint(1, 5)))
        chunk(rows - 1)
        park(int(r.randint(1, 3)), row=rows - 1)   # same row as the chunk
        decode(2)
    elif kind == "parked_after":
        decode(int(r.randint(1, 9)))
        chunk(rows - 1)
        park(int(r.randint(1, 80)), row=0)
    rid.append(-1)                       # a token naming no table row
    pos.append(3)
    return (torch.tensor(rid, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32))


def _runs(rid, pos, cap, rows):
    """Maximal stretches of one row id, all live or all parked."""
    parked = [(p < 0 or p >= cap or r < 0 or r >= rows)
              for r, p in zip(rid, pos)]
    runs, start = [], 0
    for i in range(1, len(rid) + 1):
        if i == len(rid) or rid[i] != rid[i - 1] or parked[i] != parked[i - 1]:
            runs.append((start, i))
            start = i
    return runs


def test_tile_cap_is_a_python_constant():
    assert tatt.RAGGED_TILE_ROWS == 64
    assert tatt._ragged_tile_rows(torch.bfloat16, torch.int8) == 64
    assert tatt._ragged_tile_rows(torch.bfloat16, torch.bfloat16) == 64
    assert tatt._ragged_tile_rows(torch.bfloat16, torch.float32) == 16
    assert tatt._ragged_tile_rows(torch.float32, torch.int8) == 16


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("kind", ["decode", "chunk", "chunk_decode",
                                  "parked_between", "parked_after"])
def test_plan_tiles(kind, rep):
    cap, rows = 256, 12
    tq = tatt.RAGGED_TILE_ROWS // rep
    for seed in range(12):
        r = np.random.RandomState(1000 * rep + seed)
        rid, pos = _layout(kind, r, cap, rows)
        t = len(rid)
        starts, count = tatt._ragged_plan(rid, pos, tq, cap, rows)
        n = int(count[0])
        bounds = starts[:n + 1].tolist()
        assert bounds[0] == 0 and bounds[-1] == t
        assert all(a < b for a, b in zip(bounds, bounds[1:]))  # cover once
        tiles = list(zip(bounds, bounds[1:]))
        ridl, posl = rid.tolist(), pos.tolist()
        runs = _runs(ridl, posl, cap, rows)
        run_of = {}
        for k, (a, b) in enumerate(runs):
            for i in range(a, b):
                run_of[i] = k
        lone = {a for a, b in runs if b - a == 1}
        for a, b in tiles:
            assert b - a <= tq
            assert len({run_of[i] for i in range(a, b)}) == 1
        assert {a for a, b in tiles if b - a == 1} == lone
        live = [a for a, b in tiles
                if 0 <= posl[a] < cap and 0 <= ridl[a] < rows]
        assert int(count[1]) == len(live)


def test_plan_counts_the_live_tiles():
    # 2 decode tokens, a 17-token run of row 2 (2 tiles at a cap of 16),
    # 40 parked tokens of row 2 (3 tiles), a token naming no row: 8 tiles,
    # 4 of them live
    rid = torch.tensor([0, 1] + [2] * 57 + [-1], dtype=torch.int32)
    pos = torch.tensor([5, 900] + list(range(1007, 1024)) + [1024] * 40
                       + [3], dtype=torch.int32)
    starts, count = tatt._ragged_plan(rid, pos, 16, 1024, 3)
    assert count.tolist() == [8, 4]
    assert starts[:9].tolist() == [0, 1, 2, 11, 19, 33, 46, 59, 60]


def test_plan_cuts_runs_into_nearly_equal_tiles():
    rid = torch.zeros(65, dtype=torch.int32)
    pos = torch.arange(65, dtype=torch.int32)
    starts, count = tatt._ragged_plan(rid, pos, 64, 1024, 1)
    assert int(count[0]) == 2
    assert starts[:3].tolist() == [0, 33, 65]


# --------------------------------------------------------- conversions

def test_every_int8_code_is_exact_in_bf16_and_fp16():
    codes = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    want = codes.to(torch.float64)
    for dt in (torch.bfloat16, torch.float16):
        assert torch.equal(codes.to(dt).to(torch.float64), want)


def test_every_fp8_value_is_exact_in_bf16_and_fp16():
    bits = np.arange(256, dtype=np.uint8)
    vals = bits.view(ml_dtypes.float8_e4m3fn).astype(np.float64)
    finite = np.isfinite(vals)
    assert finite.sum() == 254          # 0x7f and 0xff are NaN
    f8 = torch.from_numpy(bits.copy()).view(torch.float8_e4m3fn)
    for dt in (torch.bfloat16, torch.float16):
        got = f8.to(dt).to(torch.float64).numpy()
        np.testing.assert_array_equal(got[finite], vals[finite])


def test_int8_to_fp32_bit_trick_is_exact():
    """The kernels' word_i8_f32: byte b of a word, XOR 0x80, placed in the
    low byte of 0x4B000000 and read as a float, minus 8388736."""
    codes = np.arange(-128, 128, dtype=np.int32)
    b = (codes & 0xFF).astype(np.uint32)
    f = ((b ^ 0x80) | 0x4B000000).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388736.0),
                                  codes.astype(np.float32))


# ------------------------------------------- the kernels' rounding, rendered

HEADS, HD, PS = 32, 128, 16


def _quant_pools(r, kind, kvh, num_pages):
    """Seeded fp32 values quantized by the port: (codes, scales) for K and
    V, as torch tensors."""
    spec = resolve_kv_dtype(kind)
    out = []
    for _ in range(2):
        x = torch.from_numpy(r.standard_normal(
            (kvh, num_pages, PS, HD)).astype(np.float32))
        out.extend(quantize_tokens(x, spec))
    return out                           # kq, ks, vq, vs


def _render(q, kq, ks, vq, vs, pt_rows, pos, rep, fp16_p):
    """The kernels' arithmetic for tokens (n,) with q (n, heads, hd) bf16,
    each over its own table row pt_rows (n, maxP) up to pos (n,): q and
    the codes in bf16, fp32 products and sums, logits x k_scale; p x
    v_scale as two fp16 terms (K7's tensor-core tiles) or kept in fp32 (the
    decode walk). Returns the fp32 output, before its rounding to bf16."""
    n = q.shape[0]
    kvh = kq.shape[0]
    length = pt_rows.shape[1] * PS

    def gather(pool, sc):
        g = pool[:, pt_rows].reshape(kvh, n, length, -1)
        return g, sc[:, pt_rows].reshape(kvh, n, length, 1)

    kg, ksg = gather(kq, ks)
    vg, vsg = gather(vq, vs)
    kb = kg.to(torch.bfloat16).to(torch.float32)       # exact
    vb = vg.to(torch.float16).to(torch.float32)        # exact
    qh = q.to(torch.float32).reshape(n, kvh, rep, HD).permute(1, 0, 2, 3)
    s = (qh @ kb.transpose(-1, -2)) * ksg.transpose(-1, -2) / math.sqrt(HD)
    allowed = torch.arange(length)[None, :] <= pos[:, None]
    s = torch.where(allowed[None, :, None], s, torch.tensor(-math.inf))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    vsr = vsg.transpose(-1, -2)                         # (kvh, n, 1, L)
    if fp16_p:
        # K7's tiles: p * v_scale over the 32-key tile's largest v_scale,
        # as the sum of two fp16 terms, times that largest scale
        vt = vsr.reshape(kvh, n, 1, length // 32, 32).amax(-1)
        vt = vt.repeat_interleave(32, -1)
        x = p * (vsr / vt)
        hi = x.to(torch.float16).to(torch.float32)
        lo = (x - hi).to(torch.float16).to(torch.float32)
        pv = (hi + lo) * vt
    else:
        pv = p * vsr
    out = (pv @ vb) / l.clamp_min(1e-30)
    return out.permute(1, 0, 2, 3).reshape(n, HEADS, HD)


def _flat(r, kind, rep):
    """LLaMA-width flat step cut in depth: 4 decode tokens over a capacity
    of 128 positions, a 40-token chunk at 64..103 (row 4), 4 parked."""
    kvh, maxp, nrows = HEADS // rep, 8, 5
    cap = maxp * PS
    num_pages = nrows * maxp + 1
    kq, ks, vq, vs = _quant_pools(r, kind, kvh, num_pages)
    pt = r.permutation(np.arange(1, num_pages))[:nrows * maxp].reshape(
        nrows, maxp).astype(np.int32)
    pos = np.full((48,), cap, np.int32)
    rid = np.zeros((48,), np.int32)
    pos[:4] = [0, 17, 64, cap - 1]
    rid[:4] = np.arange(4)
    pos[4:44] = np.arange(64, 104)
    rid[4:44] = 4
    q = r.standard_normal((1, 48, HEADS, HD)).astype(np.float32)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    return qb, (kq, ks, vq, vs), pt, pos, rid


def _numpy_pool(x):
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return x.numpy()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("rep", [1, 4])
def test_rendered_tile_rounding_within_a_third_of_k7q_limit(kind, rep):
    r = np.random.RandomState(31 + rep)
    qb, (kq, ks, vq, vs), pt, pos, rid = _flat(r, kind, rep)
    cache = PagedLayerCache(kq, vq, torch.from_numpy(pt),
                            torch.from_numpy(rid), k_scale=ks, v_scale=vs)
    posr = torch.from_numpy(pos)[None]
    live = pos < pt.shape[1] * PS
    sel = torch.from_numpy(live)
    pl = torch.from_numpy(pos[live]).long()
    rows = torch.from_numpy(pt[rid[live]]).long()
    chunk = torch.from_numpy(rid[live] == 4)
    assert bool(chunk.any()) and bool((~chunk).any())
    # the chunk's tokens take the tensor-core tiles, the decode tokens the
    # walk; both roundings are held on every token: before the output's
    # bf16 rounding against the plain version in fp32 within a third of
    # the limit, and rounded against the plain version on bf16 q (what the
    # card compares) within the limit, where one bf16 rounding of an
    # output of magnitude 2-4 (0.0156) would already fail
    want32 = tatt._ragged_attention_reference(qb.float(), cache, posr,
                                              rep)[0][sel]
    want16 = tatt._ragged_attention_reference(qb, cache, posr,
                                              rep)[0][sel].float()
    for fp16_p in (True, False):
        got = _render(qb[0][sel], kq, ks, vq, vs, rows, pl, rep, fp16_p)
        err = float((got - want32).abs().max())
        assert err <= RENDER_ATOL, err
        err = float((got.to(torch.bfloat16).float() - want16).abs().max())
        assert err <= 3 * RENDER_ATOL, err

    # the plain version against the JAX package's, on the same values
    jcache = JPagedLayerCache(
        jnp.asarray(_numpy_pool(kq)), jnp.asarray(_numpy_pool(vq)),
        jnp.asarray(pt), jnp.asarray(rid), k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()))
    q32 = qb.float()
    jref = satt._ragged_attention_reference(
        Tensor(jnp.asarray(q32.numpy())), jcache, jnp.asarray(pos)[None], rep)
    tref = tatt._ragged_attention_reference(
        q32, cache, torch.from_numpy(pos)[None], rep)
    np.testing.assert_allclose(tref.numpy()[0][live],
                               np.asarray(jref.numpy())[0][live], atol=ATOL)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_rendered_walk_rounding_within_a_third_of_k6q_limit(kind):
    """The decode shape cut in depth: b = 8 rows over a capacity of 256,
    positions 0, 15, 16, 17, 100, 200, 255 and a row parked at 256 (it
    attends every page)."""
    r = np.random.RandomState(41)
    b, maxp = 8, 16
    cap = maxp * PS
    num_pages = b * maxp + 1
    kq, ks, vq, vs = _quant_pools(r, kind, HEADS, num_pages)
    pt = r.permutation(np.arange(1, num_pages))[:b * maxp].reshape(
        b, maxp).astype(np.int32)
    pos = np.array([0, 15, 16, 17, 100, 200, cap - 1, cap], np.int32)
    q = torch.from_numpy(r.standard_normal((b, 1, HEADS, HD)).astype(
        np.float32)).to(torch.bfloat16)
    cache = PagedLayerCache(kq, vq, torch.from_numpy(pt), k_scale=ks,
                            v_scale=vs)
    posr = torch.from_numpy(pos)
    got = _render(q[:, 0], kq, ks, vq, vs, torch.from_numpy(pt).long(),
                  torch.from_numpy(np.minimum(pos, cap - 1)).long(), 1,
                  fp16_p=False)
    want32 = tatt._paged_decode_reference(q.float(), cache, posr, 1)[:, 0]
    err = float((got - want32).abs().max())
    assert err <= RENDER_ATOL, err
    want16 = tatt._paged_decode_reference(q, cache, posr, 1)[:, 0].float()
    err = float((got.to(torch.bfloat16).float() - want16).abs().max())
    assert err <= 3 * RENDER_ATOL, err

    jcache = JPagedLayerCache(
        jnp.asarray(_numpy_pool(kq)), jnp.asarray(_numpy_pool(vq)),
        jnp.asarray(pt), k_scale=jnp.asarray(ks.numpy()),
        v_scale=jnp.asarray(vs.numpy()))
    q32 = q.float()
    jref = satt._paged_decode_reference(
        Tensor(jnp.asarray(q32.numpy())), jcache, jnp.asarray(pos), 1)
    tref = tatt._paged_decode_reference(q32, cache, torch.from_numpy(pos), 1)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref.numpy()),
                               atol=ATOL)
