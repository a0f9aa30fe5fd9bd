"""The ring form of the flash kernels (K1r, K2r, K3r) and ring / Ulysses
attention in paddle_tpu_torch, on the CPU, against the JAX package on the
same numpy inputs.

- K1r / K2r / K3r by their plain versions (`flash_attention`,
  `flash_attention_dq`, `flash_attention_dkv` with `offsets=`, K1r with
  `keep_neg_inf_lse=True`) against the TPU kernels `_fwd_call`,
  `_bwd_dq_call` and `_bwd_dkv_call` with `offs=` (and
  `keep_neg_inf_lse=True`) in interpret mode, at one ring step's offsets:
  the diagonal, a past block, a future block (out 0, lse -inf, zero
  gradients), an unaligned shift and a ragged shard; fp32 and bf16. The
  backward kernels get the same lse (-inf set to 0) and delta on both
  sides.
- `ring_flash_attention` and `ulysses_attention` over 4 gloo processes
  (`distributed.spawn`; one world runs every case, a module-scoped
  fixture) against the JAX package's over 4 of conftest's fake devices
  inside shard_map (`impl="pallas", interpret=True`, the shapes of
  tests/test_ring_pallas.py): the output and the gradients of sum(out *
  w), causal and not, fp32 and bf16.
- With one rank both equal `flash_attention`; `ring_merge` weighs an lse
  of -inf at zero; CPU tensors launch no kernel.

Tolerances as tests/test_ring_pallas.py: fp32 outputs rtol 2e-4 / atol
2e-5, fp32 gradients rtol 2e-3 / atol 2e-4, bf16 5e-2.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ring_attention as ra)
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import ring_flash

SEP = 4
TOL = {"float32": {"out": (2e-4, 2e-5), "grad": (2e-3, 2e-4)},
       "bfloat16": {"out": (5e-2, 5e-2), "grad": (5e-2, 5e-2)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


def _close(got, ref, dtype, kind, msg=""):
    rtol, atol = TOL[dtype][kind]
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


# ------------------------------------------ K1r / K2r / K3r, one ring step

# name: (shard length s, (q_off, k_off)); 64 rows pad to one 128 block in
# the TPU kernels, 37 leaves a ragged block
STEPS = {"diagonal": (64, (64, 64)), "past": (64, (128, 64)),
         "future": (64, (0, 64)), "unaligned": (64, (64 + 13, 64)),
         "ragged": (37, (2 * 37 + 5, 37)),
         # the Hopper kernels' tile edges (64 / 128 rows and keys), with
         # the ring's offsets: aligned, unaligned by 37, past and future
         "one row": (1, (1, 1)), "63 diagonal": (63, (63, 63)),
         "65 unaligned": (65, (65 + 37, 65)), "127 past": (127, (254, 127)),
         "129 future": (129, (0, 129)),
         "200 unaligned": (200, (200 + 37, 200))}


def _future(step):
    """Whether every key of the step lies after every query."""
    s, (q_off, k_off) = STEPS[step]
    return q_off + s - 1 < k_off
B, H, D = 1, 2, 16


def _step_inputs(s):
    r = np.random.RandomState(s)
    return tuple(r.standard_normal((B, s, H, D)).astype(np.float32)
                 for _ in range(4))


@functools.lru_cache(maxsize=None)
def _jax_step(step, dtype):
    """(out, lse, lse0, delta, dq, dk, dv) of the TPU kernels at one ring
    step, (b, s, h, d) / (b, h, s), float32 numpy; the backward from lse0
    (lse with -inf set to 0) and delta = rowsum(dout * out)."""
    import jax.numpy as jnp

    from paddle_tpu.ops import pallas_kernels as pk

    s, offs = STEPS[step]
    q, k, v, dout = _step_inputs(s)
    jdt = getattr(jnp, dtype)
    block = pk._pick_block(s, pk._BLOCK_Q)
    S = pk._round_up(s, block)
    d_p = pk._round_up(D, 128)

    def prep(x):
        x = np.pad(x.transpose(0, 2, 1, 3),
                   ((0, 0), (0, 0), (0, S - s), (0, d_p - D)))
        return jnp.asarray(x, jdt)

    qt, kt, vt, dot = (prep(x) for x in (q, k, v, dout))
    kw = dict(scale=D ** -0.5, sk=s, is_causal=True, has_mask=False,
              mask_b_is_one=True, mask_h_is_one=True, mask_q_is_one=True,
              block_q=block, block_k=block, dropout_p=0.0, interpret=True)
    mask = jnp.zeros((1, 1, 1, 1), jnp.float32)
    seed = jnp.zeros((1,), jnp.int32)
    o = jnp.asarray(offs, jnp.int32)
    out, lse = pk._fwd_call(qt, kt, vt, mask, seed, offs=o,
                            keep_neg_inf_lse=True, **kw)
    out_f = np.asarray(out, np.float32)[:, :, :s, :D]
    lse = np.asarray(lse)[:, :, 0, :s]
    lse0 = np.where(np.isfinite(lse), lse, 0.0).astype(np.float32)
    delta = np.sum(dout.transpose(0, 2, 1, 3).astype(np.float32)
                   * out_f, axis=-1)

    def rows(x):
        x = np.pad(x, ((0, 0), (0, 0), (0, S - s)))
        return jnp.asarray(np.broadcast_to(x[:, :, None, :], (B, H, 8, S)))

    dq, _ = pk._bwd_dq_call(qt, kt, vt, mask, seed, dot, rows(lse0),
                            rows(delta), want_dmask=False, offs=o, **kw)
    dk, dv = pk._bwd_dkv_call(qt, kt, vt, mask, seed, dot, rows(lse0),
                              rows(delta), offs=o, **kw)

    def back(x, n):
        return np.asarray(x, np.float32)[:, :, :n, :D].transpose(0, 2, 1, 3)

    return (out_f.transpose(0, 2, 1, 3), lse, lse0, delta, back(dq, s),
            back(dk, s), back(dv, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", list(STEPS))
def test_k1r_plain_version_matches_the_tpu_kernel(step, dtype):
    s, offs = STEPS[step]
    q, k, v, _ = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in _step_inputs(s))
    out, lse = tflash.flash_attention(q, k, v, is_causal=True,
                                      return_lse=True, offsets=offs,
                                      keep_neg_inf_lse=True)
    ref_out, ref_lse = _jax_step(step, dtype)[:2]
    _close(out, ref_out, dtype, "out", "out")
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(ref_lse))
    _close(lse, ref_lse, dtype, "out", "lse")
    if _future(step):
        assert not out.any() and bool(torch.isneginf(lse).all())
    else:
        assert bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", list(STEPS))
def test_k2r_k3r_plain_versions_match_the_tpu_kernels(step, dtype):
    s, offs = STEPS[step]
    tdt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(x).to(tdt) for x in _step_inputs(s))
    _, _, lse0, delta, rdq, rdk, rdv = _jax_step(step, dtype)
    args = (q, k, v, dout, torch.from_numpy(lse0), torch.from_numpy(delta))
    dq = tflash.flash_attention_dq(*args, is_causal=True, offsets=offs)
    dk, dv = tflash.flash_attention_dkv(*args, is_causal=True, offsets=offs)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk),
                           ("dv", dv, rdv)):
        assert got.dtype == tdt
        _close(got, ref, dtype, "grad", name)
    if _future(step):
        assert not (dq.any() or dk.any() or dv.any())


def test_equal_offsets_are_the_single_call_kernels():
    q, k, v, dout = (torch.from_numpy(x) for x in _step_inputs(64))
    out, lse = tflash.flash_attention(q, k, v, is_causal=True,
                                      return_lse=True)
    out_r, lse_r = tflash.flash_attention(q, k, v, is_causal=True,
                                          return_lse=True, offsets=(7, 7))
    assert torch.equal(out, out_r) and torch.equal(lse, lse_r)
    delta = tflash.attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta)
    assert torch.equal(tflash.flash_attention_dq(*args, is_causal=True),
                       tflash.flash_attention_dq(*args, is_causal=True,
                                                 offsets=(7, 7)))


def test_ring_merge_weighs_an_empty_partial_at_zero():
    r = np.random.RandomState(3)
    o_acc = torch.from_numpy(r.standard_normal((1, 5, 2, 4)).astype(
        np.float32))
    lse_acc = torch.from_numpy(r.standard_normal((1, 2, 5)).astype(
        np.float32))
    lse_acc[0, 1, 2] = float("-inf")
    o_s = torch.from_numpy(r.standard_normal((1, 5, 2, 4)).astype(
        np.float32))
    lse_s = torch.full((1, 2, 5), float("-inf"))
    o, lse = ring_flash.ring_merge(o_acc, lse_acc, o_s, lse_s)
    assert torch.equal(lse, lse_acc)
    keep = torch.isfinite(lse_acc).transpose(1, 2)[..., None]
    assert torch.equal(o, torch.where(keep, o_acc, 0.0))
    # two halves of one row's keys merge to the whole row's attention
    q, k, v, _ = (torch.from_numpy(x) for x in _step_inputs(64))
    whole = tflash.flash_attention(q, k, v, return_lse=True)
    parts = [tflash.flash_attention(q, k[:, i:i + 32], v[:, i:i + 32],
                                    return_lse=True) for i in (0, 32)]
    acc = (torch.zeros(q.shape), torch.full((1, H, 64), float("-inf")))
    for p in parts:
        acc = ring_flash.ring_merge(*acc, *p)
    np.testing.assert_allclose(acc[0].numpy(), whole[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(acc[1].numpy(), whole[1].numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------ ring and Ulysses over 4 ranks

CASES = {f"{mode} {'causal' if causal else 'full'} {dtype}":
         (mode, causal, dtype)
         for mode in ("ring", "ulysses") for causal in (False, True)
         for dtype in ("float32", "bfloat16")}


def _case_inputs(mode):
    """(q, k, v, w), (b, h, s, d) float32: test_ring_pallas.py's shapes,
    s = 32 (8 a rank), 2 heads for the ring, 4 for Ulysses."""
    r = np.random.RandomState(0 if mode == "ring" else 1)
    h = 2 if mode == "ring" else 4
    return tuple(r.standard_normal((1, h, 32, 16)).astype(np.float32)
                 for _ in range(4))


@pytest.fixture(scope="module")
def world():
    """Each case's (out, dq, dk, dv), the ranks' shards joined along the
    sequence, from one world of 4 gloo ranks."""
    cases = {name: (mode, causal, dtype, *_case_inputs(mode))
             for name, (mode, causal, dtype) in CASES.items()}
    per_rank = ptd.spawn(ranks.sequence_parallel, (cases,), nprocs=SEP,
                         device="cpu", timeout=180)
    return {name: tuple(np.concatenate([r[name][i] for r in per_rank],
                                       axis=2) for i in range(4))
            for name in CASES}


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(out, dq, dk, dv) of the JAX package's ring / Ulysses over 4 fake
    devices, the gradients those of sum(out * w), float32 numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.distributed.fleet.meta_parallel import (
        ring_attention as jra)

    mode, causal, dtype = CASES[name]
    q, k, v, w = _case_inputs(mode)
    fn = (jra.ring_flash_attention if mode == "ring"
          else jra.ulysses_attention)
    mesh = Mesh(np.asarray(jax.devices()[:SEP]), ("sep",))
    spec = P(None, None, "sep", None)
    kw = dict(mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    # interpret-mode Pallas inside shard_map needs the replication checker
    # off, spelled check_vma on jax >= 0.5 and check_rep on 0.4.x (as
    # tests/test_ring_pallas.py does)
    sm = getattr(jax, "shard_map", None)
    if sm is not None:
        kw["check_vma"] = False
    else:
        from jax.experimental.shard_map import shard_map as sm
        kw["check_rep"] = False
    f = sm(lambda a, b, c: fn(a, b, c, axis_name="sep", causal=causal,
                              impl="pallas", interpret=True), **kw)
    jdt = getattr(jnp, dtype)

    def fwd_bwd(q, k, v, w):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(w.astype(out.dtype))

    res = jax.jit(fwd_bwd)(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                           jnp.asarray(w))
    return tuple(np.asarray(x, np.float32) for x in res)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_over_four_ranks(world, name):
    _close(world[name][0], _jax_case(name)[0], CASES[name][2], "out")


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_over_four_ranks(world, name):
    for label, got, ref in zip(("dq", "dk", "dv"), world[name][1:],
                               _jax_case(name)[1:]):
        _close(got, ref, CASES[name][2], "grad", label)


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_one_rank_is_flash_attention(mode):
    """Without a process group the world is one rank: the local
    attention, `flash_attention` on the (b, s, h, d) layout, its gradient
    too; CPU tensors launch no kernel."""
    q, k, v, w = (torch.from_numpy(x) for x in _case_inputs(mode))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    fn = ra.ring_flash_attention if mode == "ring" else ra.ulysses_attention
    before = (tflash.flash_attention.launches,
              tflash.flash_attention.ring_launches)
    out = fn(qg, kg, vg, causal=True)
    (out * w).sum().backward()
    assert (tflash.flash_attention.launches,
            tflash.flash_attention.ring_launches) == before
    ref = tflash.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                                 is_causal=True).transpose(1, 2)
    assert torch.equal(out.detach(), ref)
    assert qg.grad is not None and bool(torch.isfinite(qg.grad).all())


def test_ulysses_needs_the_heads_to_divide_over_the_ranks():
    g = ptd.Group(0, range(SEP))
    x = torch.zeros(1, 6, 8, 4)
    with pytest.raises(ValueError, match="6 heads do not divide over 4"):
        ra.ulysses_attention(x, x, x, group=g)


def test_ring_flash_attention_layer_selects_the_mode():
    assert ra.RingFlashAttention("ulysses").mode == "ulysses"
    with pytest.raises(ValueError, match="ring' or 'ulysses"):
        ra.RingFlashAttention("zigzag")
