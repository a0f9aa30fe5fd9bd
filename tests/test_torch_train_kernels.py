"""The training path's kernels in paddle_tpu_torch, by their plain versions
on the CPU, against the JAX package on the same numpy inputs.

- K2 / K3 (flash backward, through `FlashAttention`): against `jax.vjp` of
  `_flash_attention_data(..., interpret=True)`, the Pallas kernels run in
  interpret mode as tests/test_pallas_flash.py drives them; K2's d(mask)
  for a trainable mask of every broadcast shape, causal and not, against
  the same with `mask_needs_grad`; d(mask) summed over batch groups (as the
  kernel writes its partials) against the whole-batch sum and the same
  reference, and `dmask_groups` at T5's shapes.
- K5 (norm backward, through `FusedNorm`): against `jax.vjp` of
  `_fused_norm_data(..., interpret=True)`.
- `fused_linear_cross_entropy` and `cross_entropy`: against the reference
  ops of paddle_tpu/ops/nn_ops.py.
- Attention dropout, on the port alone (its keep mask is a counter-based
  hash; the TPU's masks come from the TPU's generator and cannot match):
  keep rate, seeding, independence from tiling, and the FlashAttention
  gradients against autograd through materialized attention with the same
  explicit mask, in float64.

fp32 tolerances rtol 1e-4 / atol 1e-5 unless stated; JAX matmuls run at
"highest" precision (conftest).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops
from paddle_tpu.ops import pallas_kernels as pk

from paddle_tpu_torch.ops import cross_entropy as tce
from paddle_tpu_torch.ops import dropout_mask as tdm
from paddle_tpu_torch.ops import flash_attention as tflash
from paddle_tpu_torch.ops import norm as tnorm

RTOL, ATOL = 1e-4, 1e-5


def _vjp(f, args, ct):
    """f(*args) and the VJP of `ct`, jitted as one program (interpret-mode
    Pallas runs far faster traced once than op by op)."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        return out, vjp(ct)

    return jax.jit(run)(*args)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, grad=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.requires_grad_() if grad else t


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------- K2 / K3 flash backward

FLASH_CASES = {
    # name: (b, sq, sk, h, d, mask shape or None, causal)
    "no mask": (2, 40, 40, 2, 16, None, False),
    "padding mask (b,1,1,s)": (2, 48, 48, 2, 32, "b11k", False),
    "full mask (b,h,s,s)": (1, 32, 32, 2, 16, "bhqk", False),
    "causal": (1, 64, 64, 2, 64, None, True),
    "ragged S": (1, 37, 53, 3, 16, "b11k", False),
    # the Hopper kernels' tile edges (64 / 128 rows and keys), sk = 114 (a
    # 456-byte mask row), T5's cross shape, every mask pattern
    "one row": (1, 1, 1, 2, 16, None, False),
    "63 causal": (1, 63, 63, 2, 64, None, True),
    "65 padding mask": (2, 65, 65, 2, 32, "b11k", False),
    "127 full mask": (1, 127, 127, 2, 16, "bhqk", False),
    "129 causal padding mask": (1, 129, 129, 2, 16, "b11k", True),
    "200 causal": (1, 200, 200, 2, 16, None, True),
    "114 bias (1,h,q,k)": (2, 114, 114, 2, 16, "1hqk", False),
    "114 causal mask (1,1,q,k)": (2, 114, 114, 2, 16, "11qk", True),
    "cross 114 x 512": (1, 114, 512, 2, 16, None, False),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_backward_matches_pallas_vjp(case):
    b, sq, sk, h, d, mshape, causal = FLASH_CASES[case]
    r = np.random.RandomState(11)
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, sk, h, d)).astype(np.float32)
    v = r.standard_normal((b, sk, h, d)).astype(np.float32)
    dout = r.standard_normal((b, sq, h, d)).astype(np.float32)
    mask = None
    if mshape is not None:
        shape = {"b11k": (b, 1, 1, sk), "bhqk": (b, h, sq, sk),
                 "1hqk": (1, h, sq, sk), "11qk": (1, 1, sq, sk)}[mshape]
        mask = np.where(r.random_sample(shape) < 0.25, -1e4,
                        0.5 * r.standard_normal(shape)).astype(np.float32)

    def f(q_, k_, v_):
        return pk._flash_attention_data(
            q_, k_, v_, None if mask is None else jnp.asarray(mask),
            is_causal=causal, has_mask=mask is not None, interpret=True)

    ref_out, ref_grads = _vjp(f, (jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v)), jnp.asarray(dout))

    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    out = tflash.attention(qt, kt, vt, None if mask is None else _t(mask),
                           is_causal=causal)
    out.backward(_t(dout))
    _close(out.detach().numpy(), ref_out, msg="out")
    for name, got, ref in zip("qkv", (qt.grad, kt.grad, vt.grad),
                              ref_grads):
        _close(got.numpy(), ref, msg=f"d{name}")


def test_backward_wrappers_split_the_plain_version():
    """dq and (dk, dv) wrappers on CPU tensors: the parts of the one plain
    backward, with no launch counted."""
    r = np.random.RandomState(12)
    q, k, v, dout = (_t(r.standard_normal((1, 20, 2, 8)).astype(np.float32))
                     for _ in range(4))
    out, lse = tflash.flash_attention(q, k, v, return_lse=True)
    delta = tflash.attention_delta(out, dout)
    before = (tflash.flash_attention_dq.launches,
              tflash.flash_attention_dkv.launches)
    dq = tflash.flash_attention_dq(q, k, v, dout, lse, delta)
    dk, dv = tflash.flash_attention_dkv(q, k, v, dout, lse, delta)
    full = tflash.flash_attention_backward(q, k, v, out, lse, dout)
    for got, ref in zip((dq, dk, dv), full):
        assert torch.equal(got, ref)
    assert (tflash.flash_attention_dq.launches,
            tflash.flash_attention_dkv.launches) == before


# K2's d(mask) for a trainable mask: name -> (mask shape code, causal);
# ragged sq 37 against sk 53. The last case holds the float64 plain
# backward with dropout to autograd through materialized attention.
DMASK_CASES = {
    **{f"{shape}{' causal' if causal else ''}": (shape, causal)
       for shape in ("1hqk", "b11k", "bhqk", "11qk")
       for causal in (False, True)},
    "1hqk dropout 0.2, float64": ("1hqk", False),
}


def _mask_shape(code, b, h, sq, sk):
    return tuple({"b": b, "h": h, "q": sq, "k": sk, "1": 1}[c] for c in code)


@pytest.mark.parametrize("case", list(DMASK_CASES))
def test_trainable_mask_gradient(case):
    """FlashAttention gives a trainable mask its gradient (the plain K2's
    unrounded dS, summed over the mask's size-1 dims): against `jax.vjp`
    of the interpret-mode Pallas kernels with `mask_needs_grad`, and with
    dropout against autograd through materialized attention in float64.
    `flash_attention_backward(need_dmask=True)` gives the same gradients."""
    code, causal = DMASK_CASES[case]
    dropout = "dropout" in case
    b, sq, sk, h, d = (2, 24, 24, 2, 8) if dropout else (2, 37, 53, 3, 16)
    dt = np.float64 if dropout else np.float32
    r = np.random.RandomState(18)
    q = r.standard_normal((b, sq, h, d)).astype(dt)
    k = r.standard_normal((b, sk, h, d)).astype(dt)
    v = r.standard_normal((b, sk, h, d)).astype(dt)
    dout = r.standard_normal((b, sq, h, d)).astype(dt)
    mask = (0.5 * r.standard_normal(_mask_shape(code, b, h, sq, sk))
            ).astype(dt)
    p, seed = (0.2, _seed(4321)) if dropout else (0.0, None)

    qt, kt, vt, mt = (_t(x, True) for x in (q, k, v, mask))
    out = tflash.attention(qt, kt, vt, mt, is_causal=causal, dropout_p=p,
                           seed=seed)
    out.backward(_t(dout))
    assert mt.grad.shape == mask.shape and mt.grad.dtype == mt.dtype

    if dropout:
        qb, kb, vb, mb = (_t(x, True) for x in (q, k, v, mask))
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / math.sqrt(d) + mb
        keep = tdm.keep_mask(seed, b, h, sq, sk, p)
        probs = torch.where(keep, torch.softmax(logits, -1) / (1 - p), 0.0)
        torch.einsum("bhqk,bkhd->bqhd", probs, vb).backward(_t(dout))
        np.testing.assert_allclose(mt.grad.numpy(), mb.grad.numpy(),
                                   rtol=1e-9, atol=1e-11)
        for got, want in ((qt, qb), (kt, kb), (vt, vb)):
            np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                       rtol=1e-9, atol=1e-11)
    else:
        def f(q_, k_, v_, m_):
            return pk._flash_attention_data(
                q_, k_, v_, m_, is_causal=causal, has_mask=True,
                mask_needs_grad=True, interpret=True)

        _, ref = _vjp(f, tuple(jnp.asarray(x) for x in (q, k, v, mask)),
                      jnp.asarray(dout))
        for name, got, want in zip(("dq", "dk", "dv", "dmask"),
                                   (qt.grad, kt.grad, vt.grad, mt.grad), ref):
            _close(got.numpy(), want, msg=name)

    out2, lse = tflash.flash_attention(_t(q), _t(k), _t(v), _t(mask), causal,
                                       True, p, seed)
    grads = tflash.flash_attention_backward(
        _t(q), _t(k), _t(v), out2, lse, _t(dout), _t(mask), causal, p, seed,
        need_dmask=True)
    for got, want in zip(grads, (qt.grad, kt.grad, vt.grad, mt.grad)):
        assert torch.equal(got, want)


# K2's batch-grouped d(mask): every mask pattern of DMASK_CASES (dropout
# off) at batch 1, 3 and 5. A mask with batch 1 is summed over 2 groups
# (ragged at 3 and 5: entries {0, 1} {2}, {0, 1, 2} {3, 4}); one with its own
# batch dim keeps a group an entry.
GROUPED_CASES = [(case, b) for case in DMASK_CASES if "dropout" not in case
                 for b in (1, 3, 5)]


@pytest.mark.parametrize("case,b", GROUPED_CASES,
                         ids=[f"{c} b{b}" for c, b in GROUPED_CASES])
def test_grouped_dmask_matches_full_and_pallas(case, b):
    """The plain K2's d(mask) summed over batch groups (as the kernel
    writes its partials) against the same summed over the whole batch at
    once, and against `jax.vjp` of the interpret-mode Pallas kernels with
    `mask_needs_grad`; dQ alongside."""
    code, causal = DMASK_CASES[case]
    sq, sk, h, d = 24, 40, 2, 8
    r = np.random.RandomState(19)
    q, dout = (r.standard_normal((b, sq, h, d)).astype(np.float32)
               for _ in range(2))
    k, v = (r.standard_normal((b, sk, h, d)).astype(np.float32)
            for _ in range(2))
    mask = (0.5 * r.standard_normal(_mask_shape(code, b, h, sq, sk))
            ).astype(np.float32)
    groups = 2 if mask.shape[0] == 1 and b > 1 else b

    out, lse = tflash.flash_attention(_t(q), _t(k), _t(v), _t(mask), causal,
                                      True)
    delta = tflash.attention_delta(out, _t(dout))
    args = (_t(q), _t(k), _t(v), _t(dout), lse, delta, _t(mask), causal)
    dq, _, _, grouped = tflash.flash_attention_backward_reference(
        *args, need_dkv=False, need_dmask=True, groups=groups)
    _, _, _, whole = tflash.flash_attention_backward_reference(
        *args, need_dq=False, need_dkv=False, need_dmask=True, groups=b)
    assert grouped.shape == mask.shape
    _close(grouped.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7,
           msg="grouped vs whole-batch sum")

    def f(q_, k_, v_, m_):
        return pk._flash_attention_data(
            q_, k_, v_, m_, is_causal=causal, has_mask=True,
            mask_needs_grad=True, interpret=True)

    _, ref = _vjp(f, tuple(jnp.asarray(x) for x in (q, k, v, mask)),
                  jnp.asarray(dout))
    _close(dq.numpy(), ref[0], msg="dq")
    _close(grouped.numpy(), ref[3], msg="dmask")


def test_dmask_partials_sum_consecutive_entries_in_order():
    """Groups of ceil(b / groups) consecutive entries, the last ragged."""
    full = torch.from_numpy(np.random.RandomState(20).standard_normal(
        (5, 2, 3, 4)).astype(np.float32))
    parts = tflash.dmask_partials(full, 2)
    assert torch.equal(parts[0], full[0] + full[1] + full[2])
    assert torch.equal(parts[1], full[3] + full[4])
    assert tflash.dmask_partials(full, 5) is full
    assert tflash.dmask_partials(full, 4).shape[0] == 3   # no empty group


# T5-base's attention shapes with the trainable (1, 12, q, k) bias, batch 32
T5_DMASK_SHAPES = {"encoder": (32, 12, 512, 512), "decoder": (32, 12, 114, 114)}


@pytest.mark.parametrize("name", list(T5_DMASK_SHAPES))
def test_dmask_groups_at_t5_shapes(name):
    """At most 8 groups, so the partials stay within 8 x h x sq x sk fp32
    (at the encoder 100.7 MB instead of the whole 402.7 MB dS). The
    encoder's grid (48 blocks a group) fills the 132 SMs; the decoder's (12
    blocks a group) cannot with 8 groups or fewer and takes all 8."""
    b, h, sq, sk = T5_DMASK_SHAPES[name]
    groups = tflash.dmask_groups(b, h, sq, (1, h, sq, sk))
    blocks = -(-sq // 128) * h * groups
    assert 1 <= groups <= 8
    assert groups * h * sq * sk * 4 <= 8 * h * sq * sk * 4
    assert b % groups == 0                      # no ragged group at b 32
    if name == "encoder":
        assert blocks >= 132
        assert groups * h * sq * sk * 4 <= 100.7e6
    else:
        assert groups == 8 and blocks == 96


@pytest.mark.parametrize("code", ["bhqk", "b11k"])
def test_dmask_groups_of_a_mask_with_its_own_batch_dim(code):
    b, h, sq, sk = 32, 12, 512, 512
    shape = _mask_shape(code, b, h, sq, sk)
    assert tflash.dmask_groups(b, h, sq, shape) == b
    r = np.random.RandomState(21)
    q, k, v, dout = (_t(r.standard_normal((2, 8, 2, 4)).astype(np.float32))
                     for _ in range(4))
    mask = _t(r.standard_normal(_mask_shape(code, 2, 2, 8, 8))
              .astype(np.float32))
    out, lse = tflash.flash_attention(q, k, v, mask, return_lse=True)
    with pytest.raises(ValueError, match="batch groups"):
        tflash.flash_attention_backward_reference(
            q, k, v, dout, lse, tflash.attention_delta(out, dout), mask,
            need_dmask=True, groups=1)


# -------------------------------------------------------- K5 norm backward

@pytest.mark.parametrize("mode", ["rms", "layer", "layer no bias"])
def test_norm_backward_matches_pallas_vjp(mode):
    r = np.random.RandomState(13)
    x = (r.standard_normal((3, 7, 256)) * 1.5 + 0.3).astype(np.float32)
    w = (r.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
    b = (r.standard_normal(256) * 0.1).astype(np.float32)
    dy = r.standard_normal((3, 7, 256)).astype(np.float32)
    sub = mode != "rms"
    with_bias = mode == "layer"
    eps = 1e-5

    def f(x_, w_, b_):
        return pk._fused_norm_data(x_, w_, b_ if with_bias else None, eps,
                                   subtract_mean=sub, interpret=True)

    ref_y, (rdx, rdw, rdb) = _vjp(f, (jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b)), jnp.asarray(dy))

    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    if sub:
        y = tnorm.layer_norm(xt, wt, bt if with_bias else None, eps)
    else:
        y = tnorm.rms_norm(xt, wt, eps)
    y.backward(_t(dy))
    _close(y.detach().numpy(), ref_y, msg="y")
    _close(xt.grad.numpy(), rdx, msg="dx")
    _close(wt.grad.numpy(), rdw, msg="dw")
    if with_bias:
        _close(bt.grad.numpy(), rdb, msg="db")
    else:
        assert bt.grad is None


def test_norm_backward_plain_matches_autograd():
    """The plain K5 formula against autograd through F.layer_norm."""
    r = np.random.RandomState(14)
    x = _t(r.standard_normal((5, 96)).astype(np.float32), True)
    w = _t((r.standard_normal(96) * 0.2 + 1.0).astype(np.float32))
    dy = _t(r.standard_normal((5, 96)).astype(np.float32))
    _, mean, rstd = tnorm.norm_forward(x.detach(), w, None, 1e-6, True)
    torch.nn.functional.layer_norm(x, (96,), w, None, 1e-6).backward(dy)
    dx = tnorm.norm_backward_reference(x.detach(), w, dy, mean, rstd, True)
    _close(dx.numpy(), x.grad.numpy())


def test_norm_cpu_tensor_never_counts_a_launch():
    x = torch.randn(4, 128, requires_grad=True)
    before = (tnorm.norm_forward.launches, tnorm.norm_backward.launches)
    tnorm.layer_norm(x, torch.ones(128), torch.zeros(128)).sum().backward()
    assert (tnorm.norm_forward.launches,
            tnorm.norm_backward.launches) == before


# -------------------------------------------- fused linear cross-entropy

@pytest.mark.parametrize("transpose_y", [True, False])
def test_fused_linear_cross_entropy_matches_reference(transpose_y):
    """A ragged final chunk (45 rows in chunks of 16) and ignore_index
    rows: loss and the gradients of x, w and b."""
    r = np.random.RandomState(15)
    n, hdim, vocab = 45, 24, 70
    x = r.standard_normal((n, hdim)).astype(np.float32)
    wshape = (vocab, hdim) if transpose_y else (hdim, vocab)
    w = (r.standard_normal(wshape) * 0.3).astype(np.float32)
    b = (r.standard_normal(vocab) * 0.1).astype(np.float32)
    lbl = r.randint(0, vocab, n).astype(np.int64)
    lbl[[3, 17, 44]] = -100

    def f(x_, w_, b_):
        return nn_ops.fused_linear_cross_entropy(
            x_, w_, b_, jnp.asarray(lbl), ignore_index=-100,
            transpose_y=transpose_y, chunk_size=16)

    ref_loss, ref_grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    loss = tce.fused_linear_cross_entropy(xt, wt, bt, _t(lbl),
                                          ignore_index=-100,
                                          transpose_y=transpose_y,
                                          chunk_size=16)
    loss.backward()
    _close(loss.item(), float(ref_loss), msg="loss")
    for name, got, ref in zip(("dx", "dw", "db"),
                              (xt.grad, wt.grad, bt.grad), ref_grads):
        _close(got.numpy(), ref, msg=name)
    # the unchunked plain cross-entropy gives the same loss
    logits = (xt @ (wt.t() if transpose_y else wt)) + bt
    _close(tce.cross_entropy(logits, _t(lbl)).item(), float(ref_loss))


@pytest.mark.parametrize("transpose_y", [True, False])
def test_fused_head_under_o1_sums_its_products_in_fp32(transpose_y):
    """bf16 x and w, as O1 gives them the head: the logits and each chunk's
    dW are fp32 sums of the bf16 products, dW added over the 8 chunks in
    fp32 and rounded to bf16 once, as the reference's (nn_ops.py:493-494,
    546-553). dW and dx within 2e-4 relative L2 of the reference's; bf16
    products rounded per chunk read ~2.7e-3 for dW and ~4.9e-4 for dx."""
    import jax.numpy as jnp

    r = np.random.RandomState(17)
    n, hdim, vocab, chunk = 1024, 64, 1024, 128
    x = r.standard_normal((n, hdim)).astype(np.float32)
    wshape = (vocab, hdim) if transpose_y else (hdim, vocab)
    w = (r.standard_normal(wshape) * 0.05).astype(np.float32)
    b = np.zeros(vocab, np.float32)
    lbl = r.randint(0, vocab, n).astype(np.int64)

    def f(x_, w_):
        return nn_ops.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(b), jnp.asarray(lbl),
            transpose_y=transpose_y, chunk_size=chunk)

    ref_loss, (ref_dx, ref_dw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    loss = tce.fused_linear_cross_entropy(
        xt, wt, torch.from_numpy(b), _t(lbl), transpose_y=transpose_y,
        chunk_size=chunk)
    loss.backward()
    assert wt.grad.dtype == xt.grad.dtype == torch.bfloat16
    _close(loss.item(), float(ref_loss), rtol=1e-5, msg="loss")
    for name, got, ref in (("dw", wt.grad, ref_dw), ("dx", xt.grad, ref_dx)):
        ref = np.asarray(ref.astype(jnp.float32))
        rel = np.linalg.norm(got.float().numpy() - ref) / np.linalg.norm(ref)
        assert rel < 2e-4, (name, rel)


def test_cross_entropy_matches_reference():
    r = np.random.RandomState(16)
    logits = r.standard_normal((3, 5, 11)).astype(np.float32)
    lbl = r.randint(0, 11, (3, 5)).astype(np.int64)
    lbl[1, 2] = -100
    for reduction in ("mean", "sum", "none"):
        ref = nn_ops.cross_entropy(jnp.asarray(logits), jnp.asarray(lbl),
                                   reduction=reduction)
        got = tce.cross_entropy(_t(logits), _t(lbl), reduction=reduction)
        _close(got.numpy(), ref, msg=reduction)


# ------------------------------------------------------- attention dropout

def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def test_keep_rate_within_four_sigma():
    p = 0.1
    keep = tdm.keep_mask(_seed(3), 2, 3, 128, 128, p)
    n = keep.numel()
    kept = int(keep.sum())
    sigma = math.sqrt(n * p * (1 - p))
    assert abs(kept - n * (1 - p)) <= 4 * sigma, (kept, n)


def test_same_seed_same_mask_other_seed_other_mask():
    a = tdm.keep_mask(_seed(7), 2, 2, 40, 40, 0.1)
    b = tdm.keep_mask(_seed(7), 2, 2, 40, 40, 0.1)
    c = tdm.keep_mask(_seed(8), 2, 2, 40, 40, 0.1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # every (batch, head) draws its own pattern
    assert not torch.equal(a[0, 0], a[0, 1])
    assert not torch.equal(a[0, 0], a[1, 0])


@pytest.mark.parametrize("tile", [(64, 32), (48, 40), (7, 128)])
def test_mask_does_not_depend_on_tiles(tile):
    """A mask assembled tile by tile from each tile's absolute coordinates
    equals the mask drawn whole: the kernels' tilings (64 x 32 in the FMA
    path, 64 x 64 in the tensor-core path) draw the same bits."""
    seed, sq, sk = _seed(99), 100, 130
    whole = tdm.keep_mask(seed, 2, 3, sq, sk, 0.25)
    tq, tk = tile
    tiled = torch.empty_like(whole)
    for q0 in range(0, sq, tq):
        for k0 in range(0, sk, tk):
            rows = torch.arange(q0, min(q0 + tq, sq))
            cols = torch.arange(k0, min(k0 + tk, sk))
            tiled[:, :, q0:q0 + tq, k0:k0 + tk] = tdm.keep_mask(
                seed, 2, 3, rows, cols, 0.25)
    assert torch.equal(whole, tiled)


def test_threshold_is_the_tpu_rule():
    assert tdm.threshold(0.1) == int(0.1 * 2 ** 32)
    assert tdm.threshold(1.0) == 2 ** 32 - 1
    assert tdm.threshold(0.0) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_dropout_gradients_match_materialized_attention_fp64(masked):
    """FlashAttention (plain forward and backward on CPU) with dropout 0.2
    against autograd through materialized softmax attention that applies
    the same explicit keep mask, in float64."""
    r = np.random.RandomState(17)
    b, s, h, d, p = 2, 24, 2, 8, 0.2
    q, k, v, dout = (r.standard_normal((b, s, h, d)) for _ in range(4))
    mask = (np.where(r.random_sample((b, 1, 1, s)) < 0.2, -1e4, 0.0)
            if masked else None)
    seed = _seed(1234)

    qa, ka, va = _t(q, True), _t(k, True), _t(v, True)
    out = tflash.attention(qa, ka, va, None if mask is None else _t(mask),
                           dropout_p=p, seed=seed)
    out.backward(_t(dout))

    qb, kb, vb = _t(q, True), _t(k, True), _t(v, True)
    logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / math.sqrt(d)
    if mask is not None:
        logits = logits + _t(mask)
    probs = torch.softmax(logits, dim=-1)
    keep = tdm.keep_mask(seed, b, h, s, s, p)
    dropped = torch.where(keep, probs / (1 - p), 0.0)
    ref = torch.einsum("bhqk,bkhd->bqhd", dropped, vb)
    ref.backward(_t(dout))

    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-10, atol=1e-12)
    for got, want in ((qa, qb), (ka, kb), (va, vb)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   rtol=1e-9, atol=1e-11)
    # dropout really dropped: without it the output differs
    plain = tflash.attention(_t(q), _t(k), _t(v),
                             None if mask is None else _t(mask))
    assert not np.allclose(plain.numpy(), ref.detach().numpy())


def test_dropout_needs_a_seed_on_the_card():
    """The CUDA wrapper refuses dropout without a seed before any launch
    (checked without a card: the argument check precedes the device)."""
    with pytest.raises(ValueError, match="seed"):
        tflash._dropout_args(0.1, None, torch.zeros(1))
