"""The nn ops of the port's op table (`paddle_tpu_torch.ops.nn_ops`)
against the JAX registry's `paddle_tpu/ops/nn_ops.py`, op by op, on the
CPU.

Each of the 72 ops has the reference's declaration (amp list, method,
multi_output, inplace_view, eager_only). Each one but `dropout` runs on
the first input case `tests/test_op_harness.py` gives it (imported, not
edited) through the port's dispatch on Paddle Tensors and through the
reference's `get_op(name).fn`, the references jitted as one program.
Forward outputs agree within rtol 1e-4 / atol 1e-5 (integer outputs
exactly); where the first output is real floating, the vector-Jacobian
product of a seeded cotangent with respect to every real floating input
agrees within rtol 1e-3 / atol 1e-4 (torch autograd against `jax.vjp`),
except for the ops of `NO_VJP`, each with its reason. `dropout` takes a
key the port cannot share, so its keep rate and scaling are checked
instead. Under `auto_cast` O1 each op with an `amp:` list gives its
outputs the reference's types.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.amp as jamp
from paddle_tpu.ops.registry import get_op as jax_op
from paddle_tpu_torch import amp
from paddle_tpu_torch.core.dispatch import apply_op
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import OPS, get_op
from test_torch_ops import (CASES, FWD_TOL, NN_OPS, VJP_TOL, _SPECS, _close,
                            _cotangent, _inputs, _is_real_float)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ops whose VJPs are not compared, and why
NO_VJP = {
    # the outputs are indices / a permutation, the values' VJP is checked
    # through max_pool2d
    "max_pool2d_with_index": "the argmax indices",
    # lax.reduce_window's max VJP and PyTorch's agree on distinct values
    # only; the harness's adaptive windows overlap, so ties are routine
    "adaptive_max_pool2d": "overlapping windows tie",
}

_CASED = [n for n in NN_OPS if n != "dropout"]


def _reference_fn(name, arrs, kw):
    fn = jax_op(name).fn
    fl = [i for i, a in enumerate(arrs) if _is_real_float(a)]

    def run(*xs):
        def outputs(*f):
            full = list(xs)
            for i, v in zip(fl, f):
                full[i] = v
            o = fn(*full, **kw)
            o = list(o) if isinstance(o, (tuple, list)) else [o]
            return o[0], o

        if name in NO_VJP or not fl:
            return outputs()[1], None
        first, vjp, outs = jax.vjp(outputs, *[xs[i] for i in fl],
                                   has_aux=True)
        if not jnp.issubdtype(first.dtype, jnp.floating):
            return outs, None
        ct = jnp.asarray(_cotangent(name, first.shape))
        return outs, list(vjp(ct))

    return run


@functools.lru_cache(maxsize=None)
def _references():
    """Every cased op's reference, jitted as one program."""
    data = {n: [jnp.asarray(a) for a in _inputs(n)[0]] for n in _CASED}

    def all_ops(d):
        return {n: _reference_fn(n, *_inputs(n))(*d[n]) for n in _CASED}

    return jax.device_get(jax.jit(all_ops)(data))


def _port(name, arrs, kw):
    ts = [Tensor(a, place="cpu", stop_gradient=not _is_real_float(a))
          for a in arrs]
    out = apply_op(get_op(name), *ts, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    fl = [t for t in ts if not t.stop_gradient]
    first = outs[0]
    if name in NO_VJP or not fl or not first._t.is_floating_point():
        return outs, None
    ct = torch.from_numpy(_cotangent(name, tuple(first.shape)))
    grads = torch.autograd.grad(first._t, [t._t for t in fl], ct,
                                allow_unused=True)
    return outs, [torch.zeros_like(t._t) if g is None else g
                  for g, t in zip(grads, fl)]


def test_every_nn_op_is_ported_with_its_declaration():
    assert len(NN_OPS) == 72 and set(NN_OPS) <= set(OPS)
    assert set(_CASED) <= set(CASES)
    by_name = {s["op"]: s for s in _SPECS}
    for name in NN_OPS:
        spec, mine = by_name[name], OPS[name]
        assert mine.amp_list == spec.get("amp"), name
        assert mine.method == spec.get("method", name), name
        assert mine.multi_output == bool(spec.get("multi_output")), name
        assert mine.inplace_view == bool(spec.get("inplace_view")), name
        assert mine.eager_only == bool(spec.get("eager_only")), name


@pytest.mark.parametrize("name", _CASED)
def test_nn_op_matches_reference(name):
    arrs, kw = _inputs(name)
    want, want_g = _references()[name]
    got, got_g = _port(name, arrs, kw)
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), np.asarray(w), FWD_TOL, f"{name} output {i}")
    if name in NO_VJP:
        return
    assert (got_g is None) == (want_g is None), name
    for i, (g, w) in enumerate(zip(got_g or [], want_g or [])):
        _close(g.numpy(), w, VJP_TOL, f"{name} vjp {i}")


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_keep_rate_and_scaling(mode):
    """The reference's dropout draws with a jax key the port does not
    share: a kept element is x / (1 - p) (upscale) or x, a dropped one 0,
    about 1 - p of them kept; one draw an index of `axis`; identity out of
    training."""
    x = np.random.RandomState(0).rand(64, 32, 8).astype(np.float32) + 1.0
    p = 0.3
    gen = torch.Generator().manual_seed(5)
    op = get_op("dropout")
    out = apply_op(op, Tensor(x, place="cpu"), gen, p=p, mode=mode).numpy()
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    kept = out != 0
    np.testing.assert_allclose(out[kept], x[kept] * scale, rtol=1e-6)
    assert abs(kept.mean() - (1.0 - p)) < 0.01
    ref = np.asarray(jax_op("dropout").fn(jnp.asarray(x),
                                          jax.random.key(0), p=p, mode=mode))
    assert abs((ref != 0).mean() - kept.mean()) < 0.02
    out = apply_op(op, Tensor(x, place="cpu"), gen, p=p, axis=[0, 1]).numpy()
    per = (out != 0).reshape(64, 32, 8)
    assert (per.all(axis=2) | ~per.any(axis=2)).all()
    same = apply_op(op, Tensor(x, place="cpu"), gen, p=p, training=False)
    np.testing.assert_array_equal(same.numpy(), x)


AMP_OPS = [n for n in _CASED if OPS[n].amp_list]


@pytest.mark.parametrize("name", AMP_OPS)
def test_o1_output_types_match_reference(name):
    """Under auto_cast O1 (bf16) a white op's fp32 inputs and a black op's
    bf16 inputs are cast as the reference casts them."""
    arrs, kw = _inputs(name)
    low = OPS[name].amp_list == "black"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if low else (jnp.float32,
                                                           torch.float32)
    jx = [jnp.asarray(a, jdt) if _is_real_float(a) else jnp.asarray(a)
          for a in arrs]
    ts = [Tensor(a, place="cpu", dtype=tdt) if _is_real_float(a)
          else Tensor(a, place="cpu") for a in arrs]
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        cast = jamp._amp_handler(jax_op(name), jx)
    want = jax.eval_shape(lambda *xs: jax_op(name).fn(*xs, **kw), *cast)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = apply_op(get_op(name), *ts, **kw)
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, tuple) else [got]
    for g, w in zip(got, want):
        wname = np.dtype(w.dtype).name
        gname = str(g.dtype).replace("torch.", "")
        if wname in ("int32", "int64"):     # the reference runs without x64
            assert gname in ("int32", "int64"), (name, gname, wname)
        else:
            assert gname == wname, (name, gname, wname)
