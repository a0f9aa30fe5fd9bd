"""The port's op table (`paddle_tpu_torch.ops.registry`) against the JAX
registry, op by op, on the CPU.

Every op of the JAX registry has a port counterpart of the same name;
those outside `ops/nn_ops.py` are checked here (declaration, forward,
VJP), the nn ops in `tests/test_torch_nn_ops.py`. Each one runs on the first
input case `tests/test_op_harness.py` gives it (imported, not edited)
through the port's dispatch on Paddle Tensors and through the reference's
`get_op(name).fn`, jitted; a few ops the harness leaves out get their
cases here. Forward outputs agree within rtol 1e-4 / atol 1e-5 (integer
and bool outputs exactly; the harness's gauge post-processing, e.g. |.|
of eigenvectors, applied to both). Where the first output is real
floating, the vector-Jacobian product of a seeded cotangent with respect
to every real floating input agrees within rtol 1e-3 / atol 1e-4 (torch
autograd against `jax.vjp`), except for the ops listed in `NO_VJP` with
their reason. Under `auto_cast` O1 each op with an `amp:` list gives its
outputs the reference's types. The JAX references run jitted, many ops to
one program, so the file stays cheap.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import paddle_tpu.amp as jamp
import test_op_harness as H
from paddle_tpu.ops.registry import get_op as jax_op
from paddle_tpu_torch import amp
from paddle_tpu_torch.core.dispatch import apply_op
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.ops.registry import OPS, get_op

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
VJP_TOL = dict(rtol=1e-3, atol=1e-4)

_SPECS = yaml.safe_load(open(H.__file__.replace(
    "tests/test_op_harness.py", "paddle_tpu/ops/ops.yaml")))
REFERENCE = sorted(s["op"] for s in _SPECS
                   if not s.get("kernel", "").startswith("nn_ops"))
NN_OPS = sorted(s["op"] for s in _SPECS
                if s.get("kernel", "").startswith("nn_ops"))

LIST_INPUT = H._LIST6 | H._LIST7

# ops whose VJPs are not compared, and why
NO_VJP = {
    # gauge freedom: the factors are defined up to signs / phases, so
    # their cotangents are too
    "svd": "singular vectors' signs", "eigh": "eigenvectors' signs",
    "qr": "Q / R signs", "lu": "pivoting", "lu_unpack": "pivoting",
    "householder_product": "reflector gauge", "ormqr": "reflector gauge",
    "eig": "eigenvector phases", "svd_lowrank": "sketch",
    "pca_lowrank": "sketch",
    # torch has no derivative with respect to the shape parameter
    "gammainc": "no torch grad wrt a", "gammaincc": "no torch grad wrt a",
    "igamma": "no torch grad wrt a", "igammac": "no torch grad wrt a",
    "polygamma": "no torch grad of order > 1",
    # the data-dependent ops
    "histogramdd": "counts", "histogram": "counts",
    "unique_consecutive": "the reference runs it on the host (numpy)",
    # jax has no differentiation rule
    "nextafter": "no jax differentiation rule",
}


def _first_cases():
    cases = {}
    for name in dir(H):
        if name.startswith("CASES"):
            for c in getattr(H, name):
                cases.setdefault(c[0], (c[2], c[3]))
    cases["unique_consecutive"] = (
        [np.array([1., 1., 2., 2., 3., 1.], np.float32)], {})
    a = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    cases["eig"] = ([a], {})
    low = (np.random.RandomState(4).randn(12, 4)
           @ np.diag([4., 3., 2.5, 2.]) @ np.random.RandomState(5).randn(
               4, 7)).astype(np.float32)
    cases["svd_lowrank"] = ([low], {"q": 6})
    cases["pca_lowrank"] = ([low], {"q": 6})
    return cases


CASES = _first_cases()


def _norm(a):
    a = np.asarray(a)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        return a
    if np.issubdtype(a.dtype, np.complexfloating):
        return a.astype(np.complex64)
    return a.astype(np.float32)


def _inputs(name):
    arrs, kw = CASES[name]
    return [_norm(a) for a in arrs], kw


def _is_real_float(a):
    return np.asarray(a).dtype.kind == "f"


def _cotangent(name, shape):
    seed = sum(map(ord, name))
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _call(fn, name, xs, kw):
    return fn(list(xs), **kw) if name in LIST_INPUT else fn(*xs, **kw)


def _reference_fn(name, arrs, kw):
    """(forward outputs, input cotangents or None) of the JAX op, as a
    function of the input arrays, for jitting."""
    fn = jax_op(name).fn
    fl = [i for i, a in enumerate(arrs) if _is_real_float(a)]

    def run(*xs):
        def outputs(*f):
            full = list(xs)
            for i, v in zip(fl, f):
                full[i] = v
            o = _call(fn, name, full, kw)
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


_SPECIAL = {"set_value_by_index", "index_put"}
_EAGER = {n for n in REFERENCE if jax_op(n).eager_only}
_JITTED = [n for n in REFERENCE if n not in _SPECIAL | _EAGER]


@functools.lru_cache(maxsize=None)
def _reference_group(group):
    """Jit the references of `group` (a tuple of op names) as one program;
    a group that does not trace falls back to one program an op."""
    def all_ops(data):
        return {n: _reference_fn(n, *_inputs(n))(*data[n]) for n in group}

    data = {n: [jnp.asarray(a) for a in _inputs(n)[0]] for n in group}
    try:
        return jax.device_get(jax.jit(all_ops)(data))
    except Exception:   # noqa: BLE001 - one untraceable op spoils a group
        pass
    res = {}
    for n in group:
        try:
            res[n] = jax.device_get(jax.jit(_reference_fn(
                n, *_inputs(n)))(*data[n]))
        except Exception as e:   # noqa: BLE001 - raised by its own case
            res[n] = e
    return res


_GROUP = 160


def _reference(name):
    if name in _EAGER:
        return _reference_fn(name, *_inputs(name))(
            *[jnp.asarray(a) for a in _inputs(name)[0]])
    i = _JITTED.index(name) // _GROUP * _GROUP
    res = _reference_group(tuple(_JITTED[i:i + _GROUP]))[name]
    if isinstance(res, Exception):
        raise res
    return res


def _port(name, arrs, kw):
    """(outputs, input grads or None) of the port's op through the
    dispatch, on CPU Paddle Tensors."""
    ts = [Tensor(a, place="cpu", stop_gradient=not _is_real_float(a))
          for a in arrs]
    out = apply_op(get_op(name), ts, **kw) if name in LIST_INPUT else \
        apply_op(get_op(name), *ts, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    fl = [t for t in ts if not t.stop_gradient]
    first = outs[0]
    if name in NO_VJP or not fl or not first._t.is_floating_point():
        return outs, None
    if not first._t.requires_grad:     # constant in its inputs
        return outs, [torch.zeros_like(t._t) for t in fl]
    ct = torch.from_numpy(_cotangent(name, tuple(first.shape)))
    grads = torch.autograd.grad(first._t, [t._t for t in fl], ct,
                                allow_unused=True)
    return outs, [torch.zeros_like(t._t) if g is None else g
                  for g, t in zip(grads, fl)]


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} vs " \
                                    f"{want.shape}"
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    acc = np.complex128 if (np.iscomplexobj(got) or np.iscomplexobj(want)) \
        else np.float64
    np.testing.assert_allclose(got.astype(acc), want.astype(acc),
                               err_msg=what, equal_nan=True, **tol)


def test_every_reference_op_outside_nn_ops_is_ported():
    assert len(REFERENCE) == 325 and len(NN_OPS) == 72
    assert sorted(OPS) == sorted(REFERENCE + NN_OPS)
    by_name = {s["op"]: s for s in _SPECS}
    for name in REFERENCE:
        spec, mine = by_name[name], OPS[name]
        assert mine.amp_list == spec.get("amp"), name
        assert mine.method == spec.get("method", name), name
        assert mine.multi_output == bool(spec.get("multi_output")), name
        assert mine.inplace_view == bool(spec.get("inplace_view")), name
        assert mine.eager_only == bool(spec.get("eager_only")), name


@pytest.mark.parametrize("name", REFERENCE)
def test_op_matches_reference(name):
    if name == "set_value_by_index":
        with pytest.raises(NotImplementedError):
            jax_op(name).fn(jnp.zeros(2), 1.0)
        with pytest.raises(NotImplementedError):
            apply_op(get_op(name), Tensor(np.zeros(2), place="cpu"), 1.0)
        return
    if name == "index_put":
        _index_put_case()
        return
    arrs, kw = _inputs(name)
    want, want_g = _reference(name)
    got, got_g = _port(name, arrs, kw)
    post = H._POST7.get(name)
    if name == "eig":
        post = None
        w, v = got[0].numpy(), got[1].numpy()
        np.testing.assert_allclose(arrs[0] @ v, v * w[None, :], atol=1e-4)
        got, want = got[:1], want[:1]
        got[0] = Tensor(np.sort_complex(w), place="cpu")
        want[0] = np.sort_complex(np.asarray(want[0]))
    if name in ("svd_lowrank", "pca_lowrank"):
        # the sketches differ; both recover the rank-4 input's spectrum
        got, want = got[1:2], want[1:2]
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if post is not None:
            g, w = post(g), post(w)
        _close(g, w, FWD_TOL, f"{name} output {i}")
    if name in NO_VJP:
        return
    assert (got_g is None) == (want_g is None), name
    for i, (g, w) in enumerate(zip(got_g or [], want_g or [])):
        _close(g.numpy(), w, VJP_TOL, f"{name} vjp {i}")


def _index_put_case():
    x = np.zeros((3, 2), np.float32)
    rows, cols = np.array([0, 2, 0]), np.array([1, 0, 1])
    v = np.array([1.0, 2.0, 3.0], np.float32)
    for acc in (False, True):
        want = jax_op("index_put").fn(jnp.asarray(x), (rows, cols),
                                      jnp.asarray(v), accumulate=acc)
        got = apply_op(get_op("index_put"), Tensor(x, place="cpu"),
                       (Tensor(rows, place="cpu"),
                        Tensor(cols, place="cpu")),
                       Tensor(v, place="cpu"), accumulate=acc)
        if acc:
            _close(got.numpy(), want, FWD_TOL, "index_put")
        else:   # duplicate index (0, 1): either write may win
            np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:])


AMP_OPS = [n for n in REFERENCE if OPS[n].amp_list and n not in _SPECIAL]


@pytest.mark.parametrize("name", AMP_OPS)
def test_o1_output_types_match_reference(name):
    """Under auto_cast O1 (bf16) a white op's fp32 inputs and a black op's
    bf16 inputs are cast as the reference casts them: each output takes
    the reference's type."""
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
    want = jax.eval_shape(lambda *xs: _call(jax_op(name).fn, name, xs, kw),
                          *cast)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = apply_op(get_op(name), ts, **kw) if name in LIST_INPUT else \
            apply_op(get_op(name), *ts, **kw)
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, tuple) else [got]
    for g, w in zip(got, want):
        wname = np.dtype(w.dtype).name
        gname = str(g.dtype).replace("torch.", "")
        if wname in ("int32", "int64"):     # the reference runs without x64
            assert gname in ("int32", "int64"), (name, gname, wname)
        else:
            assert gname == wname, (name, gname, wname)
