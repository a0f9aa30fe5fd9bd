"""The port's Paddle Tensor (`import paddle_tpu_torch as paddle`) against
the JAX package's, on the CPU, mirroring tests/test_tensor.py and
tests/test_autograd.py.

Each scenario is one function of the package, run once with `paddle_tpu`
and once with `paddle_tpu_torch` on the same numpy inputs; every value it
returns must agree within rtol 1e-5 / atol 1e-6 (floats), exactly
(integers and bools), and in shape. Types are pinned separately: where
the reference runs without x64 and gives int32 (`to_tensor([1, 2, 3])`,
sums and indices of integers), the port gives int64, Paddle's own type;
the values agree.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch import device as tdevice

TOL = dict(rtol=1e-5, atol=1e-6)

R = np.random.RandomState(0)
A = R.randn(3, 4).astype(np.float32)
B = R.randn(3, 4).astype(np.float32) + 0.5
M = R.randn(4, 5).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    before = tdevice.get_device()
    tp.set_device("cpu")
    yield
    tdevice._DEFAULT[0] = before


def _np(v):
    if isinstance(v, (jp.Tensor, tp.Tensor)):
        return np.asarray(v.numpy())
    return np.asarray(v)


def _flat(out):
    if isinstance(out, dict):
        return [(k, _np(v)) for k, v in sorted(out.items())]
    if isinstance(out, (list, tuple)):
        return [(str(i), _np(v)) for i, v in enumerate(out)]
    return [("0", _np(out))]


def _same(scenario):
    got, want = _flat(scenario(tp)), _flat(scenario(jp))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), err_msg=k,
                                       **TOL)


def t(p, a, **kw):
    return p.to_tensor(a, **kw)


SCENARIOS = {
    # creation and dtypes
    "to_tensor": lambda p: [t(p, [[1.5, 2.0], [3.0, 4.0]]), t(p, A)],
    "float64 becomes float32": lambda p: t(p, A.astype(np.float64)),
    "zeros ones full": lambda p: [p.zeros([2, 3]), p.ones([3]),
                                  p.full([2, 2], 7.5), p.full([2], 3)],
    "arange linspace eye": lambda p: [p.arange(5), p.arange(1, 7, 2),
                                      p.arange(0.0, 1.0, 0.25),
                                      p.linspace(0, 1, 5), p.eye(3),
                                      p.eye(2, 3)],
    "like": lambda p: [p.zeros_like(t(p, A)), p.ones_like(t(p, A)),
                       p.full_like(t(p, A), 2.0)],
    "shape ndim size": lambda p: [t(p, A).shape, t(p, A).ndim,
                                  t(p, A).size, t(p, A).numel()],
    "T and item": lambda p: [t(p, A).T, t(p, 3.5).item(),
                             t(p, A)[1, 2].item()],
    "astype": lambda p: [t(p, A).astype("int32"),
                         t(p, A).astype("float16").astype("float32"),
                         t(p, A).cast("bool")],
    # arithmetic
    "binary ops": lambda p: [t(p, A) + t(p, B), t(p, A) - t(p, B),
                             t(p, A) * t(p, B), t(p, A) / t(p, B),
                             t(p, A) ** 2, 2.0 ** t(p, A), t(p, A) @ t(p, M),
                             1.0 - t(p, A), 3.0 / t(p, B), -t(p, A)],
    "floor div and mod of negatives": lambda p: [
        t(p, np.array([-7, 7, -8], np.int64)) // 2,
        t(p, np.array([-7, 7, -8], np.int64)) % 3,
        t(p, np.array([-7.5, 7.5], np.float32)) // 2.0,
        t(p, np.array([-7.5, 7.5], np.float32)) % 2.0],
    "scalars keep bf16": lambda p: [
        (t(p, A).astype("bfloat16") * 2.0).astype("float32"),
        (t(p, A).astype("bfloat16") + 1).astype("float32")],
    "unary ops": lambda p: [t(p, B).abs().sqrt(), t(p, A).exp(),
                            t(p, A).tanh(), t(p, A).sigmoid(),
                            t(p, A).sin(), t(p, A).floor(), t(p, A).sign(),
                            abs(t(p, A)), t(p, A).square()],
    "matmul flags": lambda p: [
        p.matmul(t(p, A), t(p, A), transpose_y=True),
        p.matmul(t(p, A), t(p, A), transpose_x=True)],
    "clip": lambda p: [t(p, A).clip(-0.5, 0.5), p.clip(t(p, A), min=0.0)],
    # reductions
    "sum mean": lambda p: [t(p, A).sum(), t(p, A).sum(axis=0),
                           t(p, A).sum(axis=[0, 1]),
                           t(p, A).mean(axis=1, keepdim=True),
                           p.sum(t(p, A), axis=-1)],
    "max min argmax": lambda p: [t(p, A).max(), t(p, A).max(axis=1),
                                 t(p, A).min(axis=0), t(p, A).argmax(),
                                 t(p, A).argmax(axis=1),
                                 t(p, A).argmin(axis=0)],
    "cumsum std var": lambda p: [t(p, A).cumsum(axis=1), t(p, A).std(),
                                 t(p, A).var(axis=0),
                                 t(p, A).std(unbiased=False)],
    # manipulation
    "reshape transpose flatten": lambda p: [
        t(p, A).reshape([4, 3]), t(p, A).reshape([-1]),
        t(p, A).transpose([1, 0]), t(p, A).reshape([1, 3, 4]).flatten(),
        t(p, A).reshape([1, 3, 4]).flatten(1)],
    "squeeze unsqueeze": lambda p: [
        t(p, A).unsqueeze(0).shape, t(p, A).unsqueeze([0, 2]).shape,
        t(p, A).reshape([1, 3, 1, 4]).squeeze().shape,
        t(p, A).reshape([1, 3, 1, 4]).squeeze(2).shape],
    "concat stack split": lambda p: [
        p.concat([t(p, A), t(p, B)], axis=0),
        p.stack([t(p, A), t(p, B)], axis=1),
        *p.split(t(p, A), 2, axis=1), *t(p, A).split([1, -1], axis=0),
        *t(p, A).chunk(2, axis=1)],
    "gather index_select": lambda p: [
        t(p, A).gather(t(p, np.array([2, 0]))),
        t(p, A).index_select(t(p, np.array([3, 1])), axis=1),
        p.gather(t(p, A), t(p, np.array([1, 1])), axis=0)],
    "where": lambda p: [p.where(t(p, A) > 0, t(p, A), t(p, B)),
                        p.where(t(p, A) > 0, t(p, A), p.zeros_like(
                            t(p, A)))],
    "topk sort argsort": lambda p: [
        *t(p, A).topk(2), *t(p, A).topk(2, axis=0, largest=False),
        t(p, A).sort(axis=1), t(p, A).sort(descending=True),
        t(p, A).argsort(axis=0)],
    "tril triu": lambda p: [t(p, A).tril(), t(p, A).triu(1),
                            p.tril(t(p, A), -1)],
    "unique nonzero": lambda p: [
        *t(p, np.array([3, 1, 3, 2, 1], np.int64)).unique(
            return_counts=True),
        t(p, np.array([[0, 1], [2, 0]], np.int64)).nonzero(),
        p.masked_select(t(p, A), t(p, A) > 0)],
    # indexing
    "getitem basic": lambda p: [t(p, A)[0], t(p, A)[:, 1], t(p, A)[1:, ::2],
                                t(p, A)[-1, -2], t(p, A)[None, 1]],
    "getitem tensor index": lambda p: [
        t(p, A)[t(p, np.array([2, 0]))],
        t(p, A)[t(p, np.array([0, 2])), t(p, np.array([1, 3]))]],
    "getitem bool mask": lambda p: [t(p, A)[t(p, A) > 0],
                                    t(p, A)[t(p, np.array([True, False,
                                                           True]))]],
    "setitem": lambda p: _setitem(p),
    "compare": lambda p: [t(p, A) == t(p, A), t(p, A) != t(p, B),
                          t(p, A) < t(p, B), t(p, A) >= 0.0,
                          p.equal_all(t(p, A), t(p, A)),
                          p.allclose(t(p, A), t(p, A) + 1e-9)],
    "logical": lambda p: [(t(p, A) > 0) & (t(p, B) > 0),
                          (t(p, A) > 0) | (t(p, B) > 0),
                          ~(t(p, A) > 0), (t(p, A) > 0) ^ (t(p, B) > 0),
                          p.logical_and(t(p, A) > 0, t(p, B) < 1)],
    "float int conversion": lambda p: [float(t(p, 2.5)), int(t(p, 7)),
                                       bool(t(p, 1.0))],
    "bfloat16": lambda p: [t(p, A).astype("bfloat16").astype("float32"),
                           (t(p, A).astype("bfloat16")
                            @ t(p, M).astype("bfloat16")).astype(
                                "float32")],
    "shape rank crop": lambda p: [p.shape(t(p, A)), p.rank(t(p, A)),
                                  p.crop(t(p, A), shape=[2, 2],
                                         offsets=[1, 1]),
                                  p.broadcast_shape([3, 1], [1, 4])],
    "index_put": lambda p: [p.index_put(
        p.zeros([3, 2]), (t(p, np.array([0, 2])), t(p, np.array([1, 0]))),
        t(p, np.array([1.0, 2.0], np.float32))), p.index_put(
        p.zeros([3, 2]), (t(p, np.array([0, 0])), t(p, np.array([1, 1]))),
        t(p, np.array([1.0, 2.0], np.float32)), accumulate=True)],
    "in-place": lambda p: _inplace(p),
    "fill zero set_value": lambda p: _fills(p),
    "misc shims": lambda p: [p.add_n([t(p, A), t(p, B), t(p, A)]),
                             p.permute(t(p, A), 1, 0),
                             p.view(t(p, A), [4, 3]),
                             p.broadcast_to(t(p, A)[0], [2, 4]),
                             p.cat([t(p, A), t(p, A)], axis=1)],
    "apply and nbytes": lambda p: [t(p, A).apply(lambda x: x * 2),
                                   t(p, A).nbytes, t(p, A).element_size()],
    # autograd
    "grad simple chain": lambda p: _grad_of(p, lambda x: (x * x + 3 * x)
                                            .sum()),
    "grad accumulation": lambda p: _accumulate(p),
    "grad fanout and diamond": lambda p: _grad_of(
        p, lambda x: ((x * 2) * (x + 1) + x.exp()).mean()),
    "grad matmul broadcast": lambda p: _matmul_grads(p),
    "grad softmax cross": lambda p: _grad_of(
        p, lambda x: (p.nn.functional.softmax(x) * t(p, B)).sum()),
    "grad split multi-output": lambda p: _grad_of(
        p, lambda x: (x.split(2, axis=1)[1] * 3.0).sum()),
    "grad through setitem": lambda p: _setitem_grad(p),
    "stop_gradient blocks": lambda p: _stop(p),
    "paddle.grad": lambda p: _paddle_grad(p),
    "leaf hook": lambda p: _hook(p),
    "no_grad": lambda p: _no_grad(p),
    "in-place on a leaf that needs grad": lambda p: _inplace_leaf(p),
}


def _setitem(p):
    x = t(p, A)
    x[0] = 1.0
    x[:, 1] = t(p, np.arange(3, dtype=np.float32))
    x[x > 1.5] = 0.0
    y = t(p, np.arange(6, dtype=np.int64).reshape(2, 3))
    y[1, 1:] = 9
    return [x, y]


def _inplace(p):
    x = t(p, A)
    x.add_(t(p, B)).multiply_(t(p, B)).subtract_(t(p, A))
    y = t(p, A)
    y.scale_(2.0, 1.0).clip_(-1.0, 1.0)
    z = t(p, A)
    z.tril_().floor_()
    return [x, y, z]


def _fills(p):
    x = t(p, A)
    x.fill_(3.0)
    y = t(p, A)
    y.zero_()
    z = t(p, A)
    z.set_value(B)
    w = t(p, A)
    w.copy_(t(p, B) * 2)
    return [x, y, z, w]


def _grad_of(p, fn, x=A):
    xt = t(p, x, stop_gradient=False)
    out = fn(xt)
    out.backward()
    return [out, xt.grad]


def _accumulate(p):
    x = t(p, A, stop_gradient=False)
    (x * x).sum().backward()
    g1 = x.grad.numpy()
    (x * 3.0).sum().backward()
    g2 = x.grad.numpy()
    x.clear_grad()
    return [g1, g2, x.grad is None]


def _matmul_grads(p):
    a = t(p, A, stop_gradient=False)
    m = t(p, M, stop_gradient=False)
    bias = t(p, B[0], stop_gradient=False)
    ((a + bias) @ m).sum().backward()
    return [a.grad, m.grad, bias.grad]


def _setitem_grad(p):
    x = t(p, A, stop_gradient=False)
    y = x * 2.0
    y[0] = 0.0
    (y * y).sum().backward()
    return [y, x.grad]


def _stop(p):
    x = t(p, A, stop_gradient=False)
    c = (x * 2.0).detach()
    ids = t(p, np.array([1, 2], np.int64))
    out = (x * c).sum() + (x[ids] * 1.0).sum()
    out.backward()
    return [x.grad, c.stop_gradient, (x > 0).stop_gradient,
            out.stop_gradient]


def _paddle_grad(p):
    x = t(p, A, stop_gradient=False)
    u = t(p, B, stop_gradient=False)
    y = (x * x).sum()
    (gx,) = p.grad(y, x, retain_graph=True)
    z = x * 3.0
    (gz,) = p.grad((z * z).sum(), z)
    gs = p.grad((x * 2.0).sum(), [x, u], allow_unused=True)
    raised = False
    try:
        p.grad((x * 2.0).sum(), [x, u])
    except RuntimeError:
        raised = True
    return [gx, gz, gs[0], gs[1] is None, raised, x.grad is None]


def _hook(p):
    x = t(p, A, stop_gradient=False)
    h = x.register_hook(lambda g: g * 2.0)
    (x * 1.0).sum().backward()
    g1 = x.grad.numpy()
    h.remove()
    x.clear_grad()
    (x * 1.0).sum().backward()
    return [g1, x.grad]


def _no_grad(p):
    x = t(p, A, stop_gradient=False)
    with p.no_grad():
        y = x * 2.0

    @p.no_grad()
    def f(v):
        return v * 3.0

    with p.no_grad():
        with p.enable_grad():
            z = x * 4.0
    return [y.stop_gradient, f(x).stop_gradient, z.stop_gradient,
            p.is_grad_enabled()]


def _inplace_leaf(p):
    # on an intermediate: the gradient flows through the in-place op
    x = t(p, A, stop_gradient=False)
    y = x * 1.0
    y.add_(t(p, B))
    (y * y).sum().backward()
    # on the leaf itself: the reference rebinds it to the op's result, so
    # it is no longer a leaf and takes no .grad
    w = t(p, A, stop_gradient=False)
    w.add_(t(p, B))
    (w * w).sum().backward()
    return [y, x.grad, w, w.is_leaf, w.grad is None, w.stop_gradient]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    _same(SCENARIOS[name])


def test_dtypes_of_the_port():
    """Paddle's types where the reference's 32-bit jax default stands in:
    integer data, indices and integer sums are int64 in the port."""
    assert tp.to_tensor([1, 2, 3]).dtype == tp.int64
    assert jp.to_tensor([1, 2, 3]).dtype == jp.int32
    assert tp.to_tensor([1.0]).dtype == tp.float32
    assert tp.to_tensor(A.astype(np.float64)).dtype == tp.float32
    assert tp.to_tensor(True).dtype == tp.bool_
    assert tp.to_tensor(A).argmax().dtype == tp.int64
    assert tp.to_tensor([1, 2]).sum().dtype == tp.int64
    assert tp.arange(3).dtype == tp.int64
    assert (tp.to_tensor(A).astype("bfloat16") * 2.0).dtype == tp.bfloat16
    assert (tp.to_tensor([1, 2]) / 2).dtype == tp.float32
    assert tp.to_tensor(A).dtype is torch.float32      # torch's own dtype
    assert tp.to_tensor(A).place == tp.CPUPlace()
    assert isinstance(tp.to_tensor(A).shape, list)


def test_default_device_is_the_card():
    """A creation op with no place goes to the port's default device,
    "cuda" unless set_device("cpu"); without a card that raises rather
    than falling back."""
    tdevice._DEFAULT[0] = "cuda"
    try:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                tp.to_tensor([1.0])
            with pytest.raises(RuntimeError, match="cuda"):
                tp.nn.Linear(2, 2)
        assert tp.to_tensor([1.0], place="cpu").place.is_cpu_place()
        assert tp.zeros([2], place=tp.CPUPlace()).place == tp.CPUPlace()
    finally:
        tdevice._DEFAULT[0] = "cpu"


def test_seed_reproducible_and_random_shapes():
    tp.seed(123)
    a = tp.rand([3, 4]).numpy()
    tp.seed(123)
    np.testing.assert_array_equal(tp.rand([3, 4]).numpy(), a)
    assert tp.randn([2, 5]).shape == [2, 5]
    r = tp.randint(0, 5, [100]).numpy()
    assert r.min() >= 0 and r.max() < 5
    assert sorted(tp.randperm(6).numpy().tolist()) == list(range(6))
    u = tp.uniform([1000], min=-2.0, max=3.0).numpy()
    assert u.min() >= -2.0 and u.max() <= 3.0
    x = tp.zeros([1000]).normal_(1.0, 0.5).numpy()
    assert abs(x.mean() - 1.0) < 0.1 and abs(x.std() - 0.5) < 0.1
    state = tp.get_rng_state()
    b = tp.randn([4]).numpy()
    tp.set_rng_state(state)
    np.testing.assert_array_equal(tp.randn([4]).numpy(), b)


def test_tensor_methods_bind_the_reference_table():
    from paddle_tpu.core import tensor as jt

    for name in jt._METHOD_TABLE:
        assert hasattr(tp.Tensor, name), name
    for name, op in jt._YAML_METHODS.items():
        assert hasattr(tp.Tensor, name), name
    for name in ("topk", "chunk", "unique", "nonzero", "masked_select"):
        assert hasattr(tp.Tensor, name)


def test_nonscalar_backward_needs_a_grad_tensor():
    x = tp.to_tensor(A, stop_gradient=False)
    with pytest.raises(RuntimeError):
        (x * 2.0).backward()
    (x * 2.0).backward(tp.ones_like(x))
    np.testing.assert_allclose(x.grad.numpy(), np.full_like(A, 2.0))


def test_second_backward_needs_retain_graph():
    x = tp.to_tensor(A, stop_gradient=False)
    y = (x.exp() * x).sum()
    y.backward(retain_graph=True)
    y.backward()
    with pytest.raises(RuntimeError):
        y.backward()
