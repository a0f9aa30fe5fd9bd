"""The port's Paddle dygraph surface (`paddle_tpu_torch.nn`: Layer, the
layers, the functionals, the initializers) against the JAX package's on
the CPU, mirroring tests/test_nn.py's layer, initializer and loss tests,
and the slice as a whole.

Each layer is built in both packages, the JAX Layer's weights carried
across by name (`weights.load_reference_layer`: the layouts agree, no
transpose), and run on the same numpy inputs: forward outputs within
rtol 1e-5 / atol 1e-5, input gradients within rtol 1e-4 / atol 1e-5.

The slice: the ERNIE-1.0-shaped network of the chip run (three
embeddings, LayerNorm(eps 1e-12), dropout, a post-LN
`TransformerEncoder` of GELU layers and a vocabulary head) at 2 layers,
hidden 64, 4 heads, FFN 128, vocab 97, 2 x 16 tokens. At fp32 with
dropout 0 the logits (atol 1e-5), the cross-entropy loss (atol 1e-5),
every gradient (rtol 1e-4 / atol 1e-5) and one AdamW update fed the
reference's gradients (atol 1e-6) match the reference's jitted
`jax.value_and_grad` step and its `functional_step`; under O1 bf16 the
loss is within 2e-2 of the reference's and every gradient's cosine with
the reference's above 0.99 (a gradient that is zero in exact arithmetic,
the key projection's bias, is held to be below 1e-2 of the largest
gradient's norm instead); an eval forward under `no_grad` of the
network with dropout 0.1 matches the reference's eval forward (atol
1e-5).
"""
import contextlib
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.amp as jamp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.weights import load_reference_layer

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    before = tdevice.get_device()
    tp.set_device("cpu")
    yield
    tdevice._DEFAULT[0] = before


def _pair(build):
    """(jax layer, port layer) built by `build(package)`, the port's
    weights carried across from the reference's."""
    jp.seed(7)
    ref = build(jp)
    mine = build(tp)
    load_reference_layer(mine, ref.state_dict())
    return ref, mine


def _cotangent(shape):
    return np.random.RandomState(1).randn(*shape).astype(np.float32)


def _run(layer, arrays):
    """The port layer's output and its float inputs' gradients of
    sum(out * w) for a fixed w, as numpy."""
    xs = [tp.to_tensor(a, stop_gradient=a.dtype.kind != "f")
          for a in arrays]
    out = layer(*xs)
    out0 = out[0] if isinstance(out, tuple) else out
    (out0 * tp.to_tensor(_cotangent(out0.shape))).sum().backward()
    return (np.asarray(out0.numpy(), np.float64),
            [np.asarray(x.grad.numpy()) for x in xs if not x.stop_gradient])


def _reference_run(layers, arrays):
    """The same for each JAX layer of `layers`, all in one jitted
    program: the layer runs as a function of its parameters
    (`call_functional`) and `jax.vjp` gives the input gradients."""
    fl = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    states = [extract_state(m) for m in layers]

    def run(*xs):
        outs = []
        for m, (params, buffers) in zip(layers, states):
            def fwd(*fx, m=m, params=params, buffers=buffers):
                full = list(xs)
                for i, v in zip(fl, fx):
                    full[i] = v
                out, _ = call_functional(m, params, buffers, tuple(full),
                                         training=m.training)
                return out[0] if isinstance(out, tuple) else out

            out, vjp = jax.vjp(fwd, *[xs[i] for i in fl])
            outs.append((out, vjp(jnp.asarray(_cotangent(out.shape)))))
        return outs

    res = jax.jit(run)(*[jnp.asarray(a) for a in arrays])
    return [(np.asarray(o, np.float64), [np.asarray(g) for g in gs])
            for o, gs in res]


def _hold(build, arrays):
    ref, mine = _pair(build)
    ((want, want_g),) = _reference_run([ref], arrays)
    got, got_g = _run(mine, arrays)
    np.testing.assert_allclose(got, want, **FWD)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **GRAD)
    return ref, mine


R = np.random.RandomState(0)
X = R.randn(2, 5, 8).astype(np.float32)


# ------------------------------------------------------------ Layer API
def _mlp(pkg):
    nn = pkg.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 4)
            self.register_buffer("steps", pkg.zeros([1]))

        def forward(self, x):
            return self.fc2(nn.functional.relu(self.fc1(x)))

    return MLP()


def test_parameters_and_names_match_the_reference():
    ref, mine = _pair(_mlp)
    assert [n for n, _ in mine.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert [p.shape for p in mine.parameters()] == \
        [p.shape for p in ref.parameters()]
    assert list(mine.state_dict()) == list(ref.state_dict())
    assert isinstance(mine.fc1.weight, tp.Parameter)
    assert mine.fc1.weight is mine.fc1.weight
    assert isinstance(mine, torch.nn.Module)


def test_forward_and_grads_match_the_reference():
    _hold(_mlp, [X])


def test_state_dict_roundtrip_and_set_state_dict():
    _, mine = _pair(_mlp)
    other = _mlp(tp)
    missing, unexpected = other.set_state_dict(
        {k: v.numpy() for k, v in mine.state_dict().items()})
    assert not missing and not unexpected
    for k, v in mine.state_dict().items():
        np.testing.assert_array_equal(other.state_dict()[k].numpy(),
                                      v.numpy())


def test_train_eval_apply_and_sublayers():
    m = _mlp(tp)
    m.eval()
    assert not any(s.training for s in m.sublayers(include_self=True))
    m.train()
    assert all(s.training for s in m.sublayers())
    seen = []
    m.apply(lambda layer: seen.append(type(layer).__name__))
    assert seen == ["Linear", "Linear", "MLP"]
    assert [n for n, _ in m.named_sublayers()] == ["fc1", "fc2"]


def test_forward_hooks():
    m = _mlp(tp)
    calls = []
    h1 = m.register_forward_pre_hook(
        lambda layer, inp: (inp[0] * 2.0,))
    h2 = m.register_forward_post_hook(
        lambda layer, inp, out: calls.append(out.shape) or out * 0.0)
    x = tp.to_tensor(X)
    assert float(m(x).abs().sum()) == 0.0 and calls == [[2, 5, 4]]
    h1.remove()
    h2.remove()
    base = m(x).numpy()
    h3 = m.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2.0,))
    doubled = m(x).numpy()
    h3.remove()
    np.testing.assert_allclose(doubled, m(x * 2.0).numpy())
    np.testing.assert_allclose(m(x).numpy(), base)


def test_buffers_dtype_deepcopy_and_clear_gradients():
    m = _mlp(tp)
    assert "steps" in m.state_dict() and len(m.buffers()) == 1
    m.to(dtype="float64")
    assert m.fc1.weight.dtype == tp.float64
    m.to(dtype="float32")
    m2 = copy.deepcopy(m)
    assert m2.fc1.weight._t.data_ptr() != m.fc1.weight._t.data_ptr()
    assert m2.fc1.weight.name == m.fc1.weight.name
    (m(tp.to_tensor(X)).sum()).backward()
    assert m.fc1.weight.grad is not None and m2.fc1.weight.grad is None
    m.clear_gradients()
    assert all(p.grad is None for p in m.parameters())


# ------------------------------------------------------------- layers
LAYERS = {
    "linear": (lambda p: p.nn.Linear(8, 6), [X]),
    "linear no bias": (lambda p: p.nn.Linear(8, 6, bias_attr=False), [X]),
    "layer_norm": (lambda p: p.nn.LayerNorm(8, epsilon=1e-12), [X]),
    "rms_norm": (lambda p: p.nn.RMSNorm(8), [X]),
    "flatten": (lambda p: p.nn.Flatten(), [X]),
    "identity": (lambda p: p.nn.Identity(), [X]),
    "sequential": (lambda p: p.nn.Sequential(p.nn.Linear(8, 8),
                                             p.nn.GELU(),
                                             p.nn.Linear(8, 3)), [X]),
    "mha": (lambda p: p.nn.MultiHeadAttention(8, 2), [X]),
    "encoder layer post-LN": (lambda p: p.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, activation="gelu"), [X]),
    "encoder layer pre-LN": (lambda p: p.nn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, normalize_before=True), [X]),
    "encoder": (lambda p: p.nn.TransformerEncoder(
        p.nn.TransformerEncoderLayer(8, 2, 16, dropout=0.0), 2), [X]),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_reference(name):
    build, arrays = LAYERS[name]
    _hold(build, arrays)


ACTIVATIONS = ["ReLU", "ReLU6", "GELU", "SiLU", "Swish", "LeakyReLU",
               "ELU", "SELU", "CELU", "Sigmoid", "LogSigmoid", "Tanh",
               "Tanhshrink", "Hardswish", "Hardsigmoid", "Hardtanh",
               "Hardshrink", "Softshrink", "Mish", "Softsign", "Softmax",
               "LogSoftmax", "GLU", "ThresholdedReLU"]


XA = X * 2.0 + 0.05


@functools.lru_cache(maxsize=None)
def _activation_references():
    return dict(zip(ACTIVATIONS, _reference_run(
        [getattr(jp.nn, name)() for name in ACTIVATIONS], [XA])))


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_reference(name):
    want, (want_g,) = _activation_references()[name]
    got, (got_g,) = _run(getattr(tp.nn, name)(), [XA])
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got_g, want_g, **GRAD)


def test_embedding_padding_idx_matches_reference():
    ids = np.array([[0, 3, 5, 3], [5, 1, 0, 2]], np.int64)
    ref, mine = _pair(lambda p: p.nn.Embedding(7, 4, padding_idx=3))
    np.testing.assert_array_equal(mine.weight.numpy()[3], 0.0)
    for m, pkg in ((ref, jp), (mine, tp)):
        out = m(pkg.to_tensor(ids))
        (out * out).sum().backward()
    np.testing.assert_allclose(mine(tp.to_tensor(ids)).numpy(),
                               ref(jp.to_tensor(ids)).numpy(), **FWD)
    np.testing.assert_allclose(mine.weight.grad.numpy(),
                               ref.weight.grad.numpy(), **GRAD)
    np.testing.assert_array_equal(mine.weight.grad.numpy()[3], 0.0)


def test_dropout_train_and_eval():
    x = tp.ones([4000])
    d = tp.nn.Dropout(0.25)
    tp.seed(3)
    a = d(x).numpy()
    tp.seed(3)
    np.testing.assert_array_equal(d(x).numpy(), a)        # seeded stream
    assert set(np.unique(a)) <= {0.0, np.float32(1.0 / 0.75)}
    assert abs((a == 0).mean() - 0.25) < 0.03
    d.eval()
    np.testing.assert_array_equal(d(x).numpy(), x.numpy())
    along = tp.nn.Dropout(0.5, axis=0)(tp.ones([64, 3])).numpy()
    assert (along == along[:, :1]).all()                   # one draw a row


LOSSES = {
    "ce mean": (lambda p: p.nn.CrossEntropyLoss(), {}),
    "ce ignore_index": (lambda p: p.nn.CrossEntropyLoss(ignore_index=2),
                        {}),
    "ce sum": (lambda p: p.nn.CrossEntropyLoss(reduction="sum"), {}),
    "ce none": (lambda p: p.nn.CrossEntropyLoss(reduction="none"), {}),
    "ce label smoothing": (lambda p: p.nn.CrossEntropyLoss(
        label_smoothing=0.1), {}),
    "ce class weights": (lambda p: p.nn.CrossEntropyLoss(
        weight=p.to_tensor(np.linspace(0.5, 1.5, 5).astype(np.float32))),
        {}),
    "ce soft labels": (lambda p: p.nn.CrossEntropyLoss(soft_label=True),
                       {"soft": True}),
    "mse": (lambda p: p.nn.MSELoss(), {"mse": True}),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_reference(name):
    build, how = LOSSES[name]
    logits = R.randn(6, 5).astype(np.float32)
    if how.get("soft"):
        label = np.random.RandomState(2).dirichlet(np.ones(5), 6).astype(
            np.float32)
    elif how.get("mse"):
        label = R.randn(6, 5).astype(np.float32)
    else:
        label = np.array([0, 2, 4, 1, 2, 3], np.int64)
    outs = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(logits, stop_gradient=False)
        loss = build(pkg)(x, pkg.to_tensor(label))
        loss.sum().backward()
        outs.append((loss.numpy(), x.grad.numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **FWD)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **GRAD)


def test_containers():
    nn = tp.nn
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 3))
    assert len(ll) == 4 and ll[-1].out_features == 3
    assert len(ll.parameters()) == 8
    ld = nn.LayerDict({"a": nn.Linear(2, 2)})
    ld["b"] = nn.ReLU()
    assert list(ld.keys()) == ["a", "b"] and "b" in ld
    pl = nn.ParameterList([tp.create_parameter([2], "float32")
                           for _ in range(2)])
    assert len(pl) == 2 and all(isinstance(p, tp.Parameter) for p in pl)
    assert len(nn.Sequential(nn.ReLU(), nn.ReLU())[:1]) == 1


# -------------------------------------------------------- initializers
@pytest.mark.parametrize("name,args", [
    ("Normal", (0.5, 2.0)), ("Uniform", (-2.0, 3.0)),
    ("XavierNormal", ()), ("XavierUniform", ()), ("KaimingNormal", ()),
    ("KaimingUniform", ()), ("TruncatedNormal", (0.0, 1.0))])
def test_initializer_statistics_match_reference(name, args):
    """The streams differ, the distributions agree: mean and std over
    40000 draws within 0.05 of the reference's draws."""
    shape = [200, 200]
    jp.seed(1)
    tp.seed(1)
    want = np.asarray(getattr(jp.nn.initializer, name)(*args)(
        shape, "float32"))
    got = getattr(tp.nn.initializer, name)(*args)(shape, "float32").numpy()
    assert got.shape == want.shape
    assert abs(got.mean() - want.mean()) < 0.05
    assert abs(got.std() - want.std()) < 0.05 * max(1.0, want.std())
    if name == "TruncatedNormal":
        assert got.min() >= -2.0 and got.max() <= 2.0


def test_deterministic_initializers_match_reference():
    I, J = tp.nn.initializer, jp.nn.initializer
    value = R.randn(3, 4).astype(np.float32)
    for t_init, j_init, shape in (
            (I.Constant(0.3), J.Constant(0.3), [2, 3]),
            (I.Assign(value), J.Assign(value), [3, 4]),
            (I.Dirac(), J.Dirac(), [4, 4, 3, 3])):
        np.testing.assert_array_equal(t_init(shape, "float32").numpy(),
                                      np.asarray(j_init(shape, "float32")))
    q = I.Orthogonal()([6, 4], "float32").numpy()
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)
    for nl in ("sigmoid", "tanh", "relu", "leaky_relu", "selu"):
        assert I.calculate_gain(nl) == J.calculate_gain(nl)
    I.set_global_initializer(I.Constant(0.5), I.Constant(0.25))
    try:
        w = tp.create_parameter([2, 2], "float32")
        b = tp.create_parameter([2], "float32", is_bias=True)
        assert (w.numpy() == 0.5).all() and (b.numpy() == 0.25).all()
    finally:
        I.set_global_initializer(None, None)
    p = tp.create_parameter([3], "float32",
                            attr=tp.ParamAttr(learning_rate=0.5,
                                              trainable=False))
    assert p.optimize_attr["learning_rate"] == 0.5 and p.stop_gradient


# -------------------------------------------- the slice as a whole
V, H, HEADS, FFN, LAYERS_N, B, S = 97, 64, 4, 128, 2, 2, 16
LR = 1e-3


def _table(rows, seed):
    """A seeded N(0, 1) embedding table (the reference's Embedding init,
    drawn by numpy so that neither package compiles a draw)."""
    return np.random.RandomState(seed).randn(rows, H).astype(np.float32)


def _net(pkg, dropout=0.0):
    nn = pkg.nn

    def emb(rows, seed):
        return nn.Embedding(rows, H, weight_attr=pkg.ParamAttr(
            initializer=nn.initializer.Assign(_table(rows, seed))))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word = emb(V, 1)
            self.pos = emb(512, 2)
            self.type = emb(2, 3)
            self.norm = nn.LayerNorm(H, epsilon=1e-12)
            self.drop = nn.Dropout(dropout)
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                H, HEADS, FFN, dropout=dropout, activation="gelu"),
                LAYERS_N)
            self.head = nn.Linear(H, V)

        def forward(self, ids, types):
            pos = pkg.arange(ids.shape[1]).unsqueeze(0)
            h = self.word(ids) + self.pos(pos) + self.type(types)
            return self.head(self.encoder(self.drop(self.norm(h))))

    return Net()


def _batch():
    r = np.random.RandomState(11)
    return (r.randint(0, V, (B, S)).astype(np.int64),
            r.randint(0, 2, (B, S)).astype(np.int64),
            r.randint(0, V, (B, S)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _reference_net():
    jp.seed(5)
    return _net(jp)


@functools.lru_cache(maxsize=None)
def _reference(o1):
    """(net, logits, loss, grads, params after one AdamW update) of the
    JAX package's network, jitted."""
    net = _reference_net()
    net.train()
    params, buffers = extract_state(net)
    ids, types, labels = (jnp.asarray(a) for a in _batch())
    ce = jp.nn.CrossEntropyLoss()

    def loss_of(p):
        ctx = jamp.auto_cast(level="O1", dtype="bfloat16") if o1 \
            else contextlib.nullcontext()
        with ctx:
            logits, _ = call_functional(net, p, buffers, (ids, types),
                                        training=True)
            loss, _ = call_functional(ce, {}, {}, (logits, labels))
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    opt = jp.optimizer.AdamW(learning_rate=LR, weight_decay=0.01,
                             parameters=net.parameters())
    new, _ = jax.jit(lambda p, g: opt.functional_step(
        p, g, opt.functional_state(p), jnp.float32(LR), jnp.int32(1)))(
            params, grads)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return net, np.asarray(logits, np.float32), float(loss), as_np(grads), \
        as_np(new)


def _port_step(net, o1):
    ids, types, labels = (tp.to_tensor(a) for a in _batch())
    ctx = tp.amp.auto_cast(level="O1", dtype="bfloat16") if o1 \
        else contextlib.nullcontext()
    with ctx:
        logits = net(ids, types)
        loss = tp.nn.CrossEntropyLoss()(logits, labels)
    loss.backward()
    return logits, loss


def test_slice_network_fp32_step_matches_reference():
    ref, r_logits, r_loss, r_grads, r_new = _reference(False)
    net = _net(tp)
    load_reference_layer(net, ref.state_dict())
    net.train()
    logits, loss = _port_step(net, False)
    np.testing.assert_allclose(logits.numpy(), r_logits, rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss), r_loss, rtol=0, atol=1e-5)
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert grads.keys() == r_grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g, r_grads[n], err_msg=n, **GRAD)
    # one AdamW update, fed the reference's gradients
    opt = tp.optimizer.AdamW(LR, weight_decay=0.01,
                             parameters=net.parameters())
    for n, p in net.named_parameters():
        p.grad = tp.to_tensor(r_grads[n])
    opt.step()
    opt.clear_grad()
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.numpy(), r_new[n], rtol=0, atol=1e-6,
                                   err_msg=n)


def test_slice_network_o1_step_within_bf16_bounds():
    ref, r_logits, r_loss, r_grads, _ = _reference(True)
    net = _net(tp)
    load_reference_layer(net, ref.state_dict())
    net.train()
    logits, loss = _port_step(net, True)
    assert logits.dtype == tp.bfloat16      # the head is a white-list op
    assert abs(float(loss) - r_loss) <= 2e-2 * abs(r_loss)
    top = max(np.linalg.norm(r) for r in r_grads.values())
    for n, p in net.named_parameters():
        g = p.grad.numpy().astype(np.float64).ravel()
        r = r_grads[n].astype(np.float64).ravel()
        if n.endswith("self_attn.k_proj.bias"):
            # zero in exact arithmetic (a key bias shifts every score of a
            # row alike): both are rounding noise
            assert max(np.linalg.norm(g), np.linalg.norm(r)) < 1e-2 * top, n
            continue
        cos = g @ r / (np.linalg.norm(g) * np.linalg.norm(r))
        assert cos > 0.99, (n, cos)


def test_slice_network_eval_forward_under_no_grad():
    ref = _reference_net()        # in eval mode its dropout is inert
    net = _net(tp, dropout=0.1)
    load_reference_layer(net, ref.state_dict())
    ref.eval()
    net.eval()
    ids, types, _ = _batch()
    params, buffers = extract_state(ref)
    want = np.asarray(jax.jit(lambda p: call_functional(
        ref, p, buffers, (jnp.asarray(ids), jnp.asarray(types)),
        training=False)[0])(params))
    with tp.no_grad():
        got = net(tp.to_tensor(ids), tp.to_tensor(types))
    assert got.stop_gradient
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
