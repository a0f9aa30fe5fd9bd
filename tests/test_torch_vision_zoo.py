"""The port's vision model zoo (paddle_tpu_torch/vision/models) against the
JAX package's, on the CPU (after tests/test_vision_models2.py and
tests/test_hapi_vision.py::test_model_zoo_constructs).

- every constructor of the reference's `vision.models`: the port's state
  dict has the reference's names and shapes, name for name (so its
  parameter count is the reference's), and `pretrained=True` raises what
  the reference raises;
- each family at a small input, the reference's scaled-down variants
  where it has them, the JAX weights carried across
  (`load_reference_layer`), dropout set to 0 in both: a train-mode
  forward, then an eval-mode forward on the running statistics that step
  left, against the reference run in float64 (one jitted program a
  family, the reference's BatchNorm ops swapped for the same formula in
  the input's type, since they cast to float32). DenseNet, MobileNetV3,
  ShuffleNetV2 and GoogLeNet (with its aux heads) also take the
  gradients of a seeded projection of the logits, and run the port in
  float64: the logits and running statistics within 1e-7 of their
  largest value (a running mean: of the running standard deviation),
  every gradient within 1e-7 of the larger of its own largest value and
  1e-6 of the network's largest; InceptionV3's forward runs in float64
  too (its 75 x 75 input leaves 1 x 1 maps). The other families run the
  port in float32: logits and statistics within 1e-4. Why float64 for the
  gradients: in float32 a deep net's gradients at these sizes are
  chaotic (a BatchNorm over few values a channel, ReLU masks that flip,
  leaves whose gradient is zero in exact arithmetic), so two float32
  implementations of one formula differ by up to ~10% at some leaves.
  The float32 families' inputs leave the last BatchNorms at least 4 x 4
  a channel at batch 2, where the float32 forward is well conditioned. DenseNet's gradients are taken on
  a two-layers-a-block DenseNet of the same classes (the reference's
  DenseNet-121 step takes ~30 s to compile on the CPU).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.nn import initializer as TI
from paddle_tpu_torch.weights import load_reference_layer

JM, TM = jp.vision.models, tp.vision.models
NAMES = sorted(n for n in dir(JM) if not n.startswith("_")
               and n[0].islower() and callable(getattr(JM, n)))
SHALLOW = 10   # a DenseNet of two dense layers a block, registered below


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _on_cpu():
    before = tdevice.get_device()
    tp.set_device("cpu")
    yield
    tdevice._DEFAULT[0] = before


def _jax_draws(fill):
    """Every JAX initializer replaced by `fill(init, shape)` (a float32
    numpy array)."""
    classes = [JI.Constant, JI.Normal, JI.TruncatedNormal, JI.Uniform,
               JI.XavierNormal, JI.XavierUniform, JI.KaimingNormal,
               JI.KaimingUniform]

    @contextlib.contextmanager
    def ctx():
        saved = {cls: cls.__call__ for cls in classes}
        try:
            for cls in classes:
                cls.__call__ = lambda self, shape, dtype=None: jnp.asarray(
                    fill(self, tuple(shape)))
            yield
        finally:
            for cls, fn in saved.items():
                cls.__call__ = fn
    return ctx()


def _fast_init(seed):
    """Seeded float32 draws on the host: unit normals scaled by a fan-in
    std (constants keep their value)."""
    rng = np.random.default_rng(seed)

    def fill(init, shape):
        if isinstance(init, JI.Constant):
            return np.full(shape, init.value, np.float32)
        fan = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        if len(shape) == 2:
            fan = shape[0]      # paddle's (in, out)
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            (1.0 / max(fan, 1)) ** 0.5)
    return _jax_draws(fill)


@contextlib.contextmanager
def _empty_port_init():
    """The port's initializers leave memory uninitialized (the tests
    overwrite every value or read only shapes)."""
    saved = TI.Initializer.__call__

    def empty(self, shape, dtype=None, device=None):
        return torch.empty([int(s) for s in shape], dtype=torch.float32)
    TI.Initializer.__call__ = empty
    try:
        yield
    finally:
        TI.Initializer.__call__ = saved


@pytest.fixture
def shallow_densenet(monkeypatch):
    import paddle_tpu.vision.models.densenet as jd
    import paddle_tpu_torch.vision.models.densenet as td

    for mod in (jd, td):
        monkeypatch.setitem(mod._ARCH, SHALLOW, (2, 2, 2, 2))


@contextlib.contextmanager
def _jax_shapes_only():
    """Every JAX initializer, and the zeros / ones the BatchNorms' buffers
    start from, made on the host (eager `jnp.zeros` compiles once a
    shape): only the shapes are read."""
    saved = jnp.zeros, jnp.ones

    def host(fill):
        return lambda shape, dtype=None, **kw: jnp.asarray(fill(
            shape, np.dtype(dtype or np.float32)))
    jnp.zeros, jnp.ones = host(np.zeros), host(np.ones)
    try:
        with _jax_draws(lambda init, shape: np.zeros(shape, np.float32)):
            yield
    finally:
        jnp.zeros, jnp.ones = saved


@pytest.mark.parametrize("name", NAMES)
def test_constructor_state_names_and_shapes(name):
    with _jax_shapes_only():
        ref = getattr(JM, name)()
    with _empty_port_init():
        got = getattr(TM, name)()
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.state_dict().items()} == want
    assert sum(p.numel() for p in got.parameters()) == sum(
        int(np.prod(p.shape)) for p in ref.parameters())


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("name", ["alexnet", "vgg16", "mobilenet_v2",
                                  "squeezenet1_0", "shufflenet_v2_x1_0",
                                  "densenet121", "googlenet",
                                  "inception_v3"])
def test_pretrained_raises_what_the_reference_raises(name):
    with _jax_shapes_only():
        want = _raised(lambda: getattr(JM, name)(pretrained=True))
    with _empty_port_init():
        got = _raised(lambda: getattr(TM, name)(pretrained=True))
    assert want is not None and got is want, (got, want)


# family: (constructor, kwargs, input side, how the port runs): "fp32"
# the forward in float32, at an input that leaves the last BatchNorms at
# least 4 x 4 a channel at batch 2 (a float32 train step is well
# conditioned there); "f64" the forward in float64; "grads" the forward
# and the gradients in float64
FAMILIES = {
    "alexnet": ("alexnet", {}, 64, "fp32"),
    "vgg11_bn": ("vgg11", dict(batch_norm=True), 64, "fp32"),
    "squeezenet1_1": ("squeezenet1_1", {}, 64, "fp32"),
    "mobilenet_v1": ("mobilenet_v1", dict(scale=0.25), 128, "fp32"),
    "mobilenet_v2": ("mobilenet_v2", dict(scale=0.25), 128, "fp32"),
    "mobilenet_v3_small": ("mobilenet_v3_small", dict(scale=0.25), 64,
                           "grads"),
    "shufflenet_v2_x0_25": ("shufflenet_v2_x0_25", {}, 64, "grads"),
    "densenet": ("DenseNet", dict(layers=SHALLOW), 64, "grads"),
    "googlenet": ("googlenet", {}, 64, "grads"),
    "inception_v3": ("inception_v3", {}, 75, "f64"),
}


def _no_dropout(net):
    for m in net.sublayers():
        if type(m).__name__ == "Dropout":
            m.p = 0.0


def _listed(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _x64():
    """JAX's float64 mode as a context (the spelling differs by
    version)."""
    try:
        from jax.experimental import enable_x64
    except ImportError:
        return jax.enable_x64(True)
    return enable_x64()


def _bn_train64(x, weight=None, bias=None, epsilon=1e-5, data_format="NCHW"):
    """The reference's batch_norm_train (paddle_tpu/ops/nn_ops.py) in the
    input's type: it casts to float32, which a float64 reference cannot
    keep."""
    c = 1 if data_format.startswith("NC") else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != c)
    mean, var = jnp.mean(x, axis=axes), jnp.var(x, axis=axes)
    shape = [1] * x.ndim
    shape[c] = -1
    out = (x - mean.reshape(shape)) * jax.lax.rsqrt(var.reshape(shape)
                                                    + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out, mean, var


def _bn_infer64(x, running_mean, running_var, weight=None, bias=None,
                epsilon=1e-5, data_format="NCHW"):
    """The reference's batch_norm_infer in the input's type."""
    shape = [1] * x.ndim
    shape[1 if data_format.startswith("NC") else x.ndim - 1] = -1
    out = (x - running_mean.reshape(shape)) * jax.lax.rsqrt(
        running_var.reshape(shape) + epsilon)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@pytest.fixture
def float64_reference(monkeypatch):
    """The reference's BatchNorm ops in the input's type (see above)."""
    from paddle_tpu.ops.registry import get_op

    monkeypatch.setattr(get_op("batch_norm_train"), "fn", _bn_train64)
    monkeypatch.setattr(get_op("batch_norm_infer"), "fn", _bn_infer64)


def _jax_family(net, x, weights, grads):
    """The reference in float64, one jitted program: the train forward
    (its logits, the running statistics it leaves and, with `grads`, the
    gradients of sum(logit * weight)) and the eval forward on those
    statistics."""
    with _x64():
        params, buffers = extract_state(net)
        f64 = lambda t: jnp.asarray(np.asarray(t), jnp.float64)  # noqa
        params = {k: f64(v) for k, v in params.items()}
        buffers = {k: f64(v) for k, v in buffers.items()}
        x, weights = f64(x), [f64(w) for w in weights]

        def train(p):
            outs, new_b = call_functional(net, p, buffers, (x,),
                                          training=True)
            outs = _listed(outs)
            loss = sum(jnp.sum(o * w) for o, w in zip(outs, weights))
            return loss, (outs, new_b)

        def program(p):
            if grads:
                (_, (outs, new_b)), g = jax.value_and_grad(
                    train, has_aux=True)(p)
            else:
                _, (outs, new_b) = train(p)
                g = {}
            ev, _ = call_functional(net, p, new_b, (x,), training=False)
            return dict(train=outs, buffers=new_b, grads=g, eval=_listed(ev))

        out = jax.jit(program)(params)
        return jax.tree_util.tree_map(np.asarray, out)


def _port_family(net, x, weights, grads, dtype):
    """The port's run of `_jax_family` in `dtype`."""
    net = net.to(dtype=dtype)
    net.train()
    xt = tp.Tensor._wrap(torch.from_numpy(x).to(dtype))
    outs = _listed(net(xt))
    out = dict(train=[o._t.detach().double().numpy() for o in outs])
    if grads:
        sum((o._t * torch.from_numpy(w).to(dtype)).sum()
            for o, w in zip(outs, weights)).backward()
        out["grads"] = {k: p._t.grad.double().numpy()
                        for k, p in net.named_parameters()}
    out["buffers"] = {k: v._t.double().numpy() for k, v in
                      net.named_buffers()}
    net.eval()
    with torch.no_grad():
        out["eval"] = [o._t.double().numpy() for o in _listed(net(xt))]
    return out


def _close(got, want, frac, what, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), scale or 0.0)
    err = float(np.abs(got - want).max())
    assert err <= frac * scale, (what, err, scale)


def _held(got, ref, frac, grad_frac, grad_floor):
    """`got` against the reference run `ref`: logits and running
    statistics to `frac` of their largest value (a running mean to `frac`
    of the running standard deviation, its unit), each gradient to
    `grad_frac` of the larger of its own largest value and `grad_floor`
    times the network's largest gradient."""
    for kind in ("train", "eval"):
        assert len(got[kind]) == len(ref[kind])
        for i, (a, b) in enumerate(zip(got[kind], ref[kind])):
            _close(a, b, frac, f"{kind} logits {i}")
    bufs = ref["buffers"]
    assert sorted(got["buffers"]) == sorted(bufs)
    for k, want in bufs.items():
        std = (float(np.sqrt(bufs[k.replace("_mean", "_variance")]).max())
               if k.endswith("_mean") else None)
        _close(got["buffers"][k], want, frac, f"buffer {k}", std)
    if ref["grads"]:
        top = max(float(np.abs(v).max()) for v in ref["grads"].values())
        assert sorted(got["grads"]) == sorted(ref["grads"])
        for k, want in ref["grads"].items():
            _close(got["grads"][k], want, grad_frac, f"grad {k}",
                   grad_floor * top)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_the_reference(family, request, float64_reference):
    ctor, kw, side, mode = FAMILIES[family]
    grads = mode == "grads"
    if ctor == "DenseNet":
        request.getfixturevalue("shallow_densenet")
    with _fast_init(7):
        ref = getattr(JM, ctor)(**kw)
    _no_dropout(ref)
    weights_of = {k: np.array(v._data) for k, v in ref.state_dict().items()}
    rng = np.random.RandomState(11)
    x = rng.standard_normal((2, 3, side, side)).astype(np.float32)
    n_out = 3 if ctor == "googlenet" else 1
    proj = [rng.standard_normal((2, 1000)).astype(np.float32)
            for _ in range(n_out)]
    want = _jax_family(ref, x, proj, grads)
    with _empty_port_init():
        net = getattr(TM, ctor)(**kw)
    _no_dropout(net)
    load_reference_layer(net, weights_of)
    if mode == "fp32":      # within float32 rounding of the reference
        _held(_port_family(net, x, proj, grads, torch.float32), want,
              1e-4, None, None)
    else:                   # in float64: the same function
        _held(_port_family(net, x, proj, grads, torch.float64), want,
              1e-7, 1e-7, 1e-6)
