"""`paddle_tpu_torch.nn` in full against the JAX package's `nn` on the
CPU: the convolutions, pools, norms, activations, common layers, losses,
recurrent layers and the transformer decoder added to the port's dygraph
surface, `nn.utils` and the functionals that route around the kernels.

Each layer is built in both packages at a small size, the JAX Layer's
weights carried across by name (`weights.load_reference_layer`), and run
on the same seeded inputs: the forward output within rtol 1e-5 / atol
1e-5 and the input gradients of sum(out * w) for a fixed w within rtol
1e-4 / atol 1e-5 (`RELAXED` layers, whose long reductions or recurrences
sum in another order, 1e-4 / 1e-4 and 1e-3 / 1e-4). The JAX references of
the layer table run as one jitted program. Dropout runs at 0 or out of
training, since the two packages' streams differ by design.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.weights import load_reference_layer
from _reference_init import numpy_init

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
RELAXED_FWD = dict(rtol=1e-4, atol=1e-4)
RELAXED_GRAD = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
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


def _rand(*shape, seed=0, lo=None):
    r = np.random.RandomState(seed + sum(shape))
    if lo is not None:
        return r.uniform(lo, 1.0, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _ints(hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(
        np.int64)


def _cotangent(shape):
    return np.asarray(np.random.RandomState(1).randn(*shape), np.float32)


X4 = _rand(2, 4, 8, 8)
X3 = _rand(2, 4, 9)
X5 = _rand(1, 2, 5, 5, 5)
SEQ = _rand(2, 5, 6)

# (id, build(package) -> layer, input arrays, relaxed); each layer is
# called on the inputs, its first output compared
LAYERS = [
    # convolutions
    ("Conv1D", lambda p: p.nn.Conv1D(4, 3, 3, padding=1), [X3], False),
    ("Conv2D same stride 2", lambda p: p.nn.Conv2D(
        4, 6, 3, stride=2, padding="SAME"), [X4], False),
    ("Conv2D asymmetric", lambda p: p.nn.Conv2D(
        4, 4, 3, padding=[1, 0, 2, 1], groups=2), [X4], False),
    ("Conv2D dilated", lambda p: p.nn.Conv2D(
        4, 3, 3, padding=2, dilation=2, bias_attr=False), [X4], False),
    ("Conv3D", lambda p: p.nn.Conv3D(2, 3, 2, stride=2), [X5], False),
    ("Conv1DTranspose", lambda p: p.nn.Conv1DTranspose(
        4, 3, 3, stride=2, padding=1), [X3], False),
    ("Conv2DTranspose", lambda p: p.nn.Conv2DTranspose(
        4, 3, 3, stride=2, padding=1, output_padding=1), [X4], False),
    ("Conv3DTranspose", lambda p: p.nn.Conv3DTranspose(2, 3, 2), [X5],
     False),
    # pools
    ("MaxPool1D", lambda p: p.nn.MaxPool1D(3, 2, 1), [X3], False),
    ("AvgPool1D", lambda p: p.nn.AvgPool1D(3, 2), [X3], False),
    ("MaxPool2D", lambda p: p.nn.MaxPool2D(3, 2, 1), [X4], False),
    ("AvgPool2D exclusive", lambda p: p.nn.AvgPool2D(3, 2, 1), [X4], False),
    ("AvgPool2D inclusive", lambda p: p.nn.AvgPool2D(
        3, 2, 1, exclusive=False), [X4], False),
    ("MaxPool3D", lambda p: p.nn.MaxPool3D(2), [X5], False),
    ("AvgPool3D", lambda p: p.nn.AvgPool3D(3, 2, 1), [X5], False),
    ("AdaptiveAvgPool1D", lambda p: p.nn.AdaptiveAvgPool1D(3), [X3], False),
    ("AdaptiveAvgPool2D", lambda p: p.nn.AdaptiveAvgPool2D((3, 2)), [X4],
     False),
    ("AdaptiveAvgPool3D", lambda p: p.nn.AdaptiveAvgPool3D(2), [X5], False),
    ("AdaptiveMaxPool1D", lambda p: p.nn.AdaptiveMaxPool1D(3), [X3], False),
    ("AdaptiveMaxPool2D", lambda p: p.nn.AdaptiveMaxPool2D(4), [X4], False),
    ("AdaptiveMaxPool3D", lambda p: p.nn.AdaptiveMaxPool3D(1), [X5], False),
    ("LPPool1D", lambda p: p.nn.LPPool1D(2.0, 3, 2), [X3], False),
    ("LPPool2D", lambda p: p.nn.LPPool2D(2.0, 2), [X4], False),
    # norms
    ("BatchNorm2D eval", lambda p: p.nn.BatchNorm2D(4).eval(), [X4], False),
    ("BatchNorm1D train", lambda p: p.nn.BatchNorm1D(4), [X3], False),
    ("InstanceNorm1D", lambda p: p.nn.InstanceNorm1D(4), [X3], False),
    ("InstanceNorm2D", lambda p: p.nn.InstanceNorm2D(4), [X4], False),
    ("InstanceNorm3D", lambda p: p.nn.InstanceNorm3D(2), [X5], False),
    ("LocalResponseNorm", lambda p: p.nn.LocalResponseNorm(3), [X4], False),
    ("LayerNorm over 2 axes (T2)", lambda p: p.nn.LayerNorm([5, 6]), [SEQ],
     False),
    ("LayerNorm without weight (T2)", lambda p: p.nn.LayerNorm(
        6, weight_attr=False), [SEQ], False),
    # activations
    ("Softplus", lambda p: p.nn.Softplus(2.0, 1.0), [X3], False),
    ("PReLU", lambda p: p.nn.PReLU(4, 0.1), [X4], False),
    ("RReLU", lambda p: p.nn.RReLU(), [X3], False),
    ("Maxout", lambda p: p.nn.Maxout(2), [X4], False),
    # common
    ("AlphaDropout eval", lambda p: p.nn.AlphaDropout(0.3).eval(), [X3],
     False),
    ("Dropout2D eval", lambda p: p.nn.Dropout2D(0.3).eval(), [X4], False),
    ("Dropout3D eval", lambda p: p.nn.Dropout3D(0.3).eval(), [X5], False),
    ("Bilinear", lambda p: p.nn.Bilinear(6, 5, 3),
     [_rand(4, 6), _rand(4, 5)], False),
    ("ChannelShuffle", lambda p: p.nn.ChannelShuffle(2), [X4], False),
    ("CosineSimilarity", lambda p: p.nn.CosineSimilarity(axis=1),
     [X3, _rand(2, 4, 9, seed=1)], False),
    ("Unfold", lambda p: p.nn.Unfold(3, 2, 1), [X4], False),
    ("Fold", lambda p: p.nn.Fold([6, 6], 2, 2), [_rand(2, 8, 9)], False),
    ("Pad1D reflect", lambda p: p.nn.Pad1D([2, 1], mode="reflect"), [X3],
     False),
    ("Pad2D replicate", lambda p: p.nn.Pad2D([1, 2, 0, 1],
                                            mode="replicate"), [X4], False),
    ("Pad3D constant", lambda p: p.nn.Pad3D(1, value=0.5), [X5], False),
    ("ZeroPad1D", lambda p: p.nn.ZeroPad1D(2), [X3], False),
    ("ZeroPad2D", lambda p: p.nn.ZeroPad2D([1, 0, 2, 1]), [X4], False),
    ("ZeroPad3D", lambda p: p.nn.ZeroPad3D(1), [X5], False),
    ("PixelShuffle", lambda p: p.nn.PixelShuffle(2), [X4], False),
    ("PixelUnshuffle", lambda p: p.nn.PixelUnshuffle(2), [X4], False),
    ("Unflatten", lambda p: p.nn.Unflatten(1, [2, 2]), [X3], False),
    ("Upsample nearest", lambda p: p.nn.Upsample(scale_factor=2), [X4],
     False),
    ("Upsample bicubic down", lambda p: p.nn.Upsample(
        size=(5, 3), mode="bicubic"), [X4], False),
    ("UpsamplingBilinear2D", lambda p: p.nn.UpsamplingBilinear2D(
        size=(11, 13)), [X4], False),
    ("UpsamplingNearest2D", lambda p: p.nn.UpsamplingNearest2D(
        size=(5, 12)), [X4], False),
    # recurrent
    ("SimpleRNNCell", lambda p: p.nn.SimpleRNNCell(6, 5), [SEQ[:, 0]],
     False),
    ("LSTMCell", lambda p: p.nn.LSTMCell(6, 5), [SEQ[:, 0]], False),
    ("GRUCell", lambda p: p.nn.GRUCell(6, 5), [SEQ[:, 0]], False),
    ("SimpleRNN relu", lambda p: p.nn.SimpleRNN(6, 5, activation="relu"),
     [SEQ], True),
    ("LSTM 2 layers bidirectional", lambda p: p.nn.LSTM(
        6, 5, num_layers=2, direction="bidirect"), [SEQ], True),
    ("GRU time major", lambda p: p.nn.GRU(6, 5, time_major=True), [SEQ],
     True),
    ("RNN over LSTMCell reversed", lambda p: p.nn.RNN(
        p.nn.LSTMCell(6, 5), is_reverse=True), [SEQ], True),
    ("BiRNN over GRUCells", lambda p: p.nn.BiRNN(
        p.nn.GRUCell(6, 4), p.nn.GRUCell(6, 4)), [SEQ], True),
]


def _decoder_layer(p, before):
    return p.nn.TransformerDecoderLayer(16, 4, 32, dropout=0.0,
                                        normalize_before=before)


TGT, MEM = _rand(2, 5, 16, seed=2), _rand(2, 7, 16, seed=3)
CAUSAL = np.triu(np.full((5, 5), -np.inf, np.float32), k=1)
MEM_MASK = np.where(np.arange(7)[None, None, None, :] < np.array(
    [7, 4])[:, None, None, None], 0.0, -1e9).astype(np.float32)

LAYERS += [
    ("TransformerDecoderLayer post-LN, causal", lambda p: _decoder_layer(
        p, False), [TGT, MEM, CAUSAL], True),
    ("TransformerDecoderLayer pre-LN, memory mask", lambda p:
     _decoder_layer(p, True), [TGT, MEM, None, MEM_MASK], True),
    ("TransformerDecoder", lambda p: p.nn.TransformerDecoder(
        _decoder_layer(p, True), 2, p.nn.LayerNorm(16)), [TGT, MEM, CAUSAL],
     True),
    ("Transformer with masks", lambda p: p.nn.Transformer(
        16, 4, 2, 2, 32, dropout=0.0), [MEM, TGT, None, CAUSAL], True),
    ("Transformer pre-LN", lambda p: p.nn.Transformer(
        16, 4, 1, 1, 32, dropout=0.0, normalize_before=True), [MEM, TGT],
     True),
]

_N, _C = 4, 5
LOGP = np.log(np.random.RandomState(4).dirichlet(np.ones(_C), _N)).astype(
    np.float32)
PROB = _rand(_N, _C, lo=0.05)
LBL = _ints(_C, _N)
SIGN = np.where(_ints(2, _N, _C, seed=5) > 0, 1.0, -1.0).astype(np.float32)
BIN = _ints(2, _N, _C, seed=6).astype(np.float32)

LOSSES = [
    ("L1Loss", lambda p: p.nn.L1Loss(), [PROB, _rand(_N, _C)]),
    ("NLLLoss", lambda p: p.nn.NLLLoss(), [LOGP, LBL]),
    ("BCELoss", lambda p: p.nn.BCELoss(), [PROB, BIN]),
    ("BCEWithLogitsLoss", lambda p: p.nn.BCEWithLogitsLoss(),
     [_rand(_N, _C), BIN]),
    ("SmoothL1Loss", lambda p: p.nn.SmoothL1Loss(delta=0.5),
     [PROB, _rand(_N, _C)]),
    ("KLDivLoss", lambda p: p.nn.KLDivLoss("batchmean"), [LOGP, PROB]),
    ("MarginRankingLoss", lambda p: p.nn.MarginRankingLoss(0.2),
     [_rand(_N), _rand(_N, seed=1), SIGN[:, 0]]),
    ("HingeEmbeddingLoss", lambda p: p.nn.HingeEmbeddingLoss(),
     [PROB, SIGN]),
    ("CTCLoss", lambda p: p.nn.CTCLoss(),
     [np.log(np.random.RandomState(7).dirichlet(np.ones(5), (8, 2))).astype(
         np.float32), np.array([[1, 2, 2], [3, 1, 0]]), np.array([8, 6]),
      np.array([3, 2])]),
    ("TripletMarginLoss", lambda p: p.nn.TripletMarginLoss(swap=True),
     [_rand(_N, _C), _rand(_N, _C, seed=1), _rand(_N, _C, seed=2)]),
    ("SoftMarginLoss", lambda p: p.nn.SoftMarginLoss(), [_rand(_N, _C), SIGN]),
    ("MultiLabelSoftMarginLoss", lambda p: p.nn.MultiLabelSoftMarginLoss(),
     [_rand(_N, _C), BIN]),
    ("PoissonNLLLoss", lambda p: p.nn.PoissonNLLLoss(full=True),
     [_rand(_N, _C), np.abs(_rand(_N, _C, seed=1)) * 3]),
    ("GaussianNLLLoss", lambda p: p.nn.GaussianNLLLoss(full=True),
     [_rand(_N, _C), _rand(_N, _C, seed=1), PROB]),
    ("PairwiseDistance", lambda p: p.nn.PairwiseDistance(3.0),
     [_rand(_N, _C), _rand(_N, _C, seed=1)]),
    ("RNNTLoss", lambda p: p.nn.RNNTLoss(),
     [_rand(2, 4, 3, 5), np.array([[1, 2], [3, 0]]), np.array([4, 3]),
      np.array([2, 1])]),
    ("CosineEmbeddingLoss", lambda p: p.nn.CosineEmbeddingLoss(0.1),
     [_rand(_N, _C), _rand(_N, _C, seed=1), SIGN[:, 0]]),
    ("TripletMarginWithDistanceLoss", lambda p:
     p.nn.TripletMarginWithDistanceLoss(margin=0.5),
     [_rand(_N, _C), _rand(_N, _C, seed=1), _rand(_N, _C, seed=2)]),
    ("MultiMarginLoss", lambda p: p.nn.MultiMarginLoss(p=2, margin=0.7),
     [_rand(_N, _C), LBL]),
    ("AdaptiveLogSoftmaxWithLoss", lambda p:
     p.nn.AdaptiveLogSoftmaxWithLoss(6, 10, [3, 6], div_value=2.0),
     [_rand(_N, 6), _ints(10, _N, seed=8)]),
]
CASES = [(n, b, a, r) for n, b, a, r in LAYERS] + [
    (n, b, a, False) for n, b, a in LOSSES]


def _pair(build):
    with numpy_init(7):
        ref = build(jp)
    mine = build(tp)
    load_reference_layer(mine, ref.state_dict())
    return ref, mine


@functools.lru_cache(maxsize=None)
def _pairs():
    """{case: (jax layer, port layer)}, each built once."""
    return {name: _pair(build) for name, build, _, _ in CASES}


def _first(out):
    while isinstance(out, (tuple, list)):
        out = out[0]
    return out


def _is_float(a):
    return a is not None and np.asarray(a).dtype.kind == "f"


def _trainable(arrays):
    """The inputs whose gradients are compared: floats, not masks."""
    return [i for i, a in enumerate(arrays)
            if _is_float(a) and not np.isinf(a).any() and (
                a.ndim < 4 or a.shape[1] != 1)]


def _run(layer, arrays):
    fl = _trainable(arrays)
    xs = [None if a is None else tp.to_tensor(a, stop_gradient=i not in fl)
          for i, a in enumerate(arrays)]
    out = _first(layer(*xs))
    ct = tp.to_tensor(_cotangent(out.shape))
    (out * ct).sum().backward()
    # an input the output does not depend on (a loss's label) takes no
    # gradient in torch and a zero one in jax
    return (np.asarray(out.numpy(), np.float64),
            [np.zeros_like(arrays[i]) if xs[i].grad is None
             else xs[i].grad.numpy() for i in fl])


def _reference_fn(name, ref):
    """(output, input gradients) of JAX layer `ref` as a function of the
    case's arrays."""
    params, buffers = extract_state(ref)
    fl = _trainable(dict(CASES_BY_NAME)[name])

    def run(xs):
        def fwd(*fx):
            full = list(xs)
            for i, v in zip(fl, fx):
                full[i] = v
            out, _ = call_functional(ref, params, buffers, tuple(full),
                                     training=ref.training)
            return _first(out)

        out, vjp = jax.vjp(fwd, *[xs[i] for i in fl])
        return out, vjp(jnp.asarray(_cotangent(out.shape)))

    return run


@functools.lru_cache(maxsize=None)
def _references():
    """Every case's (output, input gradients) from the JAX layers, in one
    jitted program (a case that does not trace gets its own)."""
    fns = {name: _reference_fn(name, _pairs()[name][0])
           for name, _, _, _ in CASES}
    arrays = {name: [None if a is None else jnp.asarray(a) for a in arrs]
              for name, _, arrs, _ in CASES}
    try:
        return jax.device_get(jax.jit(lambda d: {
            n: fn(d[n]) for n, fn in fns.items()})(arrays))
    except Exception:   # noqa: BLE001 - one case spoils the program
        pass
    res = {}
    for n, fn in fns.items():
        try:
            res[n] = jax.device_get(jax.jit(fn)(arrays[n]))
        except Exception as e:   # noqa: BLE001 - raised by its own case
            res[n] = e
    return res


CASES_BY_NAME = [(n, a) for n, _, a, _ in CASES]


@pytest.mark.parametrize("name,build,arrays,relaxed", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_reference(name, build, arrays, relaxed):
    res = _references()[name]
    if isinstance(res, Exception):
        raise res
    want, want_g = res
    mine = _pairs()[name][1]
    got, got_g = _run(mine, arrays)
    fwd, grad = (RELAXED_FWD, RELAXED_GRAD) if relaxed else (FWD, GRAD)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), **fwd)
    assert len(got_g) == len(want_g)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, np.asarray(w), **grad)


# ------------------------------------------------------------ BatchNorm
def test_batch_norm_two_train_steps_then_eval():
    """Two training forwards blend the running stats (momentum 0.9, the
    biased batch variance) as the reference's, the parameters' gradients
    agree, and an eval forward normalizes by the running stats."""
    ref, mine = _pair(lambda p: p.nn.BatchNorm2D(4, momentum=0.8))
    params, buffers = extract_state(ref)
    xs = [_rand(3, 4, 5, 5, seed=s) * (1 + s) + s for s in range(2)]
    ct = _cotangent((3, 4, 5, 5))

    @jax.jit
    def step(params, buffers, x):
        def loss(p):
            out, nb = call_functional(ref, p, buffers, (x,), training=True)
            return jnp.sum(out * ct), nb

        (_, nb), g = jax.value_and_grad(loss, has_aux=True)(params)
        return nb, g

    for x in xs:
        buffers, grads = step(params, buffers, jnp.asarray(x))
        mine.clear_gradients()
        out = mine(tp.to_tensor(x))
        (out * tp.to_tensor(ct)).sum().backward()
        for name, p in mine.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[name], **GRAD)
        for name, b in mine.named_buffers():
            np.testing.assert_allclose(b.numpy(), buffers[name], **FWD)
    mine.eval()
    want, _ = jax.jit(lambda b, x: call_functional(
        ref, params, b, (x,), training=False))(buffers, jnp.asarray(xs[0]))
    np.testing.assert_allclose(mine(tp.to_tensor(xs[0])).numpy(),
                               np.asarray(want), **FWD)


def test_group_norm_matches_the_reference_op():
    """GroupNorm with its affine weights against the reference's
    group_norm op (the JAX GroupNorm layer passes its weight where the op
    takes num_groups, so it cannot run with weights)."""
    from paddle_tpu.ops.registry import get_op

    layer = tp.nn.GroupNorm(2, 4)
    with torch.no_grad():
        layer.weight._t.copy_(torch.arange(1.0, 5.0))
        layer.bias._t.copy_(torch.arange(4.0) / 10)
    x = tp.to_tensor(X4, stop_gradient=False)
    out = layer(x)
    want, vjp = jax.vjp(lambda v: get_op("group_norm").fn(
        v, 2, jnp.arange(1.0, 5.0), jnp.arange(4.0) / 10), jnp.asarray(X4))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **FWD)
    ct = _cotangent(X4.shape)
    (out * tp.to_tensor(ct)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), **GRAD)


def test_sync_batch_norm_is_batch_norm_in_a_world_of_one():
    net = tp.nn.Sequential(tp.nn.Conv2D(4, 4, 1), tp.nn.BatchNorm2D(4))
    x = tp.to_tensor(X4)
    want = net(x).numpy()
    conv = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], tp.nn.SyncBatchNorm)
    assert conv[1].weight is net[1].weight
    np.testing.assert_allclose(conv(x).numpy(), want, **FWD)


# ---------------------------------------------------- T2 and attention
def test_functional_norms_route_around_the_kernels_as_the_reference():
    """layer_norm over 2 axes or without a weight, and rms_norm without a
    weight, take the plain op (the refusals of the earlier slices are
    gone), matching the reference's functionals."""
    x = _rand(2, 3, 4, 6)
    w, b = _rand(4, 6, seed=1), _rand(4, 6, seed=2)
    cases = [
        (lambda F, t: F.layer_norm(t(x), [4, 6], t(w), t(b))),
        (lambda F, t: F.layer_norm(t(x), 6)),
        (lambda F, t: F.layer_norm(t(x), [6], None, t(b[0]))),
        (lambda F, t: F.rms_norm(t(x))),
    ]
    for fn in cases:
        got = fn(tp.nn.functional, tp.to_tensor).numpy()
        want = fn(jp.nn.functional, jp.to_tensor).numpy()
        np.testing.assert_allclose(got, want, **FWD)


def test_flash_attention_functional():
    q, k, v = (_rand(2, 6, 2, 8, seed=s) for s in range(3))
    got, soft = tp.nn.functional.flash_attention(
        *map(tp.to_tensor, (q, k, v)), causal=True)
    want, _ = jp.nn.functional.flash_attention(
        *map(jp.to_tensor, (q, k, v)), causal=True)
    assert soft is None
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    F = tp.nn.functional
    with pytest.raises(NotImplementedError):
        F.flash_attention(*map(tp.to_tensor, (q, k, v)), return_softmax=True)
    with pytest.raises(NotImplementedError):
        F.flash_attention(*map(tp.to_tensor, (q, k, v)), dropout=0.1,
                          rng_name="x")
    with pytest.raises(NotImplementedError):
        F.flash_attn_unpadded(q, k, v, None, None, 6, 6)


def test_sdpa_takes_bool_and_2d_masks():
    q, k, v = (_rand(2, 5, 2, 4, seed=s) for s in range(3))
    keep = np.tril(np.ones((5, 5), bool))
    F = tp.nn.functional
    args = [tp.to_tensor(a) for a in (q, k, v)]
    causal = F.scaled_dot_product_attention(*args, is_causal=True).numpy()
    for mask in (keep, np.where(keep, 0.0, -np.inf).astype(np.float32)):
        got = F.scaled_dot_product_attention(*args, tp.to_tensor(mask))
        np.testing.assert_allclose(got.numpy(), causal, **FWD)


def test_square_subsequent_mask_matches_the_reference():
    got = tp.nn.Transformer.generate_square_subsequent_mask(4).numpy()
    want = jp.nn.Transformer.generate_square_subsequent_mask(4).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- recurrent
def test_rnn_sequence_length_masks_padding():
    """nn.RNN over a cell with sequence_length: padded steps emit zeros
    and keep the state, a reversed run starts at each sample's last
    valid step (the reference's semantics)."""
    lengths = np.array([5, 3])
    build = lambda p: p.nn.BiRNN(p.nn.LSTMCell(6, 4), p.nn.LSTMCell(6, 4))
    ref, mine = _pair(build)
    want = ref(jp.to_tensor(SEQ), sequence_length=jp.to_tensor(lengths))
    got = mine(tp.to_tensor(SEQ), sequence_length=tp.to_tensor(lengths))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               **RELAXED_FWD)
    assert np.all(got[0].numpy()[1, 3:] == 0)
    with pytest.raises(NotImplementedError):
        tp.nn.GRU(6, 4)(tp.to_tensor(SEQ),
                        sequence_length=tp.to_tensor(lengths))


def test_lstm_initial_states_and_final_states():
    net = tp.nn.LSTM(6, 5, num_layers=2)
    h0 = tp.to_tensor(_rand(2, 2, 5, seed=3))
    c0 = tp.to_tensor(_rand(2, 2, 5, seed=4))
    out, (h, c) = net(tp.to_tensor(SEQ), (h0, c0))
    assert out.shape == [2, 5, 5] and h.shape == [2, 2, 5]
    np.testing.assert_allclose(h.numpy()[1], out.numpy()[:, -1], **FWD)
    out0, _ = net(tp.to_tensor(SEQ))
    assert not np.allclose(out.numpy(), out0.numpy())


# --------------------------------------------------------- nn.utils
def test_weight_norm_matches_reference_and_removes():
    U = tp.nn.utils
    ref, mine = _pair(lambda p: p.nn.Linear(6, 4))
    jp.nn.utils.weight_norm(ref, dim=1)
    U.weight_norm(mine, dim=1)
    assert sorted(mine.state_dict()) == sorted(ref.state_dict())
    load_reference_layer(mine, ref.state_dict())
    x = _rand(3, 6)
    np.testing.assert_allclose(mine(tp.to_tensor(x)).numpy(),
                               ref(jp.to_tensor(x)).numpy(), **FWD)
    out = mine(tp.to_tensor(x))
    out.sum().backward()
    assert mine.weight_g.grad is not None and mine.weight_v.grad is not None
    with pytest.raises(ValueError):
        U.weight_norm(mine, dim=1)
    before = mine(tp.to_tensor(x)).numpy()
    U.remove_weight_norm(mine)
    assert sorted(mine.state_dict()) == ["bias", "weight"]
    np.testing.assert_allclose(mine(tp.to_tensor(x)).numpy(), before,
                               **FWD)


def test_spectral_norm_matches_reference():
    U = tp.nn.utils
    ref, mine = _pair(lambda p: p.nn.Linear(6, 4))
    jp.nn.utils.spectral_norm(ref, n_power_iterations=3)
    U.spectral_norm(mine, n_power_iterations=3)
    x = _rand(3, 6)
    for _ in range(2):      # training forwards refresh u / v alike
        np.testing.assert_allclose(mine(tp.to_tensor(x)).numpy(),
                                   ref(jp.to_tensor(x)).numpy(),
                                   **RELAXED_FWD)
    for name in ("weight_u", "weight_v"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   getattr(ref, name).numpy(),
                                   **RELAXED_FWD)
    mine.eval()
    u = mine.weight_u.numpy().copy()
    mine(tp.to_tensor(x))
    np.testing.assert_array_equal(mine.weight_u.numpy(), u)
    w = mine.weight_orig.numpy()
    sigma = np.linalg.svd(w.T, compute_uv=False)[0]
    layer = tp.nn.SpectralNorm([6, 4], dim=1, power_iters=50)
    np.testing.assert_allclose(
        layer(tp.to_tensor(w)).numpy(), w / sigma, rtol=1e-4, atol=1e-5)


def test_parameter_vector_roundtrip_and_clips():
    U = tp.nn.utils
    net = tp.nn.Linear(3, 2)
    vec = U.parameters_to_vector(net.parameters())
    assert vec.shape == [8]
    U.vector_to_parameters(vec * 2.0, net.parameters())
    np.testing.assert_allclose(U.parameters_to_vector(
        net.parameters()).numpy(), vec.numpy() * 2.0)
    net(tp.to_tensor(_rand(4, 3) * 100)).sum().backward()
    U.clip_grad_value_(net.parameters(), 0.5)
    assert all(np.abs(p.grad.numpy()).max() <= 0.5
               for p in net.parameters())
    total = U.clip_grad_norm_(net.parameters(), 0.1)
    assert float(total) > 0.1
    norm = np.sqrt(sum((p.grad.numpy() ** 2).sum()
                       for p in net.parameters()))
    assert abs(norm - 0.1) < 1e-4


# ------------------------------------------------------------ losses
def test_loss_scenarios_of_the_reference_tests():
    """test_losses2.py's checks on the port: CTC's mean is over label
    lengths then batch, focal and dice at their edges, RNN-T refuses
    FastEmit, margin CE lowers the target logit's probability."""
    F = tp.nn.functional
    lp = tp.to_tensor(LOSSES[8][2][0])
    args = [tp.to_tensor(a) for a in LOSSES[8][2][1:]]
    per = F.ctc_loss(lp, *args, reduction="none").numpy()
    mean = F.ctc_loss(lp, *args).numpy()
    np.testing.assert_allclose(mean, np.mean(per / np.array([3, 2])),
                               rtol=1e-6)
    probs = np.eye(3, dtype=np.float32)[None].repeat(2, 0)
    lab = np.array([[[0], [1], [2]]] * 2)
    assert float(F.dice_loss(tp.to_tensor(probs), tp.to_tensor(lab))) < 1e-4
    with pytest.raises(NotImplementedError):
        F.rnnt_loss(*[tp.to_tensor(a) for a in LOSSES[15][2]],
                    fastemit_lambda=0.1)
    logits = tp.to_tensor(np.full((1, 3), 0.5, np.float32))
    plain = F.softmax(logits * 64.0).numpy()[0, 0]
    m = F.margin_cross_entropy(logits, tp.to_tensor(np.array([0])),
                               return_softmax=True)[1].numpy()[0, 0]
    assert m < plain
    x, y = tp.to_tensor(_rand(3, 4)), tp.to_tensor(_rand(3, 4, seed=1))
    np.testing.assert_allclose(
        F.huber_loss(x, y, delta=0.3).numpy(),
        jp.nn.functional.huber_loss(jp.to_tensor(x.numpy()),
                                    jp.to_tensor(y.numpy()),
                                    delta=0.3).numpy(), **FWD)
    soft = F.soft_margin_loss(tp.to_tensor(np.array([200.0, -200.0])),
                              tp.to_tensor(np.array([-1.0, 1.0])))
    assert np.isfinite(soft.numpy())


@pytest.mark.parametrize("name,call", [
    ("gumbel_softmax", lambda F, x: F.gumbel_softmax(x, hard=True)),
    ("alpha_dropout", lambda F, x: F.alpha_dropout(x, 0.4)),
    ("dropout2d", lambda F, x: F.dropout2d(x.reshape([2, 4, 3, 1]), 0.5)),
])
def test_random_functionals_keep_their_laws(name, call):
    x = tp.to_tensor(np.abs(_rand(2, 12)) + 0.1)
    tp.seed(3)
    out = call(tp.nn.functional, x).numpy()
    if name == "gumbel_softmax":
        assert np.all(out.sum(-1) == 1) and set(np.unique(out)) <= {0, 1}
    elif name == "alpha_dropout":
        dropped = np.isclose(out, out.min())
        assert 0 < dropped.mean() < 1
    else:
        per_map = out.reshape(2, 4, 3)
        assert all(np.all(m == 0) or np.all(m != 0) for m in
                   per_map.reshape(8, 3))


def test_misc_functionals_match_the_reference():
    F, J = tp.nn.functional, jp.nn.functional
    x = _rand(2, 3, 4)
    lens = np.array([2, 0, 3])
    np.testing.assert_array_equal(
        F.sequence_mask(tp.to_tensor(lens), 4).numpy(),
        J.sequence_mask(jp.to_tensor(lens), 4).numpy())
    np.testing.assert_allclose(F.normalize(tp.to_tensor(x), p=3).numpy(),
                               J.normalize(jp.to_tensor(x), p=3).numpy(),
                               **FWD)
    np.testing.assert_allclose(
        F.zeropad2d(tp.to_tensor(X4), [1, 2, 0, 1]).numpy(),
        J.zeropad2d(jp.to_tensor(X4), [1, 2, 0, 1]).numpy())
    logits = _rand(4, 5)
    got = F.softmax_with_cross_entropy(tp.to_tensor(logits),
                                       tp.to_tensor(LBL[:, None]))
    want = J.softmax_with_cross_entropy(jp.to_tensor(logits),
                                        jp.to_tensor(LBL[:, None]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD)
    out, idx = F.max_pool2d(tp.to_tensor(X4), 2, return_mask=True)
    back = F.max_unpool2d(out, idx, 2)
    np.testing.assert_allclose(back.numpy(), J.max_unpool2d(
        *J.max_pool2d(jp.to_tensor(X4), 2, return_mask=True), 2).numpy())


# --------------------------------------- tests/test_nn.py's scenarios
def _conv_simple():
    conv = tp.nn.Conv2D(1, 1, 2, bias_attr=False)
    conv.weight.set_value(np.ones((1, 1, 2, 2), "float32"))
    x = np.arange(9, dtype="float32").reshape(1, 1, 3, 3)
    np.testing.assert_allclose(conv(tp.to_tensor(x)).numpy(),
                               [[[[8, 12], [20, 24]]]])


def _shapes():
    assert tp.nn.Conv2D(4, 8, 3, groups=2, padding=1)(
        tp.randn([2, 4, 5, 5])).shape == [2, 8, 5, 5]
    assert tp.nn.Conv2DTranspose(3, 6, 4, stride=2, padding=1)(
        tp.randn([2, 3, 8, 8])).shape == [2, 6, 16, 16]
    out, (h, c) = tp.nn.LSTM(4, 8)(tp.randn([2, 6, 4]))
    assert out.shape == [2, 6, 8] and h.shape == [1, 2, 8] == c.shape
    out, h = tp.nn.GRU(4, 8, direction="bidirect")(tp.randn([2, 6, 4]))
    assert out.shape == [2, 6, 16] and h.shape == [2, 2, 8]
    x = tp.randn([1, 3, 4, 4])
    F = tp.nn.functional
    assert F.interpolate(x, scale_factor=2).shape == [1, 3, 8, 8]
    assert F.interpolate(x, size=[2, 2], mode="bilinear").shape == \
        [1, 3, 2, 2]
    assert tp.nn.AdaptiveAvgPool2D(1)(x).shape == [1, 3, 1, 1]


def _batch_norm():
    bn = tp.nn.BatchNorm2D(3, momentum=0.5)
    x = tp.randn([8, 3, 4, 4])
    out = bn(x)
    np.testing.assert_allclose(out.numpy().mean(axis=(0, 2, 3)), 0,
                               atol=1e-4)
    assert not np.allclose(bn._mean.numpy(), 0)
    assert bn._mean.stop_gradient and "_mean" in bn.state_dict()
    bn.eval()
    assert bn(x).shape == [8, 3, 4, 4]


def _pools():
    x = tp.to_tensor(np.arange(16, dtype="float32").reshape(1, 1, 4, 4))
    np.testing.assert_allclose(tp.nn.MaxPool2D(2)(x).numpy().reshape(-1),
                               [5, 7, 13, 15])
    np.testing.assert_allclose(tp.nn.AvgPool2D(2)(x).numpy().reshape(-1),
                               [2.5, 4.5, 10.5, 12.5])


def _grads_flow():
    net = tp.nn.Sequential(tp.nn.Conv2D(3, 4, 3), tp.nn.BatchNorm2D(4),
                           tp.nn.ReLU(), tp.nn.AdaptiveAvgPool2D(1),
                           tp.nn.Flatten(), tp.nn.Linear(4, 2))
    net(tp.randn([2, 3, 6, 6])).sum().backward()
    assert all(p.grad is not None for p in net.parameters())


@pytest.mark.parametrize("scenario", [_conv_simple, _shapes, _batch_norm,
                                      _pools, _grads_flow],
                         ids=lambda f: f.__name__.strip("_"))
def test_reference_nn_scenarios(scenario):
    scenario()
