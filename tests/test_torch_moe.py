"""paddle_tpu_torch's MoE layer and its row gather (K9's plain version)
against the JAX package's, on the CPU, on the same inputs and weights.

Inputs come from numpy seeds; weights cross by `load_reference_state`
(the gate untransposed, the experts' Linears transposed). The reference's
Pallas gather runs in interpret mode (`interpret=True`, and
`fused=True` inside `_routed_forward`).

- `gather_rows`: the three cases of tests/test_moe_fused.py::TestGatherRows
  (empty slots, odd sizes, the gradient as a scatter-add) in fp32 and
  bf16: exact, since both copy rows and add exact small integers.
- `moe_dispatch_indices`: exact.
- `_routed_forward` (the port's gather path) against each of the
  reference's branches, gather (`fused=True`) and einsum (`fused=False`),
  for GShard top-2, Switch top-1 and Naive top-2, at a capacity
  that drops tokens and one that drops none: the forward within rtol / atol
  1e-5 and aux within rtol 1e-6, the gradients of x, the gate and every
  expert parameter within rtol 1e-4 / atol 1e-5 (the reference's own test's
  tolerances).
- One train step at fp32 (`make_moe_train_step`'s composition without its
  O1) against the reference's eager `moe(x)`, `mse_loss + 0.01 *
  aux_loss`, `backward` and `paddle_tpu.optimizer.Adam`: the loss within
  1e-6, every gradient within rtol 1e-4 / atol 1e-6, every parameter after
  the update within atol 1e-6. `make_moe_train_step` itself (O1 bf16)
  against the reference under O1: the loss within 2e-2 relative and every
  gradient's cosine above 0.99.
- The port alone: parameter names, the default device, the launch counter
  on CPU tensors, `mse_loss`.
- Expert parallelism: `expert_parallel_forward` over 4 gloo processes
  (`distributed.spawn`, one world for the module) against the port's
  single-rank layer run over each rank's tokens in turn and against the
  reference's `expert_parallel_forward` over 4 fake devices, at a capacity
  that drops nothing: the rows, the aux loss and every gradient (the
  gate's summed over the ranks, each expert's on its owner only) within
  the `_routed_forward` tolerances; the raise when the experts or the
  tokens do not divide over the ranks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import tape as tape_mod
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.distributed.models.moe import MoELayer as JMoELayer
from paddle_tpu.jit.functional import bind_state, extract_state
from paddle_tpu.ops import pallas_kernels as pk

import _torch_ranks as ranks
from paddle_tpu_torch import amp
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.incubate.distributed.models import moe
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.nn import torch_functional as F
from paddle_tpu_torch.ops import moe_dispatch as md
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.training import make_moe_train_step
from paddle_tpu_torch.weights import load_reference_state

D, H, E, T = 16, 32, 4, 32          # d_model, d_ff, experts, tokens
LR = 1e-4
GATES = {"gshard": {"type": "gshard", "top_k": 2},
         "switch": {"type": "switch", "top_k": 1},
         "naive": {"type": "naive", "top_k": 2}}
# capacity factors: 0.5 drops tokens at every gate, 4.0 none
CAPACITY = {"drops": 0.5, "no drops": 4.0}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ gather_rows

def _gather_case(case):
    """(src, idx) of tests/test_moe_fused.py::TestGatherRows."""
    if case == "empty slots":
        src = np.random.RandomState(0).randn(37, 12).astype(np.float32)
        return src, np.array([3, 0, -1, 36, 7, 7, -1, 20], np.int32)
    if case == "odd sizes":
        rng = np.random.RandomState(2)
        src = rng.randn(301, 9).astype(np.float32)
        return src, rng.randint(-1, 301, 413).astype(np.int32)
    src = np.random.RandomState(1).randn(16, 8).astype(np.float32)
    return src, np.array([5, 5, -1, 0, 15], np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["empty slots", "odd sizes"])
def test_gather_rows_matches_reference(case, dtype):
    src, idx = _gather_case(case)
    jdt, tdt = DTYPES[dtype]
    ref = pk.gather_rows(jnp.asarray(src, jdt), jnp.asarray(idx),
                         interpret=True)
    got = md.gather_rows(torch.from_numpy(src).to(tdt),
                         torch.from_numpy(idx))
    assert got.dtype == tdt and got.shape == (len(idx), src.shape[1])
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert (got[torch.from_numpy(idx) < 0] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_rows_gradient_is_the_reference_scatter_add(dtype):
    src, idx = _gather_case("gradient")
    jdt, tdt = DTYPES[dtype]
    w = np.arange(1.0, 6.0, dtype=np.float32)[:, None]
    ref = jax.grad(lambda s: (pk.gather_rows(s, jnp.asarray(idx),
                                             interpret=True)
                              * jnp.asarray(w, jdt)).sum())(
        jnp.asarray(src, jdt))
    s = torch.from_numpy(src).to(tdt).requires_grad_()
    (md.gather_rows(s, torch.from_numpy(idx).long())
     * torch.from_numpy(w).to(tdt)).sum().backward()
    assert s.grad.dtype == tdt
    np.testing.assert_array_equal(s.grad.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    assert float(s.grad[5, 0]) == 1 + 2 and float(s.grad[1].abs().sum()) == 0


def test_gather_rows_plain_version_raises_past_the_end():
    src = torch.zeros(4, 3)
    with pytest.raises(IndexError):
        md.gather_rows(src, torch.tensor([0, 4], dtype=torch.int32))


def test_moe_dispatch_indices_match_reference():
    """Token-major queues of 40 tokens x 2 distinct experts over 4 experts
    (loads 17, 23, 21, 19) of capacity 20: some pairs past capacity, some
    slots empty."""
    rng = np.random.RandomState(3)
    t, k, e, c = 40, 2, 4, 20
    topi = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    counts = np.zeros(e, np.int64)
    pos = np.zeros((t, k), np.int32)
    for i in range(t):
        for j in range(k):
            pos[i, j] = counts[topi[i, j]]
            counts[topi[i, j]] += 1
    keep = (pos < c).astype(np.float32)
    assert 0 < keep.sum() < t * k
    rs, rt = pk.moe_dispatch_indices(jnp.asarray(topi), jnp.asarray(pos),
                                     jnp.asarray(keep), e, c)
    gs, gt = md.moe_dispatch_indices(torch.from_numpy(topi),
                                     torch.from_numpy(pos),
                                     torch.from_numpy(keep), e, c)
    assert gs.dtype == gt.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    assert (gs < 0).any() and (gt < 0).any()


# ----------------------------------------------------------- the MoE layer

def _ref_layer(gate, act="gelu", seed=0):
    paddle.seed(seed)
    act_cls = jnn.GELU if act == "gelu" else jnn.ReLU
    experts = [jnn.Sequential(jnn.Linear(D, H), act_cls(), jnn.Linear(H, D))
               for _ in range(E)]
    return JMoELayer(d_model=D, experts=experts, gate=dict(GATES[gate]))


def _port_layer(gate, ref, act="gelu"):
    act_cls = torch.nn.GELU if act == "gelu" else torch.nn.ReLU
    experts = [torch.nn.Sequential(Linear(D, H), act_cls(), Linear(H, D))
               for _ in range(E)]
    layer = moe.MoELayer(D, experts, gate=dict(GATES[gate]), device="cpu")
    load_reference_state(layer, extract_state(ref)[0])
    return layer


def _linear_names(model):
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def _port_grads(layer):
    lin = _linear_names(layer)
    return {n: (p.grad.numpy().T if n in lin else p.grad.numpy())
            for n, p in layer.named_parameters()}


def _x_and_cotangent():
    rng = np.random.RandomState(7)
    return (rng.randn(T, D).astype(np.float32),
            rng.randn(T, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _ref_routed(gate, capacity, fused):
    """((y, aux, loss), grads of x and of every parameter) of the reference
    `_routed_forward`, loss = sum(y * cotangent) + aux."""
    layer = _ref_layer(gate)
    layer.capacity_factor = CAPACITY[capacity]
    names = [n for n, _ in layer.named_parameters()]
    x, ct = _x_and_cotangent()

    def f(xd, *pdatas):
        bound = dict(zip(names, pdatas))

        def expert_run(expert_in):
            with bind_state(layer, bound, {}), tape_mod.no_grad():
                return jnp.stack([ex(Tensor(expert_in[i]))._data
                                  for i, ex in enumerate(layer.experts)])

        y, aux = layer._routed_forward(xd, bound["gate.gate_weight"],
                                       expert_run, fused=fused)
        return jnp.sum(y * ct) + aux, (y, aux)

    pdatas = [p._data for _, p in layer.named_parameters()]
    (loss, (y, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(1 + len(names))), has_aux=True))(
        jnp.asarray(x), *pdatas)
    return ((np.asarray(y), float(aux), float(loss)),
            {"x": np.asarray(grads[0]),
             **{n: np.asarray(g) for n, g in zip(names, grads[1:])}})


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("ref_fused", [True, False],
                         ids=["reference gather", "reference einsum"])
def test_routed_forward_and_grads_match_reference(gate, capacity,
                                                  ref_fused):
    layer = _port_layer(gate, _ref_layer(gate))
    layer.capacity_factor = CAPACITY[capacity]
    x, ct = _x_and_cotangent()
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = layer._routed_forward(xt, layer.gate.gate_weight,
                                   layer._run_experts)
    ((y * torch.from_numpy(ct)).sum() + aux).backward()
    grads = {"x": xt.grad.numpy(), **_port_grads(layer)}
    _, tok_slot, _ = layer.dispatch_indices(xt)
    assert bool((tok_slot < 0).any()) == (capacity == "drops")
    (ry, raux, _), rgrads = _ref_routed(gate, capacity, ref_fused)
    np.testing.assert_allclose(y.detach().numpy(), ry, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), raux, rtol=1e-6)
    assert grads.keys() == rgrads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g, rgrads[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert np.abs(grads["gate.gate_weight"]).max() > 0


# ----------------------------------------------------------- the train step

STEP_B, STEP_S = 2, 12


def _step_data():
    rng = np.random.RandomState(11)
    return (rng.randn(STEP_B, STEP_S, D).astype(np.float32),
            rng.randn(STEP_B, STEP_S, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _ref_step(o1):
    """(loss, grads, params before, params after one Adam update) of the
    reference's eager MoE step with ReLU experts (Switch's FFN)."""
    layer = _ref_layer("gshard", act="relu", seed=5)
    layer.train()
    before = {n: np.asarray(v) for n, v in extract_state(layer)[0].items()}
    x, target = _step_data()
    xt, tt = paddle.to_tensor(x), paddle.to_tensor(target)
    if o1:
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = JF.mse_loss(layer(xt), tt) + 0.01 * layer.aux_loss
    else:
        loss = JF.mse_loss(layer(xt), tt) + 0.01 * layer.aux_loss
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy())
             for n, p in layer.named_parameters()}
    opt = paddle.optimizer.Adam(learning_rate=LR,
                                parameters=layer.parameters())
    opt.step()
    after = {n: np.asarray(p.numpy()) for n, p in layer.named_parameters()}
    return float(loss.numpy()), grads, before, after


class _RecordingAdam(Adam):
    """The port's Adam, keeping the gradients it was given."""

    def step(self, closure=None):
        self.seen = {id(p): p.grad.detach().clone()
                     for g in self.param_groups for p in g["params"]}
        return super().step(closure)


def _port_step(o1):
    ref = _ref_layer("gshard", act="relu", seed=5)
    layer = _port_layer("gshard", ref, act="relu")
    opt = _RecordingAdam(learning_rate=LR, parameters=layer.parameters())
    if o1:
        step = make_moe_train_step(layer, opt)
    else:       # the same composition at fp32, built by hand
        def step(x, target):
            layer.train()
            loss = F.mse_loss(layer(x), target) + 0.01 * layer.aux_loss
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            return loss.detach()
    x, target = _step_data()
    loss = step(torch.from_numpy(x), torch.from_numpy(target))
    lin = _linear_names(layer)
    grads, after = {}, {}
    for n, p in layer.named_parameters():
        g, v = opt.seen[id(p)].numpy(), p.detach().numpy()
        grads[n], after[n] = (g.T, v.T) if n in lin else (g, v)
    assert all(p.grad is None for p in layer.parameters())   # dropped
    return float(loss), grads, after


def test_fp32_train_step_matches_reference():
    ref_loss, ref_grads, _, ref_after = _ref_step(False)
    loss, grads, after = _port_step(False)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=1e-6)
    assert grads.keys() == ref_grads.keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)
        np.testing.assert_allclose(after[n], ref_after[n], rtol=0,
                                   atol=1e-6, err_msg=n)
    assert np.abs(grads["gate.gate_weight"]).max() > 0


def test_o1_train_step_holds_within_bf16_bounds():
    ref_loss, ref_grads, _, _ = _ref_step(True)
    loss, grads, _ = _port_step(True)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
    for n, g in grads.items():
        r = ref_grads[n].astype(np.float64).ravel()
        gg = g.astype(np.float64).ravel()
        if not np.any(r):
            assert not np.any(gg), n        # an expert no token reached
            continue
        cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
        assert cos > 0.99, (n, cos)


def test_o1_routes_in_fp32_and_combines_bf16_rows():
    """Under O1 the gate product stays fp32 (the reference's raw `@`), the
    experts run in bf16, so the combine gathers bf16 rows, and y is fp32."""
    ref = _ref_layer("gshard", act="relu", seed=5)
    layer = _port_layer("gshard", ref, act="relu")
    seen = []
    orig = md.GatherRows.forward

    def spy(ctx, src, idx):
        seen.append(src.dtype)
        return orig(ctx, src, idx)

    x, target = _step_data()
    md.GatherRows.forward = staticmethod(spy)
    try:
        with amp.auto_cast(level="O1"):
            y = layer(torch.from_numpy(x))
    finally:
        md.GatherRows.forward = staticmethod(orig)
    assert seen == [torch.float32, torch.bfloat16]
    assert y.dtype == torch.float32 and layer.aux_loss.dtype == torch.float32


# ------------------------------------------------------------ the port alone

def test_parameter_names_match_the_reference():
    ref = _ref_layer("gshard", act="relu")
    params = extract_state(ref)[0]
    layer = _port_layer("gshard", ref, act="relu")
    own = dict(layer.named_parameters())
    assert set(own) == set(params)
    assert "gate.gate_weight" in own and "experts.3.2.bias" in own
    # the gate crosses untransposed, the experts' Linears transposed
    np.testing.assert_array_equal(own["gate.gate_weight"].detach().numpy(),
                                  np.asarray(params["gate.gate_weight"]))
    assert own["gate.gate_weight"].shape == (D, E)
    np.testing.assert_array_equal(
        own["experts.1.0.weight"].detach().numpy(),
        np.asarray(params["experts.1.0.weight"]).T)


def test_gates_and_capacity_factors_follow_the_reference():
    experts = [Linear(D, D) for _ in range(E)]
    for gate, k, cf in (("gshard", 2, 1.2), ("switch", 1, 1.2),
                        ("naive", 2, 2.0)):
        layer = moe.MoELayer(D, experts, gate=dict(GATES[gate], top_k=3),
                             device="cpu")
        want_k = {"gshard": 2, "switch": 1, "naive": 3}[gate]
        assert layer.gate.topk == want_k and layer.capacity_factor == cf
    sw = moe.SwitchGate(D, num_expert=E, capacity=(1.25, 2.0), device="cpu")
    assert moe.MoELayer(D, experts, gate=sw, device="cpu"
                        ).capacity_factor == 1.25
    # Switch-Base-8's cells: C = 4916 (GShard top-2, 1.2) and 2560
    # (Switch top-1, 1.25) for 16384 tokens over 8 experts
    big = [Linear(8, 8) for _ in range(8)]
    for gate, want in ((dict(GATES["gshard"]), 4916),
                       (moe.SwitchGate(8, 8, capacity=(1.25, 2.0),
                                       device="cpu"), 2560)):
        layer = moe.MoELayer(8, big, gate=gate, device="cpu")
        assert layer.dispatch_indices(torch.zeros(16384, 8))[2] == want


def test_layer_forward_shapes_and_aux_loss():
    layer = _port_layer("gshard", _ref_layer("gshard"))
    x, _ = _step_data()
    y3 = layer(torch.from_numpy(x))
    assert y3.shape == (STEP_B, STEP_S, D)
    aux3 = float(layer.aux_loss)
    y2 = layer(torch.from_numpy(x.reshape(-1, D)))
    assert y2.shape == (STEP_B * STEP_S, D)
    np.testing.assert_array_equal(y2.detach().numpy(),
                                  y3.detach().numpy().reshape(-1, D))
    assert float(layer.aux_loss) == aux3 > 0


def test_same_seed_same_weights_and_the_loss_falls():
    def run(seed):
        experts = [torch.nn.Sequential(Linear(D, H), torch.nn.ReLU(),
                                       Linear(H, D)) for _ in range(E)]
        layer = moe.MoELayer(D, experts, gate=dict(GATES["gshard"]),
                             device="cpu", seed=seed)
        step = make_moe_train_step(layer, Adam(
            learning_rate=1e-2, parameters=layer.parameters()))
        x, target = (torch.from_numpy(a) for a in _step_data())
        return [step(x, target).item() for _ in range(4)]

    a, b, c = run(3), run(3), run(4)
    assert all(np.isfinite(a)) and a[-1] < a[0]
    assert a == b and a != c


def test_cpu_tensors_do_not_launch_the_kernel():
    before = md.gather_rows.launches
    layer = _port_layer("switch", _ref_layer("switch"))
    x, target = (torch.from_numpy(a) for a in _step_data())
    make_moe_train_step(layer, Adam(parameters=layer.parameters()))(
        x, target)
    assert md.gather_rows.launches == before


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the raise needs a card-less "
                    "machine")
    experts = [Linear(D, D) for _ in range(E)]
    with pytest.raises(RuntimeError, match="cuda"):
        moe.MoELayer(D, experts, gate=dict(GATES["gshard"]))
    with pytest.raises(RuntimeError, match="cuda"):
        moe.GShardGate(D, num_expert=E)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_loss_matches_reference(reduction):
    a, b = _step_data()
    ref = JF.mse_loss(paddle.to_tensor(a), paddle.to_tensor(b),
                      reduction=reduction).numpy()
    got = F.mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                     reduction=reduction)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


# ------------------------------------------------ expert parallelism (EP)

EP_E, EP_W = 8, 4           # experts (2 a rank), ranks
EP_CF = 4.0                 # a capacity at which nothing drops


def _ep_ref_layer():
    paddle.seed(23)
    experts = [jnn.Sequential(jnn.Linear(D, H), jnn.GELU(), jnn.Linear(H, D))
               for _ in range(EP_E)]
    layer = JMoELayer(d_model=D, experts=experts,
                      gate=dict(GATES["gshard"]))
    layer.capacity_factor = EP_CF
    return layer


def _ep_data():
    """x and the cotangent of y: (2, 32, D), 64 tokens, 16 a rank."""
    rng = np.random.RandomState(21)
    return (rng.randn(2, 32, D).astype(np.float32),
            rng.randn(2, 32, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_ep():
    """(weights, y [T, D], aux, dx, parameter gradients) of the reference's
    expert_parallel_forward over 4 fake devices, loss = sum(y * ct) +
    aux_loss."""
    from jax.sharding import Mesh

    from paddle_tpu.core import tape
    from paddle_tpu.jit.functional import bind_state

    layer = _ep_ref_layer()
    params, buffers = extract_state(layer)
    state = {n: np.asarray(v) for n, v in params.items()}
    x, ct = _ep_data()
    mesh = Mesh(np.asarray(jax.devices()[:EP_W]), ("ep",))

    def loss_of(p, xd):
        # the layer as a function of its weights and x, jitted
        with bind_state(layer, p, buffers), tape.no_grad():
            y = layer.expert_parallel_forward(paddle.Tensor(xd), mesh,
                                              ep_axis="ep")._data
            aux = layer.aux_loss._data
        return jnp.sum(y * ct) + aux, (y, aux)

    (_, (y, aux)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    grads = {n: np.asarray(g) for n, g in g_p.items()}
    return (state, np.asarray(y).reshape(-1, D), float(aux), np.asarray(g_x),
            grads)


def _ep_port_layer(state):
    experts = [torch.nn.Sequential(Linear(D, H), torch.nn.GELU(),
                                   Linear(H, D)) for _ in range(EP_E)]
    layer = moe.MoELayer(D, experts, gate=dict(GATES["gshard"]),
                         device="cpu")
    load_reference_state(layer, state)
    layer.capacity_factor = EP_CF
    return layer


@functools.lru_cache(maxsize=None)
def _single_rank():
    """The port's single-rank layer on each rank's tokens in turn, loss =
    sum over ranks of sum(y_r * ct_r) + the mean of their aux losses (EP's
    objective): (y [T, D], aux, dx, gradients in the reference's layout)."""
    layer = _ep_port_layer(_jax_ep()[0])
    x, ct = _ep_data()
    xt = torch.from_numpy(x.reshape(-1, D)).requires_grad_()
    per = xt.shape[0] // EP_W
    ys, auxs = zip(*(layer._routed_forward(xt[r * per:(r + 1) * per],
                                           layer.gate.gate_weight,
                                           layer._run_experts)
                     for r in range(EP_W)))
    y, aux = torch.cat(ys), torch.stack(auxs).mean()
    ((y * torch.from_numpy(ct.reshape(-1, D))).sum() + aux).backward()
    return (y.detach().numpy(), float(aux), xt.grad.numpy().reshape(x.shape),
            _port_grads(layer))


@pytest.fixture(scope="module")
def ep_world():
    """Each rank's result of `expert_parallel_forward` over 4 gloo ranks
    (one world for the module's EP cases)."""
    x, ct = _ep_data()
    return ptd.spawn(ranks.expert_parallel,
                     (_jax_ep()[0], x, ct, EP_E, D, H, GATES["gshard"],
                      EP_CF), nprocs=EP_W, device="cpu", timeout=180)


def test_expert_parallel_drops_nothing_at_this_capacity(ep_world):
    assert [r["dropped"] for r in ep_world] == [0.0] * EP_W


@pytest.mark.parametrize("against", ["single rank", "reference EP"])
def test_expert_parallel_forward_and_aux_loss(ep_world, against):
    """The ranks' rows in rank order are the whole batch's y; aux_loss is
    the mean of the ranks' (the reference's pmean), the same on each."""
    y = np.concatenate([r["y"] for r in ep_world])
    ref_y, ref_aux = (_single_rank()[:2] if against == "single rank"
                      else _jax_ep()[1:3])
    np.testing.assert_allclose(y, ref_y, rtol=1e-5, atol=1e-5)
    for r in ep_world:
        np.testing.assert_allclose(r["aux"], ref_aux, rtol=1e-6)


@pytest.mark.parametrize("against", ["single rank", "reference EP"])
def test_expert_parallel_gradients(ep_world, against):
    """The gate's gradient, summed over the ranks, on every rank; each
    expert's only on the rank that owns it (experts 2r and 2r + 1 on rank
    r); x's rows on the rank that routed them."""
    ref_dx, ref_grads = (_single_rank()[2:] if against == "single rank"
                         else _jax_ep()[3:])
    lin = _linear_names(_ep_port_layer(_jax_ep()[0]))
    np.testing.assert_allclose(sum(r["dx"] for r in ep_world), ref_dx,
                               rtol=1e-4, atol=1e-5)
    owner = {}
    for rank, r in enumerate(ep_world):
        local = {int(n.split(".")[1]) for n in r["grads"]
                 if n.startswith("experts.")}
        assert local == {EP_E // EP_W * rank + i for i in range(2)}
        for n, g in r["grads"].items():
            g = g.T if n in lin else g
            np.testing.assert_allclose(g, ref_grads[n], rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {rank} {n}")
            owner.setdefault(n, []).append(rank)
    assert owner["gate.gate_weight"] == list(range(EP_W))
    assert set(owner) == set(ref_grads)
    assert all(len(v) == 1 for n, v in owner.items() if n != "gate.gate_weight")


def test_expert_parallel_raises_when_experts_or_tokens_do_not_divide():
    four = ptd.Group(0, range(EP_W))
    layer = _port_layer("gshard", _ref_layer("gshard"))   # 4 experts
    with pytest.raises(ValueError, match="num_experts 4 not divisible by "
                                         "the ep size 3"):
        layer.expert_parallel_forward(torch.zeros(2, 6, D),
                                      ptd.Group(0, range(3)))
    with pytest.raises(ValueError, match="10 tokens not divisible by the ep "
                                         "size 4"):
        layer.expert_parallel_forward(torch.zeros(10, D), four)
