"""The port's amp (paddle_tpu_torch.amp) against the JAX package's
(paddle_tpu/amp): O2's output type op by op, `decorate`, the
`GradScaler`'s contract and scale sequences with inf steps (oracle:
tests/test_amp.py), and tiny ERNIE and GPT steps under O2 against the
reference's O2 step on the same weights and batch: the loss within 2e-2
relative and every gradient's cosine above 0.99 (both run in bf16; the
port's attention and norms are the plain versions of K1-K5, the
reference's its own dispatch, so products round in other orders).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTForCausalLM)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.training import make_causal_lm_train_step
from paddle_tpu_torch.weights import load_reference_state

B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------- O2, op by op
_r = np.random.RandomState(0)
X = _r.randn(2, 6, 16).astype("float32")
W = _r.randn(16, 8).astype("float32")          # paddle's (in, out)
IDS = _r.randint(0, 8, (2, 6)).astype("int64")
Q = _r.randn(2, 6, 2, 8).astype("float32")

OPS = {
    # name: (reference call, port call)
    "linear": (lambda: JF.linear(paddle.to_tensor(X), paddle.to_tensor(W)),
               lambda: F.linear(torch.from_numpy(X),
                                torch.from_numpy(W.T.copy()))),
    "matmul": (lambda: paddle.matmul(paddle.to_tensor(X),
                                     paddle.to_tensor(W)),
               lambda: F.matmul(torch.from_numpy(X), torch.from_numpy(W))),
    "embedding": (lambda: JF.embedding(paddle.to_tensor(IDS),
                                       paddle.to_tensor(W)),
                  lambda: F.embedding(torch.from_numpy(IDS),
                                      torch.from_numpy(W))),
    "gelu": (lambda: JF.gelu(paddle.to_tensor(X)),
             lambda: F.gelu(torch.from_numpy(X))),
    "relu": (lambda: JF.relu(paddle.to_tensor(X)),
             lambda: F.relu(torch.from_numpy(X))),
    "silu": (lambda: JF.silu(paddle.to_tensor(X)),
             lambda: F.silu(torch.from_numpy(X))),
    "tanh": (lambda: paddle.tanh(paddle.to_tensor(X)),
             lambda: F.tanh(torch.from_numpy(X))),
    "add": (lambda: paddle.to_tensor(X) + paddle.to_tensor(X),
            lambda: F.add(torch.from_numpy(X), torch.from_numpy(X))),
    "multiply": (lambda: paddle.multiply(paddle.to_tensor(X),
                                         paddle.to_tensor(X)),
                 lambda: F.multiply(torch.from_numpy(X),
                                    torch.from_numpy(X))),
    "layer_norm": (lambda: JF.layer_norm(
        paddle.to_tensor(X), 16, paddle.to_tensor(np.ones(16, "float32")),
        paddle.to_tensor(np.zeros(16, "float32"))),
        lambda: F.layer_norm(torch.from_numpy(X), 16, torch.ones(16),
                             torch.zeros(16))),
    "cross_entropy": (lambda: JF.cross_entropy(
        paddle.to_tensor(X.reshape(12, 16)),
        paddle.to_tensor(IDS.reshape(12))),
        lambda: F.cross_entropy(torch.from_numpy(X.reshape(12, 16)),
                                torch.from_numpy(IDS.reshape(12)))),
    "mse_loss": (lambda: JF.mse_loss(paddle.to_tensor(X),
                                     paddle.to_tensor(X * 0.5)),
                 lambda: F.mse_loss(torch.from_numpy(X),
                                    torch.from_numpy(X * 0.5))),
    "scaled_dot_product_attention": (
        lambda: JF.scaled_dot_product_attention(
            paddle.to_tensor(Q), paddle.to_tensor(Q), paddle.to_tensor(Q)),
        lambda: F.scaled_dot_product_attention(
            torch.from_numpy(Q), torch.from_numpy(Q), torch.from_numpy(Q),
            training=False)),
}


def _dtype_name(t):
    d = getattr(t, "_data", t).dtype
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", list(OPS))
def test_output_type_matches_reference(level, op):
    ref_fn, port_fn = OPS[op]
    with jamp.auto_cast(level=level, dtype="bfloat16"):
        ref = _dtype_name(ref_fn())
    with amp.auto_cast(level=level, dtype="bfloat16"):
        got = _dtype_name(port_fn())
    assert got == ref, (op, level, got, ref)


def test_custom_lists_and_state_queries():
    assert not amp.is_auto_cast_enabled()
    assert amp.get_amp_dtype() == torch.float32
    with amp.auto_cast(level="O1", custom_black_list=["gelu"]):
        assert amp.is_auto_cast_enabled()
        assert amp.get_amp_dtype() == torch.bfloat16
        assert F.gelu(torch.ones(2).bfloat16()).dtype == torch.float32
    with amp.auto_cast(level="O1", custom_white_list=["tanh"]):
        assert F.tanh(torch.ones(2)).dtype == torch.bfloat16
    with amp.auto_cast(enable=False, level="O2"):
        assert F.gelu(torch.ones(2)).dtype == torch.float32
    with amp.amp_guard(level="O0"):
        assert not amp.is_auto_cast_enabled()
    with pytest.raises(ValueError, match="level"):
        amp.auto_cast(level="O3")
    assert amp.is_bfloat16_supported() and amp.is_float16_supported()


# --------------------------------------------------------- decorate
def test_decorate_o2_enables_master_weights():
    lin = torch.nn.Linear(2, 2)
    opt = AdamW(learning_rate=1e-3, parameters=lin.parameters())
    assert opt._multi_precision is False
    model, opt2 = amp.decorate(lin, optimizers=opt, level="O2")
    assert opt2._multi_precision is True
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt2.step()
    st = opt2.state[next(model.parameters())]
    assert st["master_weight"].dtype == torch.float32


def test_decorate_o2_master_weight_false_respected():
    lin = torch.nn.Linear(2, 2)
    opt = AdamW(learning_rate=1e-3, parameters=lin.parameters())
    amp.decorate(lin, optimizers=opt, level="O2", master_weight=False)
    assert opt._multi_precision is False
    lin32 = torch.nn.Linear(2, 2)
    assert amp.decorate(lin32, level="O1") is lin32
    assert lin32.weight.dtype == torch.float32


# ------------------------------------------------------- GradScaler
def _one_param(grad_value, scale, mod):
    """A one-weight model's scaled loss backward in each package."""
    if mod == "port":
        lin = torch.nn.Linear(1, 1, bias=False)
        opt = SGD(learning_rate=0.0, parameters=lin.parameters())
        scaler = amp.GradScaler(init_loss_scaling=scale)
        x = torch.full((1, 1), grad_value)
        scaler.scale(lin(x).sum()).backward()
        return scaler, opt, lin.weight
    lin = jnn.Linear(1, 1, bias_attr=False)
    opt = paddle.optimizer.SGD(learning_rate=0.0,
                               parameters=lin.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=scale)
    x = paddle.to_tensor(np.full((1, 1), grad_value, "float32"),
                         stop_gradient=False)
    scaler.scale(lin(x).sum()).backward()
    return scaler, opt, lin.parameters()[0]


def test_unscale_then_step_divides_once():
    scaler, opt, p = _one_param(2.0, 1024.0, "port")
    scaler.unscale_(opt)
    assert float(p.grad) == pytest.approx(2.0)
    scaler.step(opt)
    assert float(p.grad) == pytest.approx(2.0)
    scaler.update()


def test_step_without_unscale_divides_once():
    scaler, opt, p = _one_param(3.0, 256.0, "port")
    scaler.step(opt)
    assert float(p.grad) == pytest.approx(3.0)


def test_double_unscale_and_double_step_raise():
    scaler, opt, _ = _one_param(1.0, 8.0, "port")
    scaler.unscale_(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.unscale_(opt)
    scaler.update()
    scaler.unscale_(opt)            # legal again after update()
    scaler.step(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.step(opt)


def _scaler_run(mod, grads):
    """SGD(lr 0.5) on one weight through a GradScaler, with the given
    (possibly inf) gradients; returns the scale and the weight after each
    step."""
    if mod == "port":
        p = torch.nn.Parameter(torch.ones(3))
        opt = SGD(learning_rate=0.5, parameters=[p])
        scaler = amp.GradScaler(init_loss_scaling=64.0,
                                incr_every_n_steps=3,
                                decr_every_n_nan_or_inf=2)
    else:
        from paddle_tpu.core.tensor import Parameter, Tensor

        p = Parameter(np.ones(3, "float32"))
        opt = paddle.optimizer.SGD(learning_rate=0.5, parameters=[p])
        scaler = paddle.amp.GradScaler(init_loss_scaling=64.0,
                                       incr_every_n_steps=3,
                                       decr_every_n_nan_or_inf=2)
    out = []
    for g in grads:
        scaled = np.asarray(g, "float32") * scaler.get_loss_scaling()
        if mod == "port":
            p.grad = torch.from_numpy(scaled)
        else:
            p.grad = Tensor(scaled)
        scaler.step(opt)
        scaler.update()
        out.append((scaler.get_loss_scaling(),
                    np.asarray(p.detach().numpy() if mod == "port"
                               else p.numpy()).copy()))
    return out, scaler.state_dict()


def test_scale_sequence_with_inf_steps_equals_reference():
    inf = np.inf
    grads = [[1, 2, 3], [1, inf, 3], [1, 1, 1], [inf, 0, 0], [0, 0, np.nan],
             [1, 1, 1], [1, 1, 1], [1, 1, 1], [2, 2, 2], [inf, 1, 1]]
    port, port_sd = _scaler_run("port", grads)
    ref, ref_sd = _scaler_run("ref", grads)
    for (s, w), (rs, rw) in zip(port, ref):
        assert s == rs
        np.testing.assert_allclose(w, rw, rtol=1e-6)
    assert port_sd == ref_sd


def test_found_inf_read_once_a_step(monkeypatch):
    reads = []
    orig = amp.GradScaler._read

    def counting(flags):
        reads.append(1)
        return orig(flags)

    monkeypatch.setattr(amp.GradScaler, "_read", staticmethod(counting))
    ps = [torch.nn.Parameter(torch.ones(4)) for _ in range(5)]
    opt = SGD(learning_rate=0.1, parameters=ps)
    scaler = amp.GradScaler(init_loss_scaling=4.0)
    for _ in range(3):
        for p in ps:
            p.grad = torch.ones(4) * 4.0
        scaler.step(opt)
        scaler.update()
    assert len(reads) == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [None, float("inf"), float("nan")])
def test_unscale_finds_nonfinite_in_every_type(dtype, bad):
    ps = [torch.nn.Parameter(torch.ones(5, dtype=dtype)) for _ in range(3)]
    opt = SGD(learning_rate=0.5, parameters=ps)
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    for i, p in enumerate(ps):
        g = torch.full((5,), 8.0 * (i + 1), dtype=dtype)
        if bad is not None and i == 2:
            g[3] = bad
        p.grad = g
    scaler.unscale_(opt)
    for i, p in enumerate(ps[:2]):
        assert torch.equal(p.grad, torch.full((5,), float(i + 1),
                                              dtype=dtype))
    scaler.step(opt)
    scaler.update()
    stepped = not torch.equal(ps[0].detach(), torch.ones(5, dtype=dtype))
    assert stepped == (bad is None)


def test_state_dict_round_trip():
    s = amp.GradScaler(init_loss_scaling=32.0, incr_every_n_steps=2)
    s._good_steps = 1
    t = amp.GradScaler()
    t.load_state_dict(s.state_dict())
    assert t.get_loss_scaling() == 32.0 and t._good_steps == 1


# ----------------------------------------- O2 steps against the reference
def _tiny(cls, family):
    cfg = cls.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    if family == "ernie":
        cfg.fused_mlm_loss = True
    else:
        cfg.fused_lm_loss = True
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    paddle.seed(2026)
    m = (JErnie(_tiny(JErnieConfig, family)) if family == "ernie"
         else JGPT(_tiny(JGPTConfig, family)))
    m.train()
    return m


def _batch():
    r = np.random.RandomState(5)
    ids = r.randint(0, 1024, (B, S)).astype(np.int64)
    labels = r.randint(0, 1024, (B, S)).astype(np.int64)
    labels[:, ::5] = -100
    return ids, labels


def _jax_o2(family):
    model = _jax_model(family)
    params, buffers = extract_state(model)
    params32 = {k: np.asarray(v) for k, v in params.items()}
    p16 = {k: v.astype(jnp.bfloat16) for k, v in params.items()}
    ids, labels = _batch()

    def loss_of(p):
        with jamp.auto_cast(level="O2", dtype="bfloat16"):
            if family == "ernie":
                (loss, _), _ = call_functional(
                    model, p, buffers,
                    (jnp.asarray(ids), None, None, None,
                     jnp.asarray(labels)), training=True)
            else:
                loss, _ = call_functional(
                    model, p, buffers, (jnp.asarray(ids),),
                    kwargs={"labels": jnp.asarray(ids)}, training=True)
        return loss.astype(jnp.float32)

    loss, grads = jax.value_and_grad(loss_of)(p16)
    return float(loss), {k: np.asarray(g.astype(jnp.float32))
                         for k, g in grads.items()}, params32


def _port_o2(family, params32):
    model = (ErnieForPretraining(_tiny(ErnieConfig, family), device="cpu")
             if family == "ernie"
             else GPTForCausalLM(_tiny(GPTConfig, family), device="cpu"))
    load_reference_state(model, params32)
    amp.decorate(model, level="O2")
    model.train()
    ids, labels = _batch()
    with amp.auto_cast(level="O2"):
        if family == "ernie":
            loss, _ = model(torch.from_numpy(ids),
                            masked_lm_labels=torch.from_numpy(labels))
        else:
            loss = model(torch.from_numpy(ids),
                         labels=torch.from_numpy(ids))
    loss.float().backward()
    lin = {f"{n}.weight" for n, mod in model.named_modules()
           if isinstance(mod, torch.nn.Linear)}
    grads = {}
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        g = (torch.zeros_like(p) if p.grad is None else p.grad).float()
        grads[n] = g.numpy().T if n in lin else g.numpy()
    return float(loss.detach()), grads


@pytest.mark.parametrize("family", ["ernie", "gpt"])
def test_o2_step_matches_reference(family):
    ref_loss, ref_grads, params32 = _jax_o2(family)
    loss, grads = _port_o2(family, params32)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        r = ref_grads[name].astype(np.float64).ravel()
        gg = g.astype(np.float64).ravel()
        if not r.any() and not gg.any():       # no loss path (pooler, nsp)
            continue
        cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
        assert cos > 0.99, (name, cos)


def test_o2_train_step_with_scaler_and_schedule():
    """GPT-3's recipe at a tiny size: decorate O2, AdamW (0.9, 0.95, wd
    0.1) with masters, a global-norm clip, warmup into cosine and a
    GradScaler through make_causal_lm_train_step: finite, falling loss."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import lr as plr

    cfg = GPTConfig.tiny()
    model = GPTForCausalLM(cfg, device="cpu", seed=3)
    sched = plr.LinearWarmup(plr.CosineAnnealingDecay(3e-3, T_max=20),
                             warmup_steps=2, start_lr=0.0, end_lr=3e-3)
    opt = AdamW(learning_rate=sched, beta1=0.9, beta2=0.95, epsilon=1e-8,
                weight_decay=0.1, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 12)
    step = make_causal_lm_train_step(model, opt, scaler=scaler, level="O2")
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 32)))
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        losses.append(float(step(ids, ids, gen)))
        sched.step()
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    st = opt.state[next(model.parameters())]
    assert st["master_weight"].dtype == torch.float32
    assert next(model.parameters()).dtype == torch.bfloat16
