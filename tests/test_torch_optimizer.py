"""The port's optimizer family (paddle_tpu_torch.optimizer) and gradient
clips (paddle_tpu_torch.nn.clip) against the JAX package's
`Optimizer.functional_step` (paddle_tpu/optimizer/__init__.py) on the same
seeded numpy parameters and gradients: three steps of each rule, through
the port's `step()` (gradients on the parameters) and its
`functional_step`, within rtol 2e-5 / atol 2e-6 of the reference (fp32
everywhere; the rules' scalar factors are host doubles in the port and
fp32 device scalars in the reference, and Adam divides sqrt(m2) by
sqrt(1 - beta2^t) where the reference takes sqrt(m2 / (1 - beta2^t))).

Also: weight decay as a float, `L2Decay` and `L1Decay` (a no-op in both
packages: only L2 is applied), each clip, `multi_precision` bf16
parameters with fp32 masters (masters within the tolerance above, the
bf16 parameters within one bf16 rounding of the reference's), parameter
groups and the per-parameter learning-rate scale, a scheduler read at
each step, and the state-dict round trip (under the reference's key
names) continuing bit for bit. Oracle for the analytic cases:
tests/test_optimizer.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import clip as pclip

RTOL, ATOL = 2e-5, 2e-6
LR = 0.01
SHAPES = {"w": (5, 7), "b": (7,)}
_rng = np.random.RandomState(0)
P0 = {k: _rng.randn(*s).astype("float32") for k, s in SHAPES.items()}
GRADS = [{k: _rng.randn(*s).astype("float32") * 0.5
          for k, s in SHAPES.items()} for _ in range(3)]

RULES = {
    "SGD": ("SGD", {}),
    "Momentum": ("Momentum", {"momentum": 0.9}),
    "Momentum nesterov": ("Momentum", {"momentum": 0.9,
                                       "use_nesterov": True}),
    "Adagrad": ("Adagrad", {"initial_accumulator_value": 0.1}),
    "Adam": ("Adam", {}),
    "Adam amsgrad": ("Adam", {"amsgrad": True}),
    "AdamW": ("AdamW", {"weight_decay": 0.1}),
    "Adamax": ("Adamax", {}),
    "RMSProp": ("RMSProp", {"momentum": 0.5}),
    "RMSProp centered": ("RMSProp", {"centered": True}),
    "Adadelta": ("Adadelta", {}),
    "Lamb": ("Lamb", {}),
    "Rprop": ("Rprop", {}),
    "ASGD": ("ASGD", {"batch_num": 2}),
    "NAdam": ("NAdam", {}),
    "RAdam": ("RAdam", {}),
}


def _ref_opt(cls, kw):
    params = [JParameter(v) for v in P0.values()]
    return getattr(jopt, cls)(learning_rate=LR, parameters=params, **kw)


def _ref_run(cls, kw, p0=P0, grads=GRADS, lrs=None, dtype=jnp.float32):
    opt = _ref_opt(cls, kw)
    p = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    st = opt.functional_state(p)
    for t, g in enumerate(grads, 1):
        lr = LR if lrs is None else lrs[t - 1]
        p, st = opt.functional_step(
            p, {k: jnp.asarray(v, dtype) for k, v in g.items()}, st,
            jnp.asarray(lr, jnp.float32), jnp.asarray(t, jnp.int32))
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in p.items()},
            {k: {s: np.asarray(a) for s, a in acc.items()}
             for k, acc in st.items()})


def _params(dtype=torch.float32, p0=P0):
    return {k: torch.nn.Parameter(torch.from_numpy(v.copy()).to(dtype))
            for k, v in p0.items()}


def _port_step(cls, kw, grads=GRADS, dtype=torch.float32, sched=None):
    """Three stateful `step()`s with the gradients set on the parameters;
    returns (params, opt)."""
    ps = _params(dtype)
    opt = getattr(popt, cls)(learning_rate=sched if sched is not None
                             else LR, parameters=list(ps.values()), **kw)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k]).to(dtype)
        opt.step()
        if sched is not None:
            sched.step()
    return {k: p.detach().float().numpy() for k, p in ps.items()}, opt


def _port_functional(cls, kw, grads=GRADS):
    opt = getattr(popt, cls)(learning_rate=LR,
                             parameters=list(_params().values()), **kw)
    p = {k: torch.from_numpy(v.copy()) for k, v in P0.items()}
    st = opt.functional_state(p)
    for t, g in enumerate(grads, 1):
        p, st = opt.functional_step(
            p, {k: torch.from_numpy(v) for k, v in g.items()}, st, LR, t)
    return {k: v.numpy() for k, v in p.items()}, st


def _close(got, ref, rtol=RTOL, atol=ATOL):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("rule", list(RULES))
def test_rule_matches_functional_step(rule):
    cls, kw = RULES[rule]
    ref, ref_state = _ref_run(cls, kw)
    got, _ = _port_step(cls, kw)
    _close(got, ref)
    got_f, st = _port_functional(cls, kw)
    _close(got_f, ref)
    for k in ref_state:
        assert set(st[k]) == set(ref_state[k])
        for s in ref_state[k]:
            np.testing.assert_allclose(st[k][s].numpy(), ref_state[k][s],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "Adam", "RMSProp"])
@pytest.mark.parametrize("decay", ["float", "L2", "L1"])
def test_weight_decay(cls, decay):
    kw = dict(RULES[cls][1])
    kw["weight_decay"] = {"float": 0.05, "L2": jopt.L2Decay(0.05),
                          "L1": jopt.L1Decay(0.05)}[decay]
    ref, _ = _ref_run(cls, kw)
    pkw = dict(kw, weight_decay={"float": 0.05, "L2": popt.L2Decay(0.05),
                                 "L1": popt.L1Decay(0.05)}[decay])
    got, _ = _port_step(cls, pkw)
    _close(got, ref)
    if decay == "L1":       # accepted and not applied, as the reference
        plain, _ = _port_step(cls, RULES[cls][1])
        for k in plain:
            assert np.array_equal(plain[k], got[k])


CLIPS = {
    "value": (lambda m: m.ClipGradByValue(0.2)),
    "norm": (lambda m: m.ClipGradByNorm(0.5)),
    "global norm": (lambda m: m.ClipGradByGlobalNorm(0.5)),
}


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("cls", ["SGD", "Adam", "AdamW"])
def test_grad_clip(clip, cls):
    kw = RULES[cls][1]
    ref, _ = _ref_run(cls, dict(kw, grad_clip=CLIPS[clip](jnn)))
    got, _ = _port_step(cls, dict(kw, grad_clip=CLIPS[clip](pclip)))
    _close(got, ref)


def test_clip_pair_form_and_clip_grad_norm_():
    gs = [torch.from_numpy(GRADS[0][k]) for k in SHAPES]
    pairs = [(torch.zeros(1), g) for g in gs]
    clipped = pclip.ClipGradByGlobalNorm(0.5)(pairs)
    total = np.sqrt(sum(float((g.double() ** 2).sum()) for g in gs))
    for (_, c), g in zip(clipped, gs):
        np.testing.assert_allclose(c.numpy(), g.numpy() * 0.5 / total,
                                   rtol=1e-5)
    ps = [torch.nn.Parameter(torch.zeros_like(g)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = g.clone()
    norm = pclip.clip_grad_norm_(ps, 0.5)
    np.testing.assert_allclose(float(norm), total, rtol=1e-5)
    for p, (_, c) in zip(ps, clipped):
        np.testing.assert_allclose(p.grad.numpy(), c.numpy(), rtol=1e-6)


@pytest.mark.parametrize("cls", ["Adam", "AdamW", "Momentum", "SGD"])
def test_multi_precision_bf16_masters(cls):
    kw = dict(RULES[cls][1], multi_precision=True)
    ref, ref_state = _ref_run(cls, kw, dtype=jnp.bfloat16)
    got, opt = _port_step(cls, kw, dtype=torch.bfloat16)
    for k, p in zip(SHAPES, opt._parameter_list):
        st = opt.state[p]
        assert st["master_weight"].dtype == torch.float32
        np.testing.assert_allclose(st["master_weight"].numpy(),
                                   ref_state[k]["master_weight"],
                                   rtol=RTOL, atol=ATOL)
        assert p.dtype == torch.bfloat16
        # one bf16 rounding of masters within RTOL of each other
        np.testing.assert_allclose(got[k], ref[k], rtol=2 ** -7, atol=ATOL)


def test_param_groups_and_lr_scale():
    p1, p2 = (torch.nn.Parameter(torch.ones(1)) for _ in range(2))
    opt = popt.SGD(learning_rate=0.1, parameters=[{"params": [p1]},
                                                  {"params": [p2]}])
    p1.grad = torch.ones(1)
    p2.grad = torch.ones(1)
    opt.step()
    assert float(p1.detach()) == pytest.approx(0.9)
    assert float(p2.detach()) == pytest.approx(0.9)
    p = torch.nn.Parameter(torch.ones(1))
    p.optimize_attr = {"learning_rate": 0.5}
    opt = popt.SGD(learning_rate=0.2, parameters=[p])
    p.grad = torch.ones(1)
    opt.step()
    assert float(p.detach()) == pytest.approx(0.9)


def test_scheduler_read_at_each_step():
    def sched(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=10),
                                warmup_steps=2, start_lr=0.0, end_lr=LR)

    ref_sched = sched(jopt.lr)
    lrs = []
    for _ in GRADS:
        lrs.append(ref_sched.last_lr)
        ref_sched.step()
    ref, _ = _ref_run("AdamW", {"weight_decay": 0.1}, lrs=lrs)
    got, opt = _port_step("AdamW", {"weight_decay": 0.1},
                          sched=sched(popt.lr))
    _close(got, ref)
    assert opt.get_lr() == ref_sched.last_lr
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)


def test_state_dict_round_trip():
    full, _ = _port_step("Adam", {})
    ps = _params()
    opt = popt.Adam(learning_rate=LR, parameters=list(ps.values()))
    for g in GRADS[:2]:
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    sd = opt.state_dict()
    assert sd["@step_count"] == 2
    assert {"param_0.moment1", "param_1.moment2"} <= set(sd)
    ps2 = {k: torch.nn.Parameter(p.detach().clone()) for k, p in ps.items()}
    opt2 = popt.Adam(learning_rate=LR, parameters=list(ps2.values()))
    opt2.set_state_dict(sd)
    for k, p in ps2.items():
        p.grad = torch.from_numpy(GRADS[2][k])
    opt2.step()
    for k in full:
        assert np.array_equal(full[k], ps2[k].detach().numpy())


def test_adam_keeps_its_earlier_update():
    """The port's Adam before the optimizer package, written out: the
    same bits (today's train cells are unchanged)."""
    import math

    got, _ = _port_step("Adam", {})
    ps = _params()
    m1 = {k: torch.zeros_like(p) for k, p in ps.items()}
    m2 = {k: torch.zeros_like(p) for k, p in ps.items()}
    with torch.no_grad():
        for t, g in enumerate(GRADS, 1):
            for k, p in ps.items():
                gt = torch.from_numpy(g[k])
                m1[k].mul_(0.9).add_(gt, alpha=0.1)
                m2[k].mul_(0.999).addcmul_(gt, gt, value=0.001)
                denom = m2[k].sqrt().div_(math.sqrt(1.0 - 0.999 ** t))
                denom.add_(1e-8)
                p.addcdiv_(m1[k], denom, value=-LR / (1.0 - 0.9 ** t))
    for k in got:
        assert np.array_equal(got[k], ps[k].detach().numpy())


def test_none_gradient_counts_as_zero():
    p = torch.nn.Parameter(torch.ones(3))
    opt = popt.SGD(learning_rate=0.1, parameters=[p], weight_decay=0.5)
    opt.step()                       # p.grad is None: zero gradient
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 0.1 * 0.5)
