"""Activation recompute in the port (paddle_tpu_torch.distributed.fleet.
recompute and `ErnieConfig.recompute`).

Port against port, bit for bit: a tiny ERNIE in training at fp32 with
hidden and attention dropout 0.1 gives the same loss, the same gradients
and leaves its generator in the same state with recompute on as off. That
holds under O1 too, and only because `recompute` replays the explicit
generator and the forward's amp policy: the same run through a plain
`torch.utils.checkpoint` (which restores only the global generators)
gives other gradients, which the negative control shows. Against the JAX package: the tiny ERNIE with recompute on at
dropout 0, the loss within 1e-5 and every gradient within rtol 1e-4 /
atol 1e-5 of the reference's recomputed step (fp32). `recompute_sequential`
equals the plain chain bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import paddle_tpu as paddle
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed.fleet import recompute as rc
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.weights import load_reference_state

B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    r = np.random.RandomState(3)
    ids = torch.from_numpy(r.randint(0, 1024, (B, S)))
    labels = torch.from_numpy(r.randint(0, 1024, (B, S)))
    labels[:, ::4] = -100
    return ids, labels


def _run(recompute, dropout=0.1, params=None, o1=False):
    cfg = ErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    cfg.fused_mlm_loss = True
    cfg.recompute = recompute
    model = ErnieForPretraining(cfg, device="cpu", seed=11)
    if params is not None:
        load_reference_state(model, params)
    model.train()
    gen = torch.Generator().manual_seed(5)
    ids, labels = _batch()
    with amp.auto_cast(level="O1" if o1 else "O0"):
        loss, _ = model(ids, masked_lm_labels=labels, generator=gen)
    loss.backward()          # the replay runs here, outside the auto_cast
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
             for n, p in model.named_parameters()}
    return loss.detach(), grads, gen.get_state(), model


def test_recompute_on_equals_off_bitwise_with_dropout():
    loss0, g0, s0, _ = _run(False)
    loss1, g1, s1, _ = _run(True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert torch.equal(s0, s1)


def test_recompute_on_equals_off_bitwise_under_o1():
    """The replay takes the forward's amp policy, not the one in force
    when the backward runs."""
    loss0, g0, _, _ = _run(False, o1=True)
    loss1, g1, _, _ = _run(True, o1=True)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_plain_checkpoint_without_replay_differs(monkeypatch):
    """The negative control: torch.utils.checkpoint alone draws new masks
    in the replay, so the gradients change (silently)."""
    def plain(function, *args, **kwargs):
        return checkpoint(function, *args, use_reentrant=False, **kwargs)

    monkeypatch.setattr(rc, "recompute", plain)
    _, g0, _, _ = _run(False)
    _, g1, _, _ = _run(True)
    assert not all(torch.equal(g0[k], g1[k]) for k in g0)


def test_recompute_replays_a_keyword_generator():
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)

    def f(x, w, generator=None):
        return F.dropout(x @ w, 0.5, True, generator).tanh()

    grads = []
    for use in (False, True):
        w.grad = None
        g = torch.Generator().manual_seed(1)
        out = (rc.recompute(f, x, w, generator=g) if use
               else f(x, w, generator=g))
        out.sum().backward()
        grads.append((w.grad.clone(), torch.rand(1, generator=g)))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def test_recompute_sequential_equals_the_plain_chain():
    torch.manual_seed(0)
    layers = [torch.nn.Linear(6, 6), torch.nn.ReLU(), torch.nn.Linear(6, 6),
              torch.nn.Tanh(), torch.nn.Linear(6, 3)]
    x = torch.randn(5, 6, requires_grad=True)
    outs, grads = [], []
    for seq in (False, True):
        for m in layers:
            m.zero_grad()
        x.grad = None
        if seq:
            out = rc.recompute_sequential({"segments": 2}, layers, x)
        else:
            out = x
            for m in layers:
                out = m(out)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([x.grad.clone()] + [p.grad.clone() for m in layers
                                         for p in m.parameters()])
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@functools.lru_cache(maxsize=None)
def _jax_recompute_step():
    cfg = JErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_mlm_loss = True
    cfg.recompute = True
    paddle.seed(2027)
    model = JErnie(cfg)
    model.train()
    params, buffers = extract_state(model)
    ids, labels = (np.asarray(t) for t in _batch())

    def loss_of(p):
        (loss, _), _ = call_functional(
            model, p, buffers, (jnp.asarray(ids), None, None, None,
                                jnp.asarray(labels)), training=True)
        return loss

    loss, grads = jax.value_and_grad(loss_of)(params)
    return (float(loss), {k: np.asarray(g) for k, g in grads.items()},
            {k: np.asarray(v) for k, v in params.items()})


def test_recompute_matches_the_reference_at_dropout_0():
    ref_loss, ref_grads, params = _jax_recompute_step()
    loss, grads, _, model = _run(True, dropout=0.0, params=params)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=0, atol=1e-5)
    lin = {f"{n}.weight" for n, m in model.named_modules()
           if isinstance(m, torch.nn.Linear)}
    for n, g in grads.items():
        g = g.numpy()
        np.testing.assert_allclose(g.T if n in lin else g, ref_grads[n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)
