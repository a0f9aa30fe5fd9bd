"""The port's DataParallel (paddle_tpu_torch.distributed.parallel) over
gloo ranks on the CPU, held to the JAX package and to ZeroTrainStep.

One world of four ranks runs every leg once (a module-scoped fixture;
the rank body is tests/_torch_dist_ranks.py, which imports no JAX): dp 4
on the world, dp 2 on {0, 1} and {2, 3}. Held:

- dp 2 against the JAX single-device Momentum steps of
  tests/test_distributed.py's DataParallel test (`paddle.Model`,
  CrossEntropyLoss, 3 steps), weights carried across: losses and every
  parameter within rtol 2e-5;
- bit for bit against `ZeroTrainStep(stage=0)` at dp 4 and dp 2, and at
  dp 4 with buckets small enough that every parameter rides its own (3
  Adam steps of an MSE MLP): the gradients are summed in rank order and
  scaled once, as stage 0 does;
- `no_sync`: two local backwards, then a synced one, equal to every
  rank's local sum gathered and summed in rank order; an unused branch
  gets zeros with `find_unused_parameters=True` and makes the backward
  raise on every rank without it; `fleet.distributed_model` at pure dp
  gives a DataParallel over the hcg's dp group;
- the tiny ERNIE (fp32, dropout 0) at dp 2: loss and gradients against
  the JAX ERNIE's `value_and_grad` over the global batch (within 1e-5 /
  rtol 1e-4, atol 1e-5, as tests/test_torch_ernie.py), and one Adam step
  bit for bit against ZeroTrainStep(stage=0);
- a real two-process run through the port's launcher
  (tests/_torch_dp_worker.py: init_parallel_env(), DistributedBatchSampler,
  DataLoader, DataParallel, Adam) against the JAX single-process losses
  of `_dp_reference_losses()` (tests/test_distributed.py), rtol 1e-4;
  the JAX package skips its own two-process run on the CPU.
"""
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu_torch import distributed as ptd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_rng = np.random.RandomState(0)
X = _rng.rand(64, 16).astype("float32")
Y = _rng.randint(0, 4, (64, 1)).astype("int64")
_rng = np.random.RandomState(1)
XR = _rng.randn(32, 16).astype("float32")
YR = _rng.randn(32, 4).astype("float32")
_b = np.random.RandomState(5)
IDS = _b.randint(0, 1024, (4, 24)).astype(np.int64)
LABELS = _b.randint(0, 1024, (4, 24)).astype(np.int64)


def _torch_layout(params):
    return {k: (np.asarray(v).T.copy() if k.endswith("weight")
                else np.asarray(v)) for k, v in params.items()}


def _jax_net():
    paddle.seed(42)
    net = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4))
    model = paddle.Model(net)
    model.prepare(paddle.optimizer.Momentum(learning_rate=0.05,
                                            parameters=net.parameters()),
                  jnn.CrossEntropyLoss())
    return net, model


def _ernie_cfg():
    cfg = JErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


@pytest.fixture(scope="module")
def ernie_params():
    paddle.seed(2024)
    m = JErnie(_ernie_cfg())
    m.train()
    params, _ = extract_state(m)
    return m, {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def world(ernie_params):
    net, _ = _jax_net()
    params, _ = extract_state(net)
    out = ptd.spawn(ranks.dp_rank,
                    (_torch_layout(params), X, Y, XR, YR, ernie_params[1],
                     IDS, LABELS), nprocs=4, device="cpu", timeout=240)
    return out


def test_dp2_matches_the_jax_single_device_steps(world):
    net, model = _jax_net()
    ref = [float(model.train_batch([X], [Y])[0]) for _ in range(3)]
    params, _ = extract_state(net)
    for r in (0, 2):
        losses, got = world[r]["momentum"]
        np.testing.assert_allclose(losses, ref, rtol=2e-5)
        for k, v in _torch_layout(params).items():
            np.testing.assert_allclose(got[k], v, rtol=2e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("leg", ["parity4", "parity2",
                                 "parity4_small_buckets"])
def test_bit_identical_to_zero_stage0(world, leg):
    for r in range(4):
        z_losses, z_params, d_losses, d_params = world[r][leg]
        assert z_losses == d_losses
        for k in z_params:
            np.testing.assert_array_equal(d_params[k], z_params[k],
                                          err_msg=k)


def test_no_sync_accumulates_then_reduces_the_sum(world):
    for r in range(4):
        assert all(world[r]["no_sync"].values()), world[r]["no_sync"]


def test_unused_parameters(world):
    for r in range(4):
        u = world[r]["unused"]
        assert not u["unused_grad"].any()
        assert u["used_grad"].any()
        assert "find_unused_parameters" in u["refusal"]
        assert "unused.weight" in u["refusal"]
        np.testing.assert_array_equal(u["after"], [4.0])


def test_fleet_distributed_model_at_pure_dp(world):
    for r in range(4):
        f = world[r]["fleet"]
        assert f["type"] == "DataParallel"
        assert f["ranks"] == [0, 1, 2, 3] and f["same_group"]
        assert f["data_spec"] == ("dp",) and f["param_spec"] == ()


def test_descriptors_and_state_dict_match_the_reference():
    """data_sharding / param_sharding name the reference's specs; the
    state dict carries no `_layers.` prefix (a world of one rank)."""
    from jax.sharding import PartitionSpec as P

    import paddle_tpu.distributed as jdist

    jdp = jdist.DataParallel(jnn.Linear(8, 2))
    dp = ptd.DataParallel(torch.nn.Linear(8, 2))
    assert dp.data_sharding().spec == tuple(jdp.data_sharding().spec) \
        == tuple(P(("dp",)))
    assert dp.param_sharding().spec == tuple(jdp.param_sharding().spec)
    assert set(dp.state_dict()) == {"weight", "bias"}
    sd = {k: torch.zeros_like(v) for k, v in dp.state_dict().items()}
    dp.set_state_dict(sd)
    assert not dp._layers.weight.any()


def test_ernie_dp2_step_matches_jax_and_zero(world, ernie_params):
    model, params = ernie_params
    _, buffers = extract_state(model)

    def loss_of(p):
        (loss, _), _ = call_functional(
            model, p, buffers, (jnp.asarray(IDS), None, None, None,
                                jnp.asarray(LABELS)), training=True)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(
        {k: jnp.asarray(v) for k, v in params.items()})
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

    port = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    lin = {f"{n}.weight" for n, mod in port.named_modules()
           if isinstance(mod, torch.nn.Linear)}
    for r in (0, 2):
        e = world[r]["ernie"]
        assert e["differ"] == [], e["differ"]
        assert e["loss"] == e["zero_loss"]
        np.testing.assert_allclose(e["loss"], float(loss), rtol=0, atol=1e-5)
        for k, g in e["grads"].items():
            want = np.asarray(grads[k])
            np.testing.assert_allclose(g.T if k in lin else g, want,
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_fleetrun_two_process_dp_matches_reference(tmp_path):
    from test_distributed import _dp_reference_losses

    from tests._multiproc_train_worker import build_model

    params, _ = extract_state(build_model())
    weights = tmp_path / "w.npz"
    np.savez(weights, **_torch_layout(params))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master", f"127.0.0.1:{port}",
         os.path.join(REPO, "tests", "_torch_dp_worker.py"), str(weights)],
        capture_output=True, text=True, env=env, timeout=180, cwd=REPO)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    losses = {(int(m[1]), int(m[2])): float(m[3]) for m in re.finditer(
        r"rank=(\d) step=(\d) loss=([-\d.]+)", out.stdout)}
    assert len(losses) == 8, out.stdout
    for t in range(1, 5):
        assert losses[(0, t)] == losses[(1, t)]
    got = [losses[(0, t)] for t in range(1, 5)]
    np.testing.assert_allclose(got, _dp_reference_losses(), rtol=1e-4,
                               atol=1e-6)
