"""The port's training observability plane
(paddle_tpu_torch.observability.training) against the JAX package's
(paddle_tpu/observability/training.py; oracle tests/test_training_obs.py).

The sentinel's verdicts equal the reference sentinel's on the same
sequences of (loss, grad norm, non-finite) scalars (host arithmetic:
exactly). A world of four gloo ranks (tests/_torch_train_ranks.py, spawned
once) runs the ZeRO step with telemetry off and on: the same parameters
bit for bit, one host drain a step, the snapshot under the reference's
schema, the bf16 scaler fields in the same vector, and a NaN step that
trips the sentinel and writes one bundle that tools/postmortem.py and
tools/training_report.py render.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import _torch_train_ranks as ranks
from paddle_tpu.observability import training as jtr
from paddle_tpu.observability.metrics import MetricsRegistry as JRegistry
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.observability import training as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_rng = np.random.RandomState(1)
X = _rng.randn(32, 16).astype("float32")
Y = _rng.randn(32, 8).astype("float32")


def _weights():
    torch.manual_seed(9)
    net = torch.nn.Sequential(torch.nn.Linear(16, 48), torch.nn.ReLU(),
                              torch.nn.Linear(48, 8))
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def world():
    return ptd.spawn(ranks.telemetry_rank, (_weights(), X, Y), nprocs=4,
                     device="cpu", timeout=240)


def _load_cli(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------- sentinel
SEQUENCES = {
    "clean": [(1.0 / t, 0.5, 0) for t in range(1, 40)],
    "nan loss": [(1.0, 1.0, 0)] * 3 + [(float("nan"), 1.0, 0)],
    "nonfinite grads": [(1.0, 1.0, 0)] * 3 + [(1.0, 1.0, 3.0)],
    "inf grad norm": [(1.0, float("inf"), 0)],
    "loss spike": [(1.0, 0.5, 0)] * 11 + [(10.0, 0.5, 0)],
    "grad spike": [(1.0, 1.0, 0)] * 9 + [(1.0, 50.0, 0)],
    "plateau": [(1.0, 0.5, 0)] * 20,
    "spike before warmup": [(1.0, 0.5, 0)] * 8 + [(100.0, 0.5, 0)],
}
CONFIGS = {"default": {}, "short windows": dict(
    window=4, warmup_steps=4, plateau_steps=10)}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_sentinel_verdicts_equal_reference(seq, config):
    cfg = CONFIGS[config]
    port = T.DivergenceSentinel(MetricsRegistry(), T.SentinelConfig(**cfg))
    ref = jtr.DivergenceSentinel(JRegistry(), jtr.SentinelConfig(**cfg))
    for t, (loss, g, nf) in enumerate(SEQUENCES[seq], 1):
        a = port.check(step=t, loss=loss, grad_norm=g, nonfinite=nf)
        b = ref.check(step=t, loss=loss, grad_norm=g, nonfinite=nf)
        assert a == b, (t, a, b)
    assert port.state() == ref.state()


def test_sentinel_config_validation():
    with pytest.raises(ValueError, match="trip conditions"):
        T.SentinelConfig(trip_on=("nan", "comets"))
    with pytest.raises(ValueError, match="spike factors"):
        T.SentinelConfig(loss_spike_factor=0.5)
    with pytest.raises(ValueError, match="window"):
        T.SentinelConfig(window=0)


def test_probe_best_of_is_the_minimum():
    trials = [3.0, 1.0, 2.0]
    assert T.probe_best_of(trials) == 1.0
    assert T.probe_best_of(trials + [0.5]) <= T.probe_best_of(trials)


def test_pack_health_fields():
    class Ctx:
        group = None

    old = {"a": torch.ones(3), "b": torch.zeros(2)}
    new = {"a": torch.full((3,), 2.0), "b": torch.tensor([float("inf"),
                                                          0.0])}
    aux = T.grad_leaf_stats(Ctx(), {"a": torch.full((3,), 2.0),
                                    "b": torch.tensor([0.0, float("nan")])},
                            dp_reduce=False)
    vec = T.pack_health(Ctx(), torch.tensor(0.5), old, new, aux,
                        extras=(torch.tensor(8.0), torch.tensor(1.0)))
    v = vec.tolist()
    assert len(v) == len(T.HEALTH_FIELDS) + len(T.SCALER_FIELDS)
    assert v[0] == 0.5 and np.isnan(v[1])          # a NaN gradient
    assert v[4] == 1.0 and v[5] == 1.0             # non-finite counts
    assert v[6:] == [8.0, 1.0]


def test_bind_rejects_a_geometry_change():
    tele = T.TrainingTelemetry()
    tele.bind(dp=2, tp=1, stage=1, device_ids=[0, 1])
    tele.bind(dp=2, tp=1, stage=1, device_ids=[0, 1])   # idempotent
    with pytest.raises(ValueError, match="already bound"):
        tele.bind(dp=4, tp=1, stage=1, device_ids=[0, 1, 2, 3])
    assert T.TrainingTelemetry().summary() == {"bound": False}


# --------------------------------------------------- on the four ranks
def test_telemetry_on_equals_off(world):
    assert all(r["on_equals_off"] for r in world)


def test_one_host_drain_a_step(world):
    s = world[0]["summary"]
    assert s["steps"] == 3 and s["host_syncs"] == 3
    assert s["tokens"] == 3 * X.shape[0]
    assert set(s["phases"]) == set(T.PHASES)


def test_snapshot_schema(world):
    snap = world[0]["snapshot"]
    assert snap["schema"] == T.TRAINING_SNAPSHOT_SCHEMA == \
        jtr.TRAINING_SNAPSHOT_SCHEMA
    assert snap["geometry"] == {"dp": 4, "tp": 1, "stage": 2,
                                "devices": [0, 1, 2, 3]}
    last = snap["steps"][-1]
    assert set(last) == {"step", "loss", "grad_norm", "param_norm",
                         "update_norm", "nonfinite", "tokens", "wall_s"}
    assert last["loss"] == world[0]["losses_on"][-1]
    names = {m["name"] for m in snap["metrics"]["metrics"]}
    assert {"training_step_phase_seconds", "training_steps_total",
            "training_host_syncs_total", "training_grad_norm"} <= names
    json.dumps(snap)
    # every rank drained the same replicated vector
    assert all(r["snapshot"]["steps"][-1]["grad_norm"] == last["grad_norm"]
               for r in world)


def test_bf16_scaler_fields_ride_the_same_vector(world):
    last = world[0]["bf16_last"]
    assert last["loss_scale"] == 2.0 ** 15 and last["skipped"] is False


def test_nan_step_trips_and_writes_one_bundle(world, tmp_path):
    for rank, r in enumerate(world):        # only rank 0 writes
        assert r["tripped"] == dict(condition="nan", path=rank == 0)
    text = world[0]["bundle_text"]
    bundle = json.loads(text)
    assert bundle["schema"] == "paddle_tpu.postmortem/v1"
    assert bundle["training"]["verdict"]["condition"] == "nan"
    assert bundle["training"]["geometry"]["dp"] == 4
    path = tmp_path / "training-postmortem.json"
    path.write_text(text)
    pm = _load_cli("postmortem")
    rendered = pm.render(pm.load_bundle(str(path)))
    assert "training run: dp=4" in rendered and "TRIPPED nan" in rendered
    tr = _load_cli("training_report")
    training, snapshot, doc = tr.load_report(str(path))
    assert "training post-mortem: diverged-nan" in tr.render(
        training, snapshot, doc)
