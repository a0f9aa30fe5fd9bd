"""The port's semi-automatic parallelism (paddle_tpu_torch.distributed.
auto_parallel and auto_parallel_engine) and its metrics
(paddle_tpu_torch.metric), held to the JAX package.

One world of four gloo ranks (a module-scoped fixture; the rank body is
tests/_torch_dist_ranks.py, which imports no JAX):

- on the (2, 2) mesh [[0, 1], [2, 3]] (dims "dp", "mp") each rank's
  `shard_tensor` block equals the JAX array's shard on the device of the
  same index under the same placements, and every `reshard` (gathers, an all-to-all, a local
  cut, nested splits, Partial) lands on the JAX shard of the target
  placements, exactly;
- the Engine on a dp 2 x mp 2 mesh over the reference test's TP MLP
  (built whole, weights carried from JAX): completion's specs, 2 SGD
  steps held to 2 eager dense steps and to the JAX Engine's 2 steps on 4
  fake devices within the reference test's rtol 2e-4 / atol 1e-5;
  evaluate with Accuracy and predict;
- ZeRO-1 over a `sharding` mesh dim: the losses of the ["sharding", "mp"]
  mesh equal the ["dp", "mp"] mesh's within 1e-5, with half the optimizer
  bytes a rank.

The metrics against paddle_tpu.metric on the same inputs run in this
process.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding

import _torch_dist_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.auto_parallel import \
    _to_partition_spec as jax_spec
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu.io import TensorDataset as JTensorDataset
from paddle_tpu.jit.functional import extract_state
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch.distributed.auto_parallel import _to_partition_spec

T = (np.arange(8 * 4, dtype=np.float32).reshape(8, 4) * 0.5 - 7.0)
_rng = np.random.RandomState(0)
X = _rng.rand(16, 8).astype("float32")
Y = _rng.randint(0, 4, (16, 1)).astype("int64")
_rng = np.random.RandomState(0)
XS = _rng.randn(32, 16).astype("float32")
YS = _rng.randn(32, 8).astype("float32")


def _tp_mlp():
    paddle.seed(77)
    return jnn.Sequential(ColumnParallelLinear(8, 32, gather_output=False),
                          jnn.ReLU(),
                          RowParallelLinear(32, 4, input_is_parallel=True))


def _mlp8():
    paddle.seed(5)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8))


def _torch_layout(params):
    return {k: (np.asarray(v).T.copy() if k.endswith("weight")
                else np.asarray(v)) for k, v in params.items()}


@pytest.fixture(scope="module")
def world():
    tp, _ = extract_state(_tp_mlp())
    mlp8, _ = extract_state(_mlp8())
    return ptd.spawn(ranks.auto_rank,
                     (T, {k: np.asarray(v) for k, v in tp.items()}, X, Y,
                      _torch_layout(mlp8), XS, YS),
                     nprocs=4, device="cpu", timeout=240)


def _jax_mesh(names=("dp", "mp")):
    return Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), names)


def _jax_shards(spec):
    """device index -> the JAX shard of T under the placements `spec`
    (None Replicate, (d,) Shard(d); Partial rows are checked apart)."""
    mesh = jdist.ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    pl = [jdist.Replicate() if s is None else jdist.Shard(s[0])
          for s in spec]
    arr = jax.device_put(T, NamedSharding(_jax_mesh(),
                                          jax_spec(mesh, pl)))
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


def test_partition_spec_is_the_references():
    pm = ptd.ProcessMesh([[0, 1], [2, 3]], ["x", "y"])
    jm = jdist.ProcessMesh(np.arange(4).reshape(2, 2), ["x", "y"])
    for _, src, dst in ranks.RESHARDS:
        for spec in (src, dst):
            if "P" in spec:
                continue
            ppl = ranks._placements(spec)
            jpl = [jdist.Replicate() if s is None else jdist.Shard(s[0])
                   for s in spec]
            assert _to_partition_spec(pm, ppl) == tuple(jax_spec(jm, jpl))


@pytest.mark.parametrize("case", [c[0] for c in ranks.RESHARDS])
def test_shard_and_reshard_land_on_the_jax_shards(world, case):
    _, src, dst = next(c for c in ranks.RESHARDS if c[0] == case)

    def want(spec, r):
        if "P" not in spec:
            return _jax_shards(spec)[r]
        # Partial on mesh dim 0: the value at dp coordinate 0, zeros at 1
        plain = tuple(None if s == "P" else s for s in spec)
        block = _jax_shards(plain)[r]
        return block if r // 2 == 0 else np.zeros_like(block)

    for r in range(4):
        st, rt = world[r]["reshard"][case]
        np.testing.assert_array_equal(st, want(src, r))
        np.testing.assert_array_equal(rt, want(dst, r))


def test_engine_completion(world):
    sh = world[0]["shardings"]
    # the port's (out, in) layout: the column-parallel weight splits dim 0
    assert sh["0.weight"] == ("mp", None) and sh["0.bias"] == ("mp",)
    assert sh["2.weight"] == (None, "mp") and sh["2.bias"] == (None,)
    assert world[0]["local_shapes"]["0.weight"] == (16, 8)
    assert world[0]["local_shapes"]["2.weight"] == (4, 16)
    net = _tp_mlp()
    p, data, _ = jdist.complete_param_shardings(
        net, _jax_mesh(("dp", "mp")))
    assert tuple(p["0.weight"].spec) == tuple(reversed(sh["0.weight"]))
    assert tuple(data.spec) == ("dp",)
    pm = ptd.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
    assert ptd.complete_param_shardings(torch.nn.Linear(2, 2),
                                        pm)[1] == ("dp",)


def test_engine_two_sgd_steps_match_eager_and_jax(world):
    net = _tp_mlp()
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
    eng = jdist.Engine(net, loss=jnn.CrossEntropyLoss(), optimizer=opt,
                       mesh=_jax_mesh(("dp", "mp")))
    ds = JTensorDataset([paddle.to_tensor(X), paddle.to_tensor(Y)])
    jhist = eng.fit(ds, epochs=2, batch_size=16)
    jparams = _torch_layout({k: np.asarray(p._data)
                             for k, p in net.named_parameters()})
    for r in range(4):
        got, eager = world[r]["engine_params"], world[r]["eager_params"]
        for k in got:
            np.testing.assert_allclose(got[k], eager[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got[k], jparams[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(world[r]["engine_losses"],
                                   jhist["loss"], rtol=2e-4, atol=1e-5)


def test_engine_evaluate_and_predict(world):
    for r in range(4):
        ev = world[r]["evaluate"]
        assert set(ev) == {"loss", "acc"} and 0.0 <= ev["acc"] <= 1.0
        assert world[r]["predict"] == [(16, 4)]
    assert len({world[r]["evaluate"]["loss"] for r in range(4)}) == 1


def test_engine_needs_a_mesh():
    eng = ptd.Engine(torch.nn.Linear(2, 2), loss=torch.nn.MSELoss())
    with pytest.raises(ValueError, match="mesh"):
        eng.prepare()


def test_sharding_mesh_is_zero1_of_the_dp_mesh(world):
    for r in range(4):
        sh, dp = world[r]["sharding"], world[r]["dp"]
        np.testing.assert_allclose(sh["losses"], dp["losses"], rtol=1e-5)
        assert sh["opt_bytes"] * 2 == dp["opt_bytes"]


# ------------------------------------------------------------------ metric
_m = np.random.RandomState(3)
PRED = _m.rand(50, 5).astype(np.float32)
LAB = _m.randint(0, 5, (50, 1)).astype(np.int64)
PROB = _m.rand(60).astype(np.float32)
BIN = _m.randint(0, 2, 60).astype(np.int64)


@pytest.mark.parametrize("topk", [1, (1, 3)])
def test_accuracy_matches_the_reference(topk):
    got, ref = pmetric.Accuracy(topk=topk), jmetric.Accuracy(topk=topk)
    for lo, hi in ((0, 20), (20, 50)):
        a = got.update(got.compute(torch.from_numpy(PRED[lo:hi]),
                                   torch.from_numpy(LAB[lo:hi])))
        b = ref.update(ref.compute(PRED[lo:hi], LAB[lo:hi]))
        assert a == b
    assert got.accumulate() == ref.accumulate()
    assert got.name() == ref.name()
    np.testing.assert_array_equal(
        pmetric.accuracy(torch.from_numpy(PRED), torch.from_numpy(LAB),
                         k=2).numpy(),
        np.asarray(jmetric.accuracy(PRED, LAB, k=2)._data))


@pytest.mark.parametrize("cls", ["Precision", "Recall", "Auc"])
def test_binary_metrics_match_the_reference(cls):
    got, ref = getattr(pmetric, cls)(), getattr(jmetric, cls)()
    got.update(torch.from_numpy(PROB), torch.from_numpy(BIN))
    ref.update(PROB, BIN)
    assert got.accumulate() == ref.accumulate()
    got.reset()
    assert got.accumulate() == 0.0
