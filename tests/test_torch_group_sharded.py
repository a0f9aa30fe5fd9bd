"""The port's GroupSharded surface (paddle_tpu_torch.parallel.zero:
`group_sharded_parallel` at levels os / os_g / p_g_os, `GroupShardedStage2`
/ `GroupShardedStage3` / `GroupShardedOptimizerStage2`, offload,
`save_group_sharded_model`, the facades) held against the JAX package and
against the port's ZeroTrainStep (counterpart of
tests/test_fleet_hybrid.py :234-286, tests/test_zero_depth.py and
tests/test_zero.py TestGroupShardedBridge).

One world of four gloo ranks (a module-scoped fixture; the rank body is
tests/_torch_fleet_ranks.py, no JAX there) trains the reference tests'
MLP (16 -> 32 -> 8 -> 4 with ReLUs, cross entropy, Adam lr 0.01, 3 steps,
each rank its 8 of the 32 rows) at every level:

- every level's parameters bit for bit equal to ZeroTrainStep(stage=0)'s
  on the same batch (stage 3's gathered from its slices), offload too;
- the losses, averaged over the ranks, within rtol 3e-5 of the JAX MLP
  trained on the whole batch (the reference's bound: each rank's mean
  over its rows, then the mean of means);
- stage 3 holds a quarter of each parameter a rank (its (chunk,) slice)
  and a quarter of stage 0's optimizer bytes, up to padding; stages 1 / 2
  hold whole parameters and sliced slots;
- the wrapper's zero_train_step() is the native engine (bit for bit),
  stage 3 refuses it, and fleet.distributed_optimizer at sharding 4
  builds ZeRO-1 over the group.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_fleet_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit.functional import call_functional, extract_state

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.parallel import zero as Z


def _jax_mlp():
    paddle.seed(21)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8),
                          jnn.ReLU(), jnn.Linear(8, 4))


@functools.lru_cache(maxsize=None)
def _oracle():
    """The MLP's weights, the batch and the JAX losses of 3 Adam steps on
    the whole batch."""
    net = _jax_mlp()
    params, _ = extract_state(net)
    rng = np.random.RandomState(2)
    x = rng.rand(32, 16).astype("float32")
    y = rng.randint(0, 4, (32, 1))
    opt = paddle.optimizer.Adam(learning_rate=ranks.LR,
                                parameters=net.parameters())
    ce = jnn.CrossEntropyLoss()

    @jax.jit
    def step(p, st, t):
        def loss_of(pp):
            out = call_functional(net, pp, {}, (jnp.asarray(x),),
                                  training=True)[0]
            return call_functional(ce, {}, {}, (out, jnp.asarray(y)),
                                   training=True)[0]

        loss, g = jax.value_and_grad(loss_of)(p)
        p, st = opt.functional_step(p, g, st, jnp.float32(ranks.LR), t)
        return loss, p, st

    st = opt.functional_state(params)
    p, losses = params, []
    for t in range(1, 4):
        loss, p, st = step(p, st, jnp.int32(t))
        losses.append(float(loss))
    data = dict(mlp={k: np.asarray(v) for k, v in params.items()}, x=x, y=y)
    return data, losses


@pytest.fixture(scope="module")
def every_rank():
    data, _ = _oracle()
    return ptd.spawn(ranks.sharding_rank, (data,), nprocs=4, device="cpu",
                     timeout=240)


@pytest.fixture(scope="module")
def world(every_rank):
    return every_rank[0]


LEVELS = [("os", 1), ("os_g", 2), ("p_g_os", 3)]


@pytest.mark.parametrize("level,stage", LEVELS)
def test_every_level_equals_zero_stage0_bitwise(every_rank, level, stage):
    for r in every_rank:
        assert r[level]["stage"] == stage
        assert r[level]["equal"]


def test_group_sharded_stage3_matches_replica(every_rank):
    _, losses = _oracle()
    for r in every_rank:
        np.testing.assert_allclose(r["p_g_os"]["losses"], losses, rtol=3e-5)
        np.testing.assert_allclose(r["zero0"]["losses"], losses, rtol=3e-5)


def test_stage3_placement_and_memory(world):
    rec = world["p_g_os"]
    # every parameter a flat quarter: 16 * 32 / 4, 32 / 4, ... 4 / 4
    assert rec["shapes"]["2.weight"] == (8 * 32 // 4,)
    assert rec["shapes"]["4.bias"] == (1,)
    full = world["zero0"]["param_bytes"]
    assert full / 4 <= rec["param_bytes"] <= full / 4 + 4 * 4 * 6
    opt0 = world["zero0"]["opt_bytes"]
    assert opt0 / 4 <= rec["opt_bytes"] <= opt0 / 4 + 2 * 4 * 4 * 6


@pytest.mark.parametrize("level", ["os", "os_g"])
def test_stage12_placement(world, level):
    rec = world[level]
    assert rec["shapes"]["0.weight"] == (32, 16)     # whole parameters
    assert (16 * 32 // 4,) in rec["slot_shapes"]     # sliced slots
    opt0 = world["zero0"]["opt_bytes"]
    assert opt0 / 4 <= rec["opt_bytes"] <= opt0 / 4 + 2 * 4 * 4 * 6


def test_offload_keeps_the_slots_on_the_host(every_rank):
    for r in every_rank:
        assert r["offload"]["equal"]
        assert r["offload"]["devices"] == ["cpu"]


def test_save_group_sharded_model(world):
    s = world["saved"]
    assert s["opt"]
    assert s["shapes"]["0.weight"] == (32, 16)
    assert s["shapes"]["4.bias"] == (4,)


def test_wrapper_bridges_to_the_one_engine(every_rank):
    for r in every_rank:
        b = r["bridge"]
        assert (b["stage"], b["dp"]) == (1, 4)
        assert b["loss_equal"] and b["equal"]


def test_stage3_bridge_refused(world):
    assert "stage 3" in world["stage3_bridge"]


def test_fleet_distributed_optimizer_bridge(world):
    b = world["fleet_bridge"]
    assert (b["dp"], b["stage"]) == (4, 1) and b["finite"]


def test_group_sharded_levels():
    for level, stage in LEVELS:
        net = ranks.mlp4()
        w, o = Z.group_sharded_parallel(net, Adam(
            parameters=net.parameters()), level=level)
        assert w.stage == stage and o.stage == stage
    with pytest.raises(ValueError, match="p_g_os"):
        Z.group_sharded_parallel(net, Adam(parameters=net.parameters()),
                                 level="p_g")


def test_legacy_import_paths_resolve_to_parallel_zero():
    from paddle_tpu_torch.distributed import sharding as dist_sharding
    from paddle_tpu_torch.distributed.fleet.meta_parallel import sharding

    assert sharding.group_sharded_parallel is Z.group_sharded_parallel
    assert dist_sharding.group_sharded_parallel is Z.group_sharded_parallel
    assert dist_sharding.save_group_sharded_model is \
        Z.save_group_sharded_model
