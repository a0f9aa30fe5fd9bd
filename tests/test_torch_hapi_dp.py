"""The port's data-parallel `paddle.Model` (over DataParallel and the
GroupSharded wrappers) and SyncBatchNorm across ranks, held against the
JAX package on the CPU.

One world of four gloo ranks runs every leg once (a module-scoped
fixture; the rank body is tests/_torch_hapi_ranks.py, which imports no
JAX), each rank its quarter of the global batch; the JAX references run
here, jitted, on the global batch:

- tests/test_distributed.py's DataParallel test through `Model` (Linear
  16 -> 32 -> 4, Momentum(0.05), cross entropy, 3 `train_batch` steps):
  losses within rtol 2e-5 and every parameter within rtol 2e-5 / atol
  1e-6 of the JAX `Model` over `DataParallel` on the 8-device mesh;
- `fit` over a Dataset (a DistributedBatchSampler, 4 rows a rank), then
  `evaluate` and `predict`: the rows equal on every rank and within
  rtol 1e-4 / atol 1e-5 of the reference worker's `run_hapi_eval` on
  the same global batches (tests/_multiproc_train_worker.py);
- a conv + SyncBatchNorm net (inputs with mean 5 a channel) against the
  JAX BatchNorm net over the global batch: output rows, loss and every
  gradient of one step within rtol 1e-4 / atol 1e-5, then 2 Momentum
  steps through Model: losses, parameters and running statistics within
  rtol 1e-4 / atol 1e-5 and the eval rows within the same;
- plain BatchNorm under DataParallel against the JAX net on each rank's
  rows alone (Paddle's semantics; the reference's BatchNorm is global):
  each rank's output rows and running statistics, and the gradients
  averaged over the ranks' shards, within rtol 1e-4 / atol 1e-5;
- SyncBatchNorm in a world of one rank is BatchNorm bit for bit;
- GroupSharded through Model (tests/test_hapi_sharding.py): stage 2's
  losses equal stage 1's within rtol 1e-5, every level's losses and
  parameters against the JAX Model over the whole batch within rtol
  2e-5 / atol 1e-6, stage 3 holds a quarter of the parameter bytes a
  rank, stage 2 at O1 lowers its loss over 8 steps, Model steps the
  optimizer `group_sharded_parallel` returned; the facade's train and
  gathered save at every level (tests/test_distributed.py
  TestShardingFacade); `ModelCheckpoint(async_save=True)` through stage
  3, loaded at world 1 into a fresh net (rtol 1e-6, as the reference's
  test_async_dist_checkpoint_through_model_checkpoint);
- unequal local batches raise ValueError on every rank.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_hapi_ranks as ranks
import paddle_tpu as jp
import paddle_tpu.distributed as jdist
import paddle_tpu.nn as jnn
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu_torch import device as tdevice
import paddle_tpu_torch as tp
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import sharding
from paddle_tpu_torch.weights import load_reference_layer
from _reference_init import numpy_init

_rng = np.random.RandomState(0)
DP_X = _rng.rand(64, 16).astype("float32")
DP_Y = _rng.randint(0, 4, (64, 1)).astype("int64")
_rng = np.random.RandomState(4)
BN_X = (_rng.randn(16, 3, 8, 8) + 5.0).astype("float32")
BN_Y = _rng.randint(0, 4, (16, 1)).astype("int64")
BN_EX = (_rng.randn(16, 3, 8, 8) + 5.0).astype("float32")
_rng = np.random.RandomState(0)
SH_X = _rng.randn(32, 16).astype("float32")
SH_Y = _rng.randn(32, 8).astype("float32")
TOL = dict(rtol=1e-4, atol=1e-5)


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


def _np_state(net):
    return {k: np.asarray(v._data) for k, v in net.state_dict().items()}


def _jmlp(sizes, seed):
    jp.seed(seed)
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers += ([jnn.ReLU()] if i else []) + [jnn.Linear(a, b)]
    return jnn.Sequential(*layers)


def _jbn_net():
    with numpy_init(5):
        return jnn.Sequential(jnn.Conv2D(3, 6, 3, padding=1),
                              jnn.BatchNorm2D(6), jnn.ReLU(),
                              jnn.AdaptiveAvgPool2D(1), jnn.Flatten(),
                              jnn.Linear(6, 4))


def _model(net, opt, loss, metrics=None):
    m = jp.Model(net)
    m.prepare(opt, loss, metrics)
    return m


@pytest.fixture(scope="module")
def refs():
    """The weights every leg starts from (each a fresh JAX net's)."""
    from tests._multiproc_train_worker import build_cls_model

    return dict(
        dp_w=_np_state(_jmlp([16, 32, 4], 42)), dp_x=DP_X, dp_y=DP_Y,
        cls_w=_np_state(build_cls_model()),
        bn_w=_np_state(_jbn_net()), bn_x=BN_X, bn_y=BN_Y, bn_ex=BN_EX,
        sh_w=_np_state(_jmlp([16, 64, 8], 7)), sh_x=SH_X, sh_y=SH_Y,
        ck_w=_np_state(_jmlp([8, 16, 4], 21)))


@pytest.fixture(scope="module")
def world(refs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("hapi_dp"))
    out = ptd.spawn(ranks.hapi_rank, (tmp, refs), nprocs=4, device="cpu",
                    timeout=240)
    return tmp, out


def _close_tree(got, want, err="", **tol):
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{err}{k}",
                                   **tol)


def test_data_parallel_model_matches_the_jax_dp_model(world, refs):
    net = _jmlp([16, 32, 4], 42)
    model = _model(jdist.DataParallel(net), jp.optimizer.Momentum(
        learning_rate=0.05, parameters=net.parameters()),
        jnn.CrossEntropyLoss())
    ref = [float(model.train_batch([DP_X], [DP_Y])[0]) for _ in range(3)]
    want = _np_state(net)
    for r in world[1]:
        np.testing.assert_allclose(r["dp"]["losses"], ref, rtol=2e-5)
        _close_tree(r["dp"]["params"], want, rtol=2e-5, atol=1e-6)
    assert len({tuple(r["dp"]["losses"]) for r in world[1]}) == 1


def test_fit_evaluate_predict_rows_match_run_hapi_eval(world):
    from tests._multiproc_train_worker import (ClsDS, build_cls_model,
                                               run_hapi_eval)

    rows = [r["fit"] for r in world[1]]
    assert all(row == rows[0] for row in rows), rows
    assert rows[0][3] == (ranks.N, ranks.NCLS)
    net = build_cls_model()
    model = _model(net, jp.optimizer.Adam(learning_rate=0.05,
                                          parameters=net.parameters()),
                   jnn.CrossEntropyLoss(), jp.metric.Accuracy())
    # DistributedBatchSampler gives rank r rows [8r, 8r + 8): global batch
    # t is each rank's t-th 4 rows, in rank order
    per = ranks.N // 4
    order = [[i for r in range(4) for i in range(
        per * r + ranks.LOCAL_BS * t, per * r + ranks.LOCAL_BS * (t + 1))]
        for t in range(per // ranks.LOCAL_BS)]

    def loader():
        return jp.io.DataLoader(ClsDS(), batch_sampler=list(order))

    ref = run_hapi_eval(model, (loader(), loader(), loader()))
    np.testing.assert_allclose(rows[0][:3], ref[:3], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def bn_reference(refs):
    """The JAX BatchNorm net over the global batch: one step's outputs,
    loss and gradients; 2 Momentum steps through Model (losses, state),
    then the eval rows of BN_EX."""
    net = _jbn_net()
    params, buffers = extract_state(net)
    ce = jnn.CrossEntropyLoss()

    def loss_of(p, x, y):
        out, new_b = call_functional(net, p, buffers, (x,), training=True)
        loss = call_functional(ce, {}, {}, (out, y), training=True)[0]
        return loss, (out, new_b)

    step = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    (loss, (out, _)), grads = step(params, jnp.asarray(BN_X),
                                   jnp.asarray(BN_Y))
    shards = [step(params, jnp.asarray(ranks._rows(BN_X, r, 4)),
                   jnp.asarray(ranks._rows(BN_Y, r, 4))) for r in range(4)]
    first = dict(out=np.asarray(out), loss=float(loss),
                 grads={k: np.asarray(v) for k, v in grads.items()})
    plain = dict(
        out=[np.asarray(s[0][1][0]) for s in shards],
        buffers=[{k: np.asarray(v) for k, v in s[0][1][1].items()}
                 for s in shards],
        grads={k: np.mean([np.asarray(s[1][k]) for s in shards], axis=0)
               for k in grads})
    model = _model(net, jp.optimizer.Momentum(learning_rate=0.1,
                                              parameters=net.parameters()),
                   ce)
    losses = [float(model.train_batch([BN_X], [BN_Y])[0]) for _ in range(2)]
    pred = model.predict_batch([BN_EX])[0]
    return dict(first=first, plain=plain, losses=losses,
                state=_np_state(net), pred=np.asarray(pred), init=params)


def test_sync_batch_norm_matches_the_global_batch_norm(world, bn_reference):
    ref = bn_reference
    for r in world[1]:
        s = r["sync_bn"]
        np.testing.assert_allclose(s["first"]["out"], ref["first"]["out"],
                                   **TOL)
        np.testing.assert_allclose(s["first"]["loss"], ref["first"]["loss"],
                                   **TOL)
        _close_tree(s["first"]["grads"], ref["first"]["grads"], "grad ",
                    **TOL)
        np.testing.assert_allclose(s["losses"], ref["losses"], **TOL)
        _close_tree(s["state"], ref["state"], **TOL)
        np.testing.assert_allclose(s["pred"], ref["pred"], **TOL)


def test_plain_batch_norm_under_dp_normalizes_each_rank(world,
                                                        bn_reference):
    ref = bn_reference["plain"]
    for r in world[1]:
        p, me = r["plain_bn"], r["rank"]
        np.testing.assert_allclose(p["out"], ref["out"][me], **TOL)
        for k in ("1._mean", "1._variance"):
            np.testing.assert_allclose(p["state"][k], ref["buffers"][me][k],
                                       **TOL)
        _close_tree(p["grads"], ref["grads"], "grad ", **TOL)


def test_sync_batch_norm_in_a_world_of_one_is_batch_norm(refs):
    x = torch.from_numpy(BN_X)
    outs = []
    for sync in (False, True):
        net = ranks.bn_net(tp.nn.BatchNorm2D)
        load_reference_layer(net, refs["bn_w"])
        if sync:
            net = tp.nn.SyncBatchNorm.convert_sync_batchnorm(net)
            assert type(net[1]).__name__ == "SyncBatchNorm"
        out = net(tp.Tensor._wrap(x))
        out._t.square().sum().backward()
        outs.append((out._t, {k: p._t.grad for k, p in
                              net.named_parameters()},
                     {k: v._t for k, v in net.state_dict().items()}))
    (o0, g0, s0), (o1, g1, s1) = outs
    assert torch.equal(o0, o1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_group_sharded_through_model(world):
    net = _jmlp([16, 64, 8], 7)
    model = _model(net, jp.optimizer.Adam(learning_rate=0.01,
                                          parameters=net.parameters()),
                   jnn.MSELoss())
    ref = [float(np.sum(model.train_batch([SH_X], [SH_Y])[0]))
           for _ in range(3)]
    want = _np_state(net)
    for r in world[1]:
        sh = r["sharding"]
        np.testing.assert_allclose(sh["os_g"]["losses"], sh["os"]["losses"],
                                   rtol=1e-5)
        for level in ("os", "os_g", "p_g_os"):
            np.testing.assert_allclose(sh[level]["losses"], ref, rtol=2e-5)
            _close_tree(sh[level]["params"], want, f"{level} ", rtol=2e-5,
                        atol=1e-6)
            assert sh[level]["steps_sharded"], level
        full = sh["p_g_os"]["full_bytes"]
        assert sh["os"]["local_bytes"] == full
        # each parameter's (chunk,) slice: a quarter, up to padding
        assert full <= 4 * sh["p_g_os"]["local_bytes"] < full + 4 * 4 * 4
        assert np.isfinite(sh["o1"]).all() and sh["o1"][-1] < sh["o1"][0]


def test_model_steps_the_optimizer_group_sharded_parallel_returned():
    net = ranks.mlp([8, 16, 4])
    opt = tp.optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    for level in ("os", "os_g", "p_g_os"):
        wrapped, sopt = sharding.group_sharded_parallel(
            ranks.mlp([8, 16, 4]), opt, level=level)
        model = tp.Model(wrapped)
        model.prepare(optimizer=opt, loss=tp.nn.MSELoss())
        assert wrapped.sharded_optimizer is sopt
        assert model._sharded_opt is sopt


def test_sharding_facade_train_and_save(world):
    shapes = {"0.weight": (8, 16), "0.bias": (16,), "2.weight": (16, 4),
              "2.bias": (4,)}
    for r in world[1]:
        for level, f in r["facade"].items():
            assert f["finite"] and f["files"] == [True, True], (level, f)
            assert f["shapes"] == shapes, (level, f["shapes"])


def test_async_checkpoint_through_stage3_loads_at_world_one(world, refs):
    from paddle_tpu_torch.distributed import checkpoint as dck

    tmp, out = world
    trained = out[0]["ckpt"]["trained"]
    for r in out:
        assert r["ckpt"]["dirs"] == ["0", "1", "2", "final"]
        assert not r["ckpt"]["pending"]
        _close_tree(r["ckpt"]["trained"], trained, rtol=0, atol=0)
    for sub in ("0", "1", "2", "final"):
        assert os.path.isdir(os.path.join(tmp, "ckpt", sub, "model")), sub
    fresh = ranks.mlp([8, 16, 4])
    sd = {k: v._t for k, v in fresh.state_dict().items()}
    dck.load_state_dict(sd, os.path.join(tmp, "ckpt", "final", "model"))
    _close_tree({k: v.detach().numpy() for k, v in sd.items()}, trained,
                rtol=1e-6)
    assert not np.allclose(trained["0.weight"], refs["ck_w"]["0.weight"])


def test_unequal_local_batches_raise_on_every_rank(world):
    for r in world[1]:
        assert r["unequal"] and "batch sizes differ" in r["unequal"], r
