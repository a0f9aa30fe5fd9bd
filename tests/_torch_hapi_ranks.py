"""Rank bodies of tests/test_torch_hapi_dp.py: the port's `paddle.Model`
over DataParallel, SyncBatchNorm and the GroupSharded wrappers, run by
`paddle_tpu_torch.distributed.spawn` over gloo on the CPU in a world of
four ranks. This module imports neither JAX nor paddle_tpu; the test
computes the JAX references in its own process, hands the weights and
inputs in as numpy and reads numpy results back."""
import os

import numpy as np
import torch

import paddle_tpu_torch as tp
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import checkpoint as dck
from paddle_tpu_torch.distributed import sharding as shard
from paddle_tpu_torch.hapi.callbacks import ModelCheckpoint
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.weights import load_reference_layer

nn = tp.nn

# the reference's fit / evaluate / predict worker
# (tests/_multiproc_train_worker.py): its dataset and sizes
N, IN, NCLS, LOCAL_BS, STEPS = 32, 8, 4, 4, 4


class ClsDS(Dataset):
    """Deterministic classification rows keyed by index (the reference
    worker's ClsDS)."""

    def __len__(self):
        return N

    def __getitem__(self, i):
        rng = np.random.RandomState(2000 + i)
        return rng.randn(IN).astype(np.float32), np.int64(i % NCLS)


def _np(t):
    t = getattr(t, "_t", t)
    return t.detach().float().cpu().numpy()


def _state(layer):
    return {k: _np(v) for k, v in layer.state_dict().items()}


def _rows(x, me, n):
    per = x.shape[0] // n
    return x[me * per:(me + 1) * per]


def _built(make, weights):
    net = make()
    load_reference_layer(net, weights)
    return net


def mlp(sizes):
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        layers += ([nn.ReLU()] if i else []) + [nn.Linear(a, b)]
    return nn.Sequential(*layers)


def bn_net(norm):
    """Conv, a BatchNorm (`norm`), ReLU, pool and a linear head."""
    return nn.Sequential(nn.Conv2D(3, 6, 3, padding=1), norm(6), nn.ReLU(),
                         nn.AdaptiveAvgPool2D(1), nn.Flatten(),
                         nn.Linear(6, 4))


def dp_model_leg(w, x, y, me, n):
    """The reference's DataParallel test through Model: Momentum(0.05),
    cross entropy, 3 train_batch steps on this rank's rows."""
    net = _built(lambda: mlp([16, 32, 4]), w)
    model = tp.Model(tp.DataParallel(net))
    model.prepare(tp.optimizer.Momentum(learning_rate=0.05,
                                        parameters=model.parameters()),
                  nn.CrossEntropyLoss())
    xr, yr = _rows(x, me, n), _rows(y, me, n)
    losses = [float(model.train_batch([xr], [yr])[0]) for _ in range(3)]
    return dict(losses=losses, params=_state(net))


def fit_eval_leg(w):
    """fit over a Dataset (DistributedBatchSampler, LOCAL_BS a rank), then
    evaluate and predict, as the reference worker's run_hapi_eval."""
    net = _built(lambda: mlp([IN, 16, NCLS]), w)
    model = tp.Model(tp.DataParallel(net))
    model.prepare(tp.optimizer.Adam(learning_rate=0.05,
                                    parameters=model.parameters()),
                  nn.CrossEntropyLoss(), tp.metric.Accuracy())
    ds = ClsDS()
    model.fit(ds, eval_data=ds, batch_size=LOCAL_BS, epochs=1,
              num_iters=STEPS, shuffle=False, verbose=0)
    logs = model.evaluate(ds, batch_size=LOCAL_BS, verbose=0)
    preds = model.predict(ds, batch_size=LOCAL_BS, stack_outputs=True,
                          verbose=0)
    return (float(np.sum(logs["loss"])), float(logs["acc"]),
            float(np.sum(preds[0])), tuple(preds[0].shape))


def sync_bn_leg(w, x, y, ex):
    """SyncBatchNorm at dp 4: one train forward and backward (the output
    rows, the loss and every gradient), then 2 Momentum steps through
    Model (losses, parameters, running statistics) and an eval predict of
    `ex`, gathered."""
    world = ptd.get_group()
    me, n = world.rank, world.nranks
    xr, yr = torch.from_numpy(_rows(x, me, n)), torch.from_numpy(
        _rows(y, me, n))
    net = nn.SyncBatchNorm.convert_sync_batchnorm(
        _built(lambda: bn_net(nn.BatchNorm2D), w))
    dp = tp.DataParallel(net)
    out = dp(tp.Tensor._wrap(xr))
    loss = nn.CrossEntropyLoss()(out, tp.Tensor._wrap(yr))
    loss.backward()
    rows = torch.cat(ptd.all_gather(None, out._t.detach()))
    mean = sum(ptd.all_gather(None, loss._t.detach().reshape(1))) / n
    grads = {k: _np(p._t.grad) for k, p in net.named_parameters()}
    first = dict(out=_np(rows), loss=_np(mean[0]), grads=grads)

    net = nn.SyncBatchNorm.convert_sync_batchnorm(
        _built(lambda: bn_net(nn.BatchNorm2D), w))
    model = tp.Model(tp.DataParallel(net))
    model.prepare(tp.optimizer.Momentum(learning_rate=0.1,
                                        parameters=model.parameters()),
                  nn.CrossEntropyLoss())
    losses = [float(model.train_batch([xr], [yr])[0]) for _ in range(2)]
    pred = model.predict_batch([_rows(ex, me, n)])[0]
    return dict(first=first, losses=losses, state=_state(net), pred=pred)


def plain_bn_leg(w, x, y):
    """Plain BatchNorm under DataParallel: each rank normalizes by its own
    rows (Paddle's semantics). One forward and backward: this rank's
    output rows and running statistics, and the averaged gradients."""
    world = ptd.get_group()
    me, n = world.rank, world.nranks
    net = _built(lambda: bn_net(nn.BatchNorm2D), w)
    dp = tp.DataParallel(net)
    out = dp(tp.Tensor._wrap(torch.from_numpy(_rows(x, me, n))))
    loss = nn.CrossEntropyLoss()(out, tp.Tensor._wrap(torch.from_numpy(
        _rows(y, me, n))))
    loss.backward()
    return dict(out=_np(out), state=_state(net),
                grads={k: _np(p._t.grad) for k, p in net.named_parameters()})


def unequal_leg(w, x, y, me):
    """Local batches of 4 rows, 5 on the last rank: every rank raises."""
    model = tp.Model(tp.DataParallel(_built(lambda: mlp([16, 32, 4]), w)))
    model.prepare(tp.optimizer.Momentum(learning_rate=0.05,
                                        parameters=model.parameters()),
                  nn.CrossEntropyLoss())
    rows = 5 if me == 3 else 4
    try:
        model.train_batch([x[:rows]], [y[:rows]])
    except ValueError as e:
        return str(e)
    return None


def _sharded_model(w, level, lr=0.01, amp=None):
    net = _built(lambda: mlp([16, 64, 8]), w)
    opt = tp.optimizer.Adam(learning_rate=lr, parameters=net.parameters())
    wrapped, sopt = shard.group_sharded_parallel(net, opt, level=level)
    model = tp.Model(wrapped)
    model.prepare(optimizer=opt, loss=nn.MSELoss(), amp_configs=amp)
    return model, wrapped, sopt


def sharding_leg(w, x, y, me, n):
    """GroupSharded through Model: 3 Adam steps at each level (losses,
    parameters), the stepped optimizer, stage 3's bytes a rank, stage 2
    at O1 over 8 steps."""
    xr, yr = _rows(x, me, n), _rows(y, me, n)
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        model, wrapped, sopt = _sharded_model(w, level)
        losses = [float(np.sum(model.train_batch([xr], [yr])[0]))
                  for _ in range(3)]
        full = wrapped.full_state_dict()
        out[level] = dict(
            losses=losses, params={k: _np(v) for k, v in full.items()},
            steps_sharded=model._sharded_opt is sopt,
            local_bytes=sum(p.numel() * p.element_size() for _, p in
                            torch.nn.Module.named_parameters(wrapped)),
            full_bytes=sum(v.numel() * v.element_size()
                           for v in map(lambda t: getattr(t, "_t", t),
                                        full.values())))
    model, _, _ = _sharded_model(w, "os_g", lr=0.02, amp={"level": "O1"})
    out["o1"] = [float(np.sum(model.train_batch([xr], [yr])[0]))
                 for _ in range(8)]
    return out


def facade_leg(tmp, me):
    """TestShardingFacade's train and save at every level, through
    `distributed.sharding`: one Model step, then the gathered save."""
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        tp.seed(1)
        net = mlp([8, 16, 4])
        opt = tp.optimizer.Adam(learning_rate=0.01,
                                parameters=net.parameters())
        wrapped, sopt = shard.group_sharded_parallel(net, opt, level=level)
        model = tp.Model(wrapped)
        model.prepare(optimizer=opt, loss=nn.MSELoss())
        rng = np.random.RandomState(me)
        loss = model.train_batch([rng.randn(8, 8).astype("float32")],
                                 [rng.randn(8, 4).astype("float32")])
        path = os.path.join(tmp, f"facade_{level}")
        shard.save_group_sharded_model(wrapped, path, opt)
        ptd.barrier()
        saved = torch.load(path + ".pdparams")
        out[level] = dict(
            finite=bool(np.isfinite(np.asarray(loss)).all()),
            files=[os.path.exists(path + s) for s in (".pdparams",
                                                       ".pdopt")],
            shapes={k: tuple(v.shape) for k, v in saved.items()})
    return out


def checkpoint_leg(w, tmp, me, n):
    """ModelCheckpoint(async_save=True) through stage 3 over 3 epochs; the
    trained (gathered) parameters and the epochs' directories."""
    net = _built(lambda: mlp([8, 16, 4]), w)
    opt = tp.optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
    wrapped, _ = shard.group_sharded_parallel(net, opt, level="p_g_os")
    model = tp.Model(wrapped)
    model.prepare(optimizer=opt, loss=nn.MSELoss())
    rng = np.random.RandomState(3)
    xs = rng.randn(16 * n, 8).astype("float32")
    ys = rng.randn(16 * n, 4).astype("float32")
    xr, yr = _rows(xs, me, n), _rows(ys, me, n)
    data = [(xr[i:i + 8], yr[i:i + 8]) for i in range(0, 16, 8)]
    save_dir = os.path.join(tmp, "ckpt")
    cb = ModelCheckpoint(save_freq=1, save_dir=save_dir, async_save=True)
    model.fit(data, epochs=3, verbose=0, callbacks=[cb])
    pending = bool(dck._PENDING) if hasattr(dck, "_PENDING") else False
    return dict(trained={k: _np(v) for k, v in
                         wrapped.full_state_dict().items()},
                dirs=sorted(os.listdir(save_dir)), pending=pending)


def hapi_rank(tmp, refs):
    """Every leg on this rank; returns the readings."""
    world = ptd.get_group()
    me, n = world.rank, world.nranks
    tp.set_device("cpu")
    out = dict(rank=me)
    out["dp"] = dp_model_leg(refs["dp_w"], refs["dp_x"], refs["dp_y"], me,
                             n)
    out["fit"] = fit_eval_leg(refs["cls_w"])
    out["sync_bn"] = sync_bn_leg(refs["bn_w"], refs["bn_x"], refs["bn_y"],
                                 refs["bn_ex"])
    out["plain_bn"] = plain_bn_leg(refs["bn_w"], refs["bn_x"],
                                   refs["bn_y"])
    out["unequal"] = unequal_leg(refs["dp_w"], refs["dp_x"], refs["dp_y"],
                                 me)
    out["sharding"] = sharding_leg(refs["sh_w"], refs["sh_x"], refs["sh_y"],
                                   me, n)
    out["facade"] = facade_leg(tmp, me)
    out["ckpt"] = checkpoint_leg(refs["ck_w"], tmp, me, n)
    return out
