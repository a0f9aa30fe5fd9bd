"""Rank bodies of the tests of the rest of the port's `distributed`
(collectives, DataParallel, the checkpoint, auto_parallel and its Engine),
run by `paddle_tpu_torch.distributed.spawn` over gloo on the CPU. This
module imports neither JAX nor paddle_tpu; the tests compute the JAX
references in their own process and read numpy results from here. Every
function runs on every rank of a world that `spawn` has already joined."""
import os

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.nn import torch_functional as F


def _np(t):
    return t.detach().float().cpu().numpy()


def _pairs():
    """The groups {0, 1} and {2, 3} (every rank makes both) and this
    rank's."""
    pairs = [ptd.new_group([0, 1]), ptd.new_group([2, 3])]
    return pairs[ptd.get_rank() // 2]


def api_value(rank):
    """The rank-dependent vector the collectives below carry."""
    return torch.arange(6, dtype=torch.float32) * 0.1 + rank * 1.37


def api_parts(rank, n):
    return [torch.arange(3, dtype=torch.float32) * 0.37 + rank * 1.3 + j
            for j in range(n)]


def api_rank():
    """Each new collective once on rank-dependent values (a world of 4);
    returns what this rank saw."""
    g = ptd.get_group()
    n, me = g.nranks, g.rank
    x = api_value(me)
    out = {"rank": me, "backend": ptd.get_backend()}
    t = x.clone()
    ptd.broadcast(t, src=2)
    out["broadcast"] = _np(t)
    pair = _pairs()
    t = x.clone()
    ptd.broadcast(t, src=pair.ranks[1], group=pair)     # a global rank
    out["broadcast_pair_global"] = _np(t)
    t = x.clone()
    ptd.broadcast(t, src=1, group=pair)                 # a group rank
    out["broadcast_pair_local"] = _np(t)
    t = x.clone()
    ptd.reduce(t, dst=1)
    out["reduce_sum"] = _np(t)
    t = x.clone()
    ptd.reduce(t, dst=3, op=ptd.ReduceOp.MAX)
    out["reduce_max"] = _np(t)
    r = torch.empty(3)
    ptd.reduce_scatter(r, api_parts(me, n))
    out["reduce_scatter_list"] = _np(r)
    big = torch.arange(n * 2 * 3, dtype=torch.float32).reshape(n * 2, 3) \
        * 0.11 + me * 0.7
    out["reduce_scatter"] = _np(ptd.reduce_scatter(big))
    lst = ([torch.full((2,), 10.0 * j + 0.5) for j in range(n)]
           if me == 0 else None)
    t = torch.zeros(2)
    ptd.scatter(t, lst, src=0)
    out["scatter"] = _np(t)
    ins = [torch.tensor([100.0 * me + j, -float(j)]) for j in range(n)]
    got = []
    ptd.alltoall(got, ins)
    out["alltoall"] = [_np(t) for t in got]
    objs = []
    ptd.all_gather_object(objs, {"rank": me, "sq": me * me})
    out["all_gather_object"] = objs
    lst = [{"from": me}, "x" * (me + 1), me]
    ptd.broadcast_object_list(lst, src=3)
    out["broadcast_object_list"] = lst
    mine = []
    ptd.scatter_object_list(mine, [f"obj{j}" for j in range(n)]
                            if me == 1 else None, src=1)
    out["scatter_object_list"] = mine
    try:
        ptd.scatter_object_list([], ["too short"] if me == 0 else None)
        out["scatter_short"] = None
    except ValueError as e:
        out["scatter_short"] = str(e)
    recv_t = torch.empty(6)
    reqs = [ptd.isend(x * 2, (me + 1) % n), ptd.irecv(recv_t, (me - 1) % n)]
    for req in reqs:
        ptd.wait(req)
    out["irecv"] = _np(recv_t)
    t = x.clone()
    ptd.stream.all_reduce(t)
    out["stream_all_reduce"] = _np(t)
    pe = ptd.ParallelEnv()
    out["parallel_env"] = (pe.rank, pe.world_size, pe.nranks, pe.local_rank)
    return out


# ------------------------------------------------------------ DataParallel
def reference_mlp(weights):
    """The reference test's net (Linear 16 -> 32, ReLU, Linear 32 -> 4)
    from `weights` (numpy, torch's (out, in) layout)."""
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 4))
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in weights.items()})
    return net


def _rows(x, group):
    per = x.shape[0] // group.nranks
    return x[group.rank * per:(group.rank + 1) * per]


def _mean_loss(loss, group):
    from paddle_tpu_torch.parallel.mesh import ordered_psum

    return float(ordered_psum(loss.detach().reshape(1), group)[0]
                 * (1.0 / group.nranks))


def momentum_leg(weights, x, y, group, steps=3):
    """DataParallel over `group`: the reference's Momentum(0.05) steps of
    cross entropy on the global batch (x, y), this rank's rows."""
    from paddle_tpu_torch.optimizer import Momentum

    net = reference_mlp(weights)
    dp = ptd.DataParallel(net, group=group)
    opt = Momentum(learning_rate=0.05, parameters=net.parameters())
    xs = _rows(torch.from_numpy(x), group)
    ys = _rows(torch.from_numpy(y), group).reshape(-1)
    losses = []
    for _ in range(steps):
        loss = F.cross_entropy(dp(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(_mean_loss(loss, group))
    return losses, {k: _np(v) for k, v in net.state_dict().items()}


def parity_leg(weights, x, y, group, steps=3, **dp_kw):
    """The same Adam steps of an MSE MLP through ZeroTrainStep(stage=0)
    and through DataParallel on `group`: both parameter sets and both
    loss lists."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import zero as Z

    net = reference_mlp(weights)
    opt = Adam(learning_rate=0.01, parameters=net.parameters())
    step = Z.zero_train_step(net, opt, stage=0, group=group)
    p, st = step.init_state()
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    z_losses = []
    for t in range(1, steps + 1):
        loss, p, st = step(p, st, (xb, yb), 0.01, t)
        z_losses.append(float(loss))
    net2 = reference_mlp(weights)
    dp = ptd.DataParallel(net2, group=group, **dp_kw)
    opt2 = Adam(learning_rate=0.01, parameters=net2.parameters())
    d_losses = []
    for _ in range(steps):
        loss = torch.mean((dp(_rows(xb, group)) - _rows(yb, group)) ** 2)
        loss.backward()
        opt2.step()
        opt2.clear_grad()
        d_losses.append(_mean_loss(loss, group))
    return (z_losses, {k: _np(v) for k, v in p.items()}, d_losses,
            {k: _np(v) for k, v in net2.named_parameters()})


def no_sync_leg(weights, x, y, group):
    """Two backwards under no_sync, then a synced one: the gradients
    against every rank's local sum gathered and summed in rank order,
    times 1 / n."""
    from paddle_tpu_torch.parallel.mesh import fixed_order_sum

    xb, yb = _rows(torch.from_numpy(x), group), _rows(torch.from_numpy(y),
                                                      group)
    micro = [(xb[i::3], yb[i::3]) for i in range(3)]

    def losses(model):
        return [torch.mean((model(a) - b) ** 2) for a, b in micro]

    net = reference_mlp(weights)
    dp = ptd.DataParallel(net, group=group)
    ls = losses(dp)
    with dp.no_sync():
        ls[0].backward()
        ls[1].backward()
    ls[2].backward()
    ref = reference_mlp(weights)
    for loss in losses(ref):
        loss.backward()
    want = {}
    for name, p in ref.named_parameters():
        parts = ptd.all_gather(None, p.grad, group)
        want[name] = fixed_order_sum(parts) * (1.0 / group.nranks)
    return {name: bool(torch.equal(p.grad, want[name]))
            for name, p in net.named_parameters()}


class _TwoBranches(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(3)
        self.used = torch.nn.Linear(4, 4)
        self.unused = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.used(x)


def unused_leg(group):
    """find_unused_parameters: zeros for the unused branch; without it
    the backward raises on every rank."""
    x = torch.ones(2, 4) * (group.rank + 1)
    dp = ptd.DataParallel(_TwoBranches(), group=group,
                          find_unused_parameters=True)
    dp(x).sum().backward()
    out = {"unused_grad": _np(dp._layers.unused.weight.grad),
           "used_grad": _np(dp._layers.used.weight.grad)}
    dp = ptd.DataParallel(_TwoBranches(), group=group)
    try:
        dp(x).sum().backward()
        out["refusal"] = None
    except RuntimeError as e:
        out["refusal"] = str(e)
    # the group still works after the refusal
    out["after"] = _np(ptd.all_reduce(torch.ones(1), group=group))
    return out


def fleet_leg(weights):
    """fleet.init at pure dp over the world, then distributed_model."""
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": ptd.get_world_size()}
    hcg = fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(reference_mlp(weights))
    return {"type": type(model).__name__,
            "ranks": list(model.group.ranks),
            "same_group": model.group is hcg.get_data_parallel_group(),
            "data_spec": model.data_sharding().spec,
            "param_spec": model.param_sharding().spec}


def ernie_leg(params, ids, labels, group):
    """The tiny ERNIE (fp32, dropout 0) under DataParallel on `group`:
    the global mean loss and this rank's reduced gradients; then one Adam
    step against ZeroTrainStep(stage=0), parameters compared bit for
    bit."""
    from torch.func import functional_call

    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel import zero as Z
    from paddle_tpu_torch.weights import load_reference_state

    cfg = ErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0

    def build():
        m = ErnieForPretraining(cfg, device="cpu")
        load_reference_state(m, params)
        m.train()
        return m

    ids_t, lab_t = torch.from_numpy(ids), torch.from_numpy(labels)
    model = build()
    # the NSP head and the pooler take no part in the MLM loss
    dp = ptd.DataParallel(model, group=group, find_unused_parameters=True)
    loss, _ = dp(_rows(ids_t, group), masked_lm_labels=_rows(lab_t, group))
    loss.backward()
    grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    opt = Adam(learning_rate=1e-4, parameters=model.parameters())
    opt.step()
    ref = build()

    def loss_fn(p, a, b):
        return functional_call(ref, p, (a,), {"masked_lm_labels": b})[0]

    step = Z.zero_train_step(ref, Adam(learning_rate=1e-4,
                                       parameters=ref.parameters()),
                             loss_fn, stage=0, group=group)
    p, st = step.init_state()
    z_loss, p, st = step(p, st, (ids_t, lab_t), 1e-4, 1)
    differ = [n for n, q in model.named_parameters()
              if not torch.equal(q.detach(), p[n])]
    return {"loss": _mean_loss(loss, group), "zero_loss": float(z_loss),
            "grads": grads, "differ": differ}


def dp_rank(weights, x, y, xr, yr, ernie_params, ids, labels):
    """Every DataParallel leg in a world of 4: dp 4 on the world, dp 2 on
    {0, 1} / {2, 3}."""
    g = ptd.get_group()
    pair = _pairs()
    out = {"momentum": momentum_leg(weights, x, y, pair),
           "parity4": parity_leg(weights, xr, yr, g),
           "parity2": parity_leg(weights, xr, yr, pair),
           "parity4_small_buckets": parity_leg(
               weights, xr, yr, g, comm_buffer_size=0.001,
               last_comm_buffer_size=0.0005),
           "no_sync": no_sync_leg(weights, xr, yr, g),
           "unused": unused_leg(g),
           "ernie": ernie_leg(ernie_params, ids, labels, pair),
           "fleet": fleet_leg(weights)}
    return out


# -------------------------------------------------------------- checkpoint
def ckpt_rank(tmp, world1_dir, jax_dir, w, b):
    """The checkpoint legs of a world of 2 (mesh [0, 1]): save a Shard(0)
    tensor, a replicated one, an int64 tensor, a bf16 one and a scalar;
    load the world-1 and the JAX checkpoints into this rank's placements;
    two async saves back to back."""
    from paddle_tpu_torch.distributed import checkpoint as ck

    me = ptd.get_rank()
    mesh = ptd.ProcessMesh([0, 1], ["x"])
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    sd = {"w": ptd.shard_tensor(wt, mesh, [ptd.Shard(0)]),
          "b": bt.clone(),
          "count": torch.arange(5, dtype=torch.int64) * 3,
          "half": (wt * 0.5).to(torch.bfloat16),
          "step": 7}
    # an mp layer's split parameter: its placement from the parameter
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl

    torch.manual_seed(5)        # every rank draws the same whole weight
    col = mpl.ColumnParallelLinear(4, 8, gather_output=False,
                                   mp_group=ptd.get_group(), device="cpu")
    sd["col"] = col.state_dict(keep_vars=True)
    ck.save_state_dict(sd, os.path.join(tmp, "world2"))
    out = {"block": _np(sd["w"]), "col_part": _np(col.weight)}
    with torch.no_grad():
        col.weight.zero_()
    ck.load_state_dict({"col": col.state_dict(keep_vars=True)},
                       os.path.join(tmp, "world2"))
    out["col_reloaded"] = _np(col.weight)
    for tag, path in (("world1", world1_dir), ("jax", jax_dir)):
        tgt = {"w": ptd.shard_tensor(torch.zeros_like(wt), mesh,
                                     [ptd.Shard(1)]),
               "b": torch.zeros_like(bt), "step": 0}
        ck.load_state_dict(tgt, path)
        out[tag] = {"w": _np(tgt["w"]), "b": _np(tgt["b"]),
                    "step": tgt["step"]}
    ck.save_state_dict({"w": sd["w"]}, os.path.join(tmp, "a"),
                       async_save=True)
    sd2 = {"w": ptd.shard_tensor(wt * 2, mesh, [ptd.Shard(0)])}
    ck.save_state_dict(sd2, os.path.join(tmp, "b"), async_save=True)
    ck.wait_save()
    out["pending_after_wait"] = len(ck._PENDING)
    got = {"w": torch.zeros_like(wt)}
    ck.load_state_dict(got, os.path.join(tmp, "b"))
    out["async_b"] = _np(got["w"])
    out["mp_adam"] = mp_adam_leg(tmp)
    out["gpt"] = gpt_qkv_leg(tmp)
    out["rank"] = me
    return out


def _bound_gpt(seed):
    """A tiny tensor-parallel GPT built whole from `seed`, then bound to
    the world as its mp group (its fused QKV cut by head)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import bind_mp_group
    from paddle_tpu_torch.models import GPTConfig, GPTModel

    model = GPTModel(GPTConfig.tiny(), tensor_parallel=True, device="cpu",
                     seed=seed)
    bind_mp_group(model, ptd.get_group())
    return model


def gpt_qkv_leg(tmp):
    """GPT's interleaved QKV across degrees: a bound model of seed 3
    saved at mp 2 (tmp/gpt_mp2); the dense world-1 checkpoint of seed 7
    (tmp/gpt_world1) loaded into a bound model of seed 5 must give the
    bound model of seed 7, parameter for parameter."""
    from paddle_tpu_torch.distributed import checkpoint as ck

    ck.save_state_dict({"gpt": _bound_gpt(3).state_dict(keep_vars=True)},
                       os.path.join(tmp, "gpt_mp2"))
    got = _bound_gpt(5)
    ck.load_state_dict({"gpt": got.state_dict(keep_vars=True)},
                       os.path.join(tmp, "gpt_world1"))
    want = dict(_bound_gpt(7).named_parameters())
    return {"differ": [n for n, p in got.named_parameters()
                       if not torch.equal(p, want[n])],
            "qkv_rows": int(want["blocks.0.attn.qkv.weight"].shape[0])}


def mp_adam_leg(tmp):
    """Fleet's column and row layers at mp 2 with their Adam state after
    one step: saved, then loaded into a fresh model and optimizer at mp 2;
    the same model's `state_dict()` without `keep_vars` (its split
    parameters stripped of their placement) refused."""
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.optimizer import Adam

    g = ptd.get_group()

    def build(seed):
        torch.manual_seed(seed)     # every rank draws the same whole
        return torch.nn.Sequential(
            mpl.ColumnParallelLinear(4, 8, gather_output=False, mp_group=g,
                                     device="cpu"),
            mpl.RowParallelLinear(8, 4, input_is_parallel=True, mp_group=g,
                                  device="cpu"))

    def flat(sd):
        return {k: v for k, v in ck._flatten(sd).items()
                if isinstance(v[0][v[1]], torch.Tensor)}

    net = build(11)
    opt = Adam(learning_rate=0.01, parameters=net.parameters())
    net(torch.linspace(-1, 1, 12).reshape(3, 4)).square().sum().backward()
    opt.step()
    out = {}
    try:
        ck.save_state_dict({"model": net.state_dict()},
                           os.path.join(tmp, "mp2_stripped"))
    except ValueError as e:
        out["refused"] = str(e)
    path = os.path.join(tmp, "mp2_adam")
    sd = {"model": net.state_dict(keep_vars=True), "opt": opt.state_dict()}
    ck.save_state_dict(sd, path)
    out["saved"], out["axis"] = {}, {}
    for k, (holder, key) in flat(sd).items():
        v = holder[key]
        out["saved"][k] = _np(v)
        out["axis"][k] = (v.split_axis if getattr(v, "is_distributed", False)
                          is True else None)
    fresh = build(12)
    opt2 = Adam(learning_rate=0.01, parameters=fresh.parameters())
    opt2.step()             # its slots, made by a step over zero gradients
    tgt = {"model": fresh.state_dict(keep_vars=True),
           "opt": opt2.state_dict()}
    ck.load_state_dict(tgt, path)
    opt2.set_state_dict(tgt["opt"])
    again = {"model": fresh.state_dict(keep_vars=True),
             "opt": opt2.state_dict()}
    out["loaded"] = {k: _np(holder[key])
                     for k, (holder, key) in flat(again).items()}
    return out


# ----------------------------------------------------------- auto_parallel
RESHARDS = (
    ("S0 S1 -> R R", ((0,), (1,)), (None, None)),
    ("S0 S1 -> S1 S0", ((0,), (1,)), ((1,), (0,))),
    ("S0 R -> S1 R", ((0,), None), ((1,), None)),
    ("R R -> S0 S0", (None, None), ((0,), (0,))),
    ("S0 S0 -> R S0", ((0,), (0,)), (None, (0,))),
    ("P R -> R R", ("P", None), (None, None)),
    ("R S1 -> P S1", (None, (1,)), ("P", (1,))),
)


def _placements(spec):
    return [ptd.Replicate() if s is None else ptd.Partial() if s == "P"
            else ptd.Shard(s[0]) for s in spec]


def tp_mlp(weights):
    """The reference Engine test's net, built whole: ColumnParallelLinear
    (8, 32, gather_output=False), ReLU, RowParallelLinear(32, 4,
    input_is_parallel=True), from the JAX weights."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    from paddle_tpu_torch.weights import load_reference_state

    net = torch.nn.Sequential(
        mpl.ColumnParallelLinear(8, 32, gather_output=False, device="cpu"),
        torch.nn.ReLU(),
        mpl.RowParallelLinear(32, 4, input_is_parallel=True, device="cpu"))
    load_reference_state(net, weights)
    return net


def _ce(out, y):
    return F.cross_entropy(out, y.reshape(-1))


def _dense_full(net):
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import mp_full_parameters

    return {k: _np(v) for k, v in mp_full_parameters(net).items()}


def auto_rank(t, tp_weights, x, y, mlp_weights, xs, ys):
    """shard_tensor / reshard on a (2, 2) mesh; the Engine on a dp x mp
    mesh against eager dense steps; the sharding mesh against the dp
    mesh."""
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.optimizer import SGD, Adam

    me = ptd.get_rank()
    # one mesh for the placements and the dp x mp Engine (every mesh
    # makes a process group a row and a column)
    mesh = ptd.ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"])
    tt = torch.from_numpy(t)
    out = {"rank": me, "reshard": {}}
    for name, src, dst in RESHARDS:
        st = ptd.shard_tensor(tt, mesh, _placements(src))
        rt = ptd.reshard(st, mesh, _placements(dst))
        out["reshard"][name] = (_np(st), _np(rt))
    # the Engine over dp 2 x mp 2: 2 SGD steps of 16 rows
    net = tp_mlp(tp_weights)
    ds = TensorDataset([torch.from_numpy(x), torch.from_numpy(y)])
    eng = ptd.Engine(net, loss=_ce, optimizer=SGD(
        learning_rate=0.1, parameters=net.parameters()),
        metrics=Accuracy(), mesh=mesh)
    out["shardings"] = eng.param_shardings()
    hist = eng.fit(ds, epochs=2, batch_size=16)
    out["engine_losses"] = list(hist["loss"])
    out["engine_params"] = _dense_full(net)
    out["local_shapes"] = {k: tuple(v.shape)
                           for k, v in net.named_parameters()}
    out["evaluate"] = eng.evaluate(ds, batch_size=16)
    out["predict"] = [p.shape for p in eng.predict(ds, batch_size=16)]
    dense = tp_mlp(tp_weights)
    opt = SGD(learning_rate=0.1, parameters=dense.parameters())
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(2):
        _ce(dense(xt), yt).backward()
        opt.step()
        opt.clear_grad()
    out["eager_params"] = _dense_full(dense)
    # ZeRO-1 over the `sharding` dim against the dp mesh
    for axes in (("sharding", "mp"), ("dp", "mp")):
        m = (mesh if axes[0] == "dp"
             else ptd.ProcessMesh([[0, 1], [2, 3]], list(axes)))
        net = reference_mlp_8(mlp_weights)
        eng = ptd.Engine(net, loss=lambda o, t: torch.mean((o - t) ** 2),
                         optimizer=Adam(learning_rate=0.01,
                                        parameters=net.parameters()),
                         mesh=m)
        hist = eng.fit(TensorDataset([torch.from_numpy(xs),
                                      torch.from_numpy(ys)]),
                       epochs=1, batch_size=16)
        out[axes[0]] = {"losses": list(hist["loss"]),
                        "opt_bytes": eng.optimizer_state_bytes()}
    return out


def reference_mlp_8(weights):
    """The reference ZeRO-Engine test's net: Linear 16 -> 32, ReLU,
    Linear 32 -> 8."""
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 8))
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in weights.items()})
    return net
