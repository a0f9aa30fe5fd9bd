"""Rank bodies of the port's fleet, pipeline and GroupSharded tests, run
by `paddle_tpu_torch.distributed.spawn` over gloo on the CPU in a world of
four ranks. This module imports neither JAX nor paddle_tpu; the tests
compute the JAX references in their own process, hand their weights and
inputs in as numpy, and read numpy results back."""
import os
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
from paddle_tpu_torch.distributed.fleet.meta_parallel.spmd_pipeline import (
    make_spmd_pipeline_fn)
from paddle_tpu_torch.models import gpt as G
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, Adam
from paddle_tpu_torch.parallel import mesh as M
from paddle_tpu_torch.parallel import zero as Z
from paddle_tpu_torch.weights import load_reference_state

LR = 0.01


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return {k: _np(v) for k, v in tree.items()}


def _init(**degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return s, fleet.init(is_collective=True, strategy=s)


def gpt_cfg():
    cfg = G.GPTConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


# ------------------------------------------------------------ fleet world
class TPMLP(torch.nn.Module):
    """The reference tests' Megatron MLP: column (no gather) -> ReLU ->
    row (input parallel)."""

    def __init__(self, i=16, h=32, o=8):
        super().__init__()
        self.fc1 = mpl.ColumnParallelLinear(i, h, gather_output=False,
                                            device="cpu")
        self.fc2 = mpl.RowParallelLinear(h, o, input_is_parallel=True,
                                         device="cpu")

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _mp_layer_legs(data):
    out = {}
    # the TP MLP: output, input gradient and full parameter gradients
    net = TPMLP()
    load_reference_state(net, data["mlp"])
    x = torch.from_numpy(data["mlp_x"]).requires_grad_(True)
    y = net(x)
    (y * torch.from_numpy(data["mlp_gy"])).sum().backward()
    out["mlp"] = dict(y=_np(y), gx=_np(x.grad),
                      grads=_np(mpl.mp_full_parameters(net, grads=True)))
    # gather_output / split input forms
    col = mpl.ColumnParallelLinear(16, 32, gather_output=True, device="cpu")
    row = mpl.RowParallelLinear(32, 8, input_is_parallel=False, device="cpu")
    load_reference_state(col, {"weight": data["mlp"]["fc1.weight"],
                               "bias": data["mlp"]["fc1.bias"]})
    load_reference_state(row, {"weight": data["mlp"]["fc2.weight"],
                               "bias": data["mlp"]["fc2.bias"]})
    out["gathered_forms"] = _np(row(torch.relu(col(
        torch.from_numpy(data["mlp_x"])))))
    # vocab-parallel embedding: a repeated id and ids of the other rank
    emb = mpl.VocabParallelEmbedding(64, 8, device="cpu")
    load_reference_state(emb, {"weight": data["emb_w"]})
    ids = torch.from_numpy(data["emb_ids"])
    e = emb(ids)
    (e * torch.from_numpy(data["emb_gy"])).sum().backward()
    out["emb"] = dict(y=_np(e), grad=_np(mpl.mp_full_parameters(
        emb, grads=True)["weight"]), rows=int(emb.weight.shape[0]),
        start=emb.vocab_start)
    # vocab-parallel cross entropy
    logits = torch.from_numpy(data["ce_logits"])
    n = emb.mp_size
    v = logits.shape[-1] // n
    part = logits[:, emb.mp_rank * v:(emb.mp_rank + 1) * v].clone()
    part.requires_grad_(True)
    ce = mpl.ParallelCrossEntropy()
    loss = ce(part, torch.from_numpy(data["ce_labels"]))
    loss.sum().backward()
    gl = torch.cat(ptd.all_gather(None, part.grad, emb.group), dim=-1)
    out["ce"] = dict(loss=_np(loss), grad=_np(gl))
    # sequence parallelism: seq split over mp, the linears, gathered back
    col_sp = mpl.ColumnSequenceParallelLinear(8, 16, device="cpu")
    row_sp = mpl.RowSequenceParallelLinear(16, 8, device="cpu")
    load_reference_state(col_sp, data["sp"]["col"])
    load_reference_state(row_sp, data["sp"]["row"])
    sp = torch.nn.ModuleDict({"col": col_sp, "row": row_sp})
    mpl.register_sequence_parallel_allreduce_hooks(sp)
    xs = torch.from_numpy(data["sp_x"]).requires_grad_(True)
    ys = mpl.GatherOp.apply(row_sp(col_sp(mpl.ScatterOp.apply(xs, 1))), 1)
    (ys ** 2).sum().backward()
    out["sp"] = dict(y=_np(ys), gx=_np(xs.grad),
                     grads=_np(mpl.mp_full_parameters(sp, grads=True)))
    return out


def _clip_legs(data):
    out = {}
    net = TPMLP()
    load_reference_state(net, data["clip_mlp"])
    inner = SGD(learning_rate=0.1, parameters=net.parameters(),
                grad_clip=ClipGradByGlobalNorm(0.05))
    opt = fleet.distributed_optimizer(inner)
    x = torch.from_numpy(data["clip_x"])
    y = torch.from_numpy(data["clip_y"])
    for _ in range(3):
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    out["clip"] = dict(params=_np(mpl.mp_full_parameters(net)),
                       kind=type(inner._grad_clip).__name__)
    # the clip's global norm: mp-split ones and a replicated 2.0
    clip = mpl.HybridParallelClipGrad(ClipGradByGlobalNorm(1.0),
                                      fleet.get_hybrid_communicate_group())

    class Dist:
        need_clip, is_distributed = True, True

    class Repl:
        need_clip, is_distributed = True, False

    got = clip([(Dist(), torch.ones(2)), (Repl(), torch.full((1,), 2.0))])
    out["clip_psum"] = [_np(g) for _, g in got]
    return out


def _gpt_tp_legs(data):
    out = {}
    cfg = gpt_cfg()
    m = G.GPTModel(cfg, tensor_parallel=True, device="cpu")
    load_reference_state(m, data["gpt"])
    ids = torch.from_numpy(data["gpt_ids"])
    m.eval()
    h = m(ids)
    (h * torch.from_numpy(data["gpt_gy"])).sum().backward()
    out["gpt"] = dict(h=_np(h), heads=m.blocks[0].attn.num_heads,
                      grads=_np(mpl.mp_full_parameters(m, grads=True)))
    # seeded: the tp model holds the slices of the dense one
    dense = G.GPTModel(cfg, device="cpu", seed=5)
    tp = G.GPTModel(cfg, tensor_parallel=True, device="cpu", seed=5)
    full = mpl.mp_full_parameters(tp)
    dd = dict(dense.named_parameters())
    out["gpt_seeded_slices"] = all(torch.equal(full[k], dd[k]) for k in dd)
    # dropout on: attention from the model-parallel stream, hidden from
    # the global one; the replicated output agrees on the mp ranks
    cfg_d = G.GPTConfig.tiny()
    md = G.GPTModel(cfg_d, tensor_parallel=True, device="cpu", seed=5)
    md.train()
    mpl.model_parallel_random_seed(11, device="cpu")
    hd = md(ids)
    both = ptd.all_gather(None, hd.detach(), md.wte.group)
    out["gpt_dropout"] = dict(finite=bool(torch.isfinite(hd).all()),
                              same_on_mp=bool(torch.equal(both[0], both[1])))
    return out


def tp_loss_fn(params, x, y):
    """The reference's Megatron MLP loss over tp parts (port layout)."""
    h = torch.relu(M.copy_to_tp_region(x) @ params["w1"].T)
    out = M.reduce_from_tp_region(h @ params["w2"].T)
    return torch.mean((out - y) ** 2)


def _zero_tp_legs(data):
    """ZeroTrainStep at dp 2 x tp 2 over the world (carved dp-major)."""
    out = {}
    specs = {"w1": ("tp", None), "w2": (None, "tp")}
    full = {k: torch.from_numpy(v) for k, v in data["tp_full"].items()}
    x, y = torch.from_numpy(data["tp_x"]), torch.from_numpy(data["tp_y"])
    for name, stage, kw in (("stage0", 0, {}), ("stage1", 1, {}),
                            ("stage2", 2, {}),
                            ("stage2 overlap", 2, dict(overlap=True,
                                                       bucket_bytes=512))):
        opt = Adam(learning_rate=0.01,
                   parameters=torch.nn.Linear(2, 2).parameters())
        step = Z.ZeroTrainStep(None, opt, tp_loss_fn, stage=stage, dp=2,
                               tp=2, param_specs=specs, **kw)
        p, st = step.init_state(full)
        losses = []
        for t in range(1, 4):
            loss, p, st = step(p, st, (x, y), 0.01, t)
            losses.append(float(loss))
        out[name] = dict(losses=losses, params=_np(step.full_params(p)),
                         local=tuple(p["w1"].shape),
                         opt_bytes=step.optimizer_state_bytes_per_chip(st),
                         saved=_np(step.save_optimizer_state(st)))
    return out


def fleet_rank(data):
    """Every leg of tests/test_torch_fleet.py on this rank."""
    world = ptd.get_group()
    out = {"rank": world.rank}
    strategy, hcg = _init(dp=2, mp=2)
    out["hcg"] = dict(
        mode=hcg.get_parallel_mode(),
        dp=(hcg.get_data_parallel_rank(),
            hcg.get_data_parallel_group().ranks),
        mp=(hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_group().ranks),
        pp=hcg.get_pipe_parallel_group().ranks,
        axis=hcg.get_model_parallel_group().axis_name,
        same=fleet.get_hybrid_communicate_group() is hcg,
        strategy=fleet.get_strategy() is strategy)
    out.update(_mp_layer_legs(data))
    out.update(_clip_legs(data))
    out.update(_gpt_tp_legs(data))
    out.update(_zero_tp_legs(data))
    # pure data parallelism asks for DataParallel (item 5b)
    _init(dp=4)
    try:
        fleet.distributed_model(torch.nn.Linear(2, 2))
        out["dp_refusal"] = None
    except NotImplementedError as e:
        out["dp_refusal"] = str(e)
    return out


# --------------------------------------------------------- pipeline world
def _pipe_run(cfg, weights, ids, steps, accumulate, vpp=1, tp=False,
              seed=0, opt_cls=Adam):
    """`steps` train_batch calls of GPT's pipe layers (fp32) on the
    current topology; returns (losses, full params of this stage, the
    engine)."""
    strategy = fleet.get_strategy()
    strategy.pipeline_configs = {"accumulate_steps": accumulate}
    pipe = mpl.PipelineLayer(
        G.gpt_pipe_layers(cfg, tensor_parallel=tp, device="cpu", seed=seed),
        loss_fn=G.GPTPretrainingCriterion(),
        num_virtual_pipeline_stages=vpp)
    if weights is not None:
        load_reference_state(pipe, weights)
    engine = fleet.distributed_model(pipe)
    opt = NormProbe(fleet.distributed_optimizer(opt_cls(
        learning_rate=LR, parameters=pipe.parameters())))
    ids_t = torch.from_numpy(ids)
    losses = [float(engine.train_batch((ids_t, ids_t), opt))
              for _ in range(steps)]
    engine.norms = opt.norms
    return losses, mpl.mp_full_parameters(pipe), engine


class NormProbe:
    """An optimizer that reads the hybrid global norm of the reduced
    gradients (HybridParallelClipGrad over the fleet topology) before
    each step."""

    def __init__(self, opt):
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            hybrid_parallel_optimizer as hpo)

        self.opt, self.hpo, self.norms = opt, hpo, []
        self.clip = mpl.HybridParallelClipGrad(
            ClipGradByGlobalNorm(1.0), fleet.get_hybrid_communicate_group())

    def step(self):
        ps = [p for p in self.opt._parameter_list if p.grad is not None]
        self.norms.append(float(self.clip.hybrid_global_norm(
            [p.grad for p in ps], [self.hpo.is_mp_split(p) for p in ps])))
        self.opt.step()

    def clear_grad(self):
        self.opt.clear_grad()


def dense_accumulated(cfg, weights, ids, steps, accumulate, data_ranks,
                      opt_cls=Adam):
    """The single-rank step the pipeline is held to, in its order: each
    data rank's rows cut into micro-batches, each micro-batch's gradient
    added in order, the data ranks' sums added in rank order, one multiply
    by 1 / (M x data ranks), Adam."""
    pipe = mpl.PipelineLayer(G.gpt_pipe_layers(cfg, device="cpu"),
                             num_stages=1,
                             loss_fn=G.GPTPretrainingCriterion())
    load_reference_state(pipe, weights)
    opt = opt_cls(learning_rate=LR, parameters=pipe.parameters())
    ids_t = torch.from_numpy(ids)
    crit = G.GPTPretrainingCriterion()
    losses, norms = [], []
    for _ in range(steps):
        sums, step_losses = [], []
        for rows in torch.split(ids_t, ids_t.shape[0] // data_ranks):
            for micro in torch.split(rows, rows.shape[0] // accumulate):
                loss = crit(pipe(micro), micro)
                loss.backward()
                step_losses.append(loss.detach())
            sums.append({n: p.grad.clone() for n, p in
                         pipe.named_parameters()})
            pipe.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, p in pipe.named_parameters():
                g = sums[0][n]
                for s in sums[1:]:
                    g = g + s[n]
                p.grad = g * (1.0 / (accumulate * data_ranks))
            norms.append(float(torch.sqrt(sum(
                torch.sum(p.grad ** 2) for p in pipe.parameters()))))
        opt.step()
        opt.clear_grad()
        per = [sum(step_losses[d * accumulate:(d + 1) * accumulate])
               / accumulate for d in range(data_ranks)]
        total = per[0]
        for v in per[1:]:
            total = total + v
        losses.append(float(total * (1.0 / data_ranks)
                            if data_ranks > 1 else total))
    pipe.norms = norms
    return losses, {n: p.detach() for n, p in pipe.named_parameters()}, norms


def _stage_keys(full, ref):
    return {k: bool(torch.equal(v, ref[k])) for k, v in full.items()}


def _stage_close(full, ref):
    return {k: float((v - ref[k]).abs().max()) for k, v in full.items()}


def pipeline_rank(data):
    """Every multi-rank leg of tests/test_torch_pipeline.py."""
    world = ptd.get_group()
    out = {"rank": world.rank}
    cfg = gpt_cfg()
    w, ids = data["gpt"], data["ids"]
    ref_losses, ref, _ = dense_accumulated(cfg, w, ids, 2, 2, 2)
    # pp 2 x dp 2, fp32: bit for bit the single-rank accumulated step
    _init(pp=2, dp=2)
    losses, full, engine = _pipe_run(cfg, w, ids, 2, 2)
    out["pp2dp2"] = dict(losses=losses, ref_losses=ref_losses,
                         equal=_stage_keys(full, ref),
                         stage=engine._layers._stage_id,
                         keys=sorted(full))
    # eval_batch: the loss of the trained model on every stage
    out["eval"] = float(engine.eval_batch((torch.from_numpy(ids),) * 2))
    # interleaved: 2 stages x 2 chunks, the same bits
    _init(pp=2, dp=2)
    vlosses, vfull, vengine = _pipe_run(cfg, w, ids, 2, 2, vpp=2)
    out["vpp"] = dict(losses=vlosses, equal=_stage_keys(vfull, ref),
                      chunks=vengine._layers.local_chunks())
    # pp 2 x mp 2, the tensor-parallel pipe layers: within fp32 rounding
    # (one SGD step: Adam's first step would scale each gradient to about
    # lr * sign(g) and magnify the rounding where g is near 0)
    ref1_losses, ref1, ref1_norms = dense_accumulated(cfg, w, ids, 1, 2, 1,
                                                      SGD)
    _init(pp=2, mp=2)
    tlosses, tfull, tengine = _pipe_run(cfg, w, ids, 1, 2, tp=True,
                                        opt_cls=SGD)
    out["pp2mp2"] = dict(losses=tlosses, ref_losses=ref1_losses,
                         norms=tengine.norms, ref_norms=ref1_norms,
                         err=_stage_close(tfull, ref1),
                         seeded=_seeded_tp_pipe(cfg))
    out["shared"] = _shared_leg()
    out.update(_spmd_legs(data))
    return out


def _shared_descs():
    shared = mpl.SharedLayerDesc("w", torch.nn.Linear, None, "weight", 8, 8)
    return [shared, mpl.LayerDesc(torch.nn.Tanh),
            mpl.LayerDesc(torch.nn.Linear, 8, 8), shared,
            mpl.LayerDesc(torch.nn.Linear, 8, 4)]


@torch.no_grad()
def _seeded(pipe):
    """Each built layer's weights from a generator of its first position
    (a shared layer's positions draw the same)."""
    first = {}
    for i, d in enumerate(pipe._descs):
        key = getattr(d, "layer_name", i)
        first.setdefault(key, i)
        layer = pipe._all_layers[i]
        if layer is not None:
            g = torch.Generator().manual_seed(100 + first[key])
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)


def _shared_leg():
    """A layer shared by stage 0 and stage 1 (pp 2 x dp 2, SGD): its
    gradient summed over the two stages, the same step as the model held
    whole in one process, within fp32 rounding."""
    world = ptd.get_group()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, 8, generator=g)
    y = torch.randint(0, 4, (8,), generator=g)
    strategy, _ = _init(pp=2, dp=2)
    strategy.pipeline_configs = {"accumulate_steps": 2}
    pipe = mpl.PipelineLayer(_shared_descs(), loss_fn=_ce)
    _seeded(pipe)
    engine = fleet.distributed_model(pipe)
    opt = SGD(learning_rate=0.1, parameters=pipe.parameters())
    engine.train_batch((x, y), opt)
    whole = mpl.PipelineLayer(_shared_descs(), num_stages=1)
    _seeded(whole)
    sums = []
    for rows, labels in zip(torch.split(x, 4), torch.split(y, 4)):
        for xm, ym in zip(torch.split(rows, 2), torch.split(labels, 2)):
            _ce(whole(xm), ym).backward()
        sums.append({n: p.grad.clone() for n, p in whole.named_parameters()})
        whole.zero_grad(set_to_none=True)
    with torch.no_grad():
        for n, p in whole.named_parameters():
            p -= 0.1 * (sums[0][n] + sums[1][n]) * (1.0 / 4)
    ref = dict(whole.named_parameters())
    mine = {n: p for n, p in pipe.named_parameters()}
    if "3.weight" in mine:      # stage 1 names the shared layer by its index
        mine["0.weight"], mine["0.bias"] = mine.pop("3.weight"), \
            mine.pop("3.bias")
    return dict(stage=pipe._stage_id, rank=world.rank,
                err=max(float((v - ref[n]).abs().max())
                        for n, v in mine.items()))


def _seeded_tp_pipe(cfg):
    """gpt_pipe_layers built from one seed at mp 2 hold the slices of the
    dense list built from it."""
    tp = mpl.PipelineLayer(G.gpt_pipe_layers(cfg, True, device="cpu",
                                             seed=9),
                           loss_fn=G.GPTPretrainingCriterion())
    dense = mpl.PipelineLayer(G.gpt_pipe_layers(cfg, device="cpu", seed=9),
                              num_stages=1)
    dd = dict(dense.named_parameters())
    return all(torch.equal(v, dd[k])
               for k, v in mpl.mp_full_parameters(tp).items())


def _spmd_legs(data):
    out = {}
    world = ptd.get_group()
    # a homogeneous tanh MLP over 4 stages against the sequential model
    params = {k: torch.from_numpy(v) for k, v in data["spmd"].items()}

    def stage_fn(p, x):
        return x + torch.tanh(x @ p["w1"]) @ p["w2"]

    mine = {k: v[world.rank].clone().requires_grad_(True)
            for k, v in params.items()}
    pipe = make_spmd_pipeline_fn(
        stage_fn, world, num_stages=4, num_micro=4)
    x = torch.from_numpy(data["spmd_x"]).requires_grad_(True)
    y = torch.from_numpy(data["spmd_y"])
    loss = torch.mean((pipe(mine, x) - y) ** 2)
    loss.backward()
    out["spmd"] = dict(loss=float(loss), gx=_np(x.grad),
                       grads=_np({k: v.grad for k, v in mine.items()}))
    # GPT's blocks over pp 2 x dp 2
    _, hcg = _init(pp=2, dp=2)
    cfg = gpt_cfg()
    model = G.GPTModel(cfg, device="cpu")
    load_reference_state(model, data["gpt_model"])
    fn, stage_params, emb = G.gpt_spmd_pipeline_fn(
        model, num_stages=2, num_micro=2,
        data_group=hcg.get_data_parallel_group())
    gids = torch.from_numpy(data["spmd_ids"])
    logits = fn(stage_params, emb, gids)
    (logits.float() ** 2).mean().mul(1e-3).backward()
    leaves = list(stage_params.values()) + list(emb.values())
    out["gpt_spmd"] = dict(
        logits=_np(logits),
        finite=all(bool(torch.isfinite(p.grad).all()) for p in leaves),
        live=any(float(p.grad.abs().max()) > 0 for p in leaves))
    return out


# ------------------------------------------------------- sharding world
def mlp4():
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 8), torch.nn.ReLU(),
                               torch.nn.Linear(8, 4))


def _ce(out, y):
    return torch.nn.functional.cross_entropy(out, y.reshape(-1))


def _stage_run(weights, x, y, level, steps=3, offload=False):
    """`steps` eager steps through group_sharded_parallel on this rank's
    rows; (mean losses over the ranks, full params, wrapper, optimizer)."""
    world = ptd.get_group()
    net = mlp4()
    load_reference_state(net, weights)
    wrapped, opt = Z.group_sharded_parallel(
        net, Adam(learning_rate=LR, parameters=net.parameters()),
        level=level, offload=offload)
    per = x.shape[0] // world.nranks
    xs = torch.from_numpy(x[world.rank * per:(world.rank + 1) * per])
    ys = torch.from_numpy(y[world.rank * per:(world.rank + 1) * per])
    losses = []
    for _ in range(steps):
        loss = _ce(wrapped(xs), ys)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(M.ordered_psum(loss.detach().reshape(1), world)[0]
                            * (1.0 / world.nranks)))
    names = [n for n, _ in net.named_parameters()]
    full = dict(zip(names, wrapped.get_all_parameters()))
    return losses, full, wrapped, opt


def _zero0(weights, x, y, steps=3, stage=0):
    world = ptd.get_group()
    net = mlp4()
    load_reference_state(net, weights)
    opt = Adam(learning_rate=LR, parameters=net.parameters())
    step = Z.zero_train_step(net, opt, lambda p, a, b: _ce(
        torch.func.functional_call(net, p, (a,)), b), stage=stage,
        group=world)
    p, st = step.init_state()
    losses = []
    for t in range(1, steps + 1):
        loss, p, st = step(p, st, (torch.from_numpy(x), torch.from_numpy(y)),
                           LR, t)
        losses.append(float(loss))
    return losses, p, step, st


def sharding_rank(data):
    """Every multi-rank leg of tests/test_torch_group_sharded.py."""
    world = ptd.get_group()
    w, x, y = data["mlp"], data["x"], data["y"]
    out = {"rank": world.rank}
    z_losses, z_params, z_step, z_st = _zero0(w, x, y)
    out["zero0"] = dict(losses=z_losses, params=_np(z_params),
                        opt_bytes=z_step.optimizer_state_bytes_per_chip(z_st),
                        param_bytes=z_step.bytes_per_chip(z_params))
    for level in ("os", "os_g", "p_g_os"):
        losses, full, wrapped, opt = _stage_run(w, x, y, level)
        rec = dict(losses=losses, stage=wrapped.stage,
                   equal=all(torch.equal(full[k], z_params[k])
                             for k in z_params),
                   opt_bytes=opt.state_bytes(),
                   param_bytes=sum(p.numel() * p.element_size()
                                   for p in wrapped.parameters()),
                   shapes={n: tuple(p.shape)
                           for n, p in wrapped.named_parameters()},
                   slot_shapes=sorted({tuple(v.shape) for acc in
                                       opt._state.values()
                                       for v in acc.values()}))
        out[level] = rec
    # offload: the same bits, the slots in host memory
    losses, full, _, opt = _stage_run(w, x, y, "p_g_os", offload=True)
    out["offload"] = dict(
        equal=all(torch.equal(full[k], z_params[k]) for k in z_params),
        devices=sorted({str(v.device) for acc in opt._state.values()
                        for v in acc.values()}))
    # save_group_sharded_model: rank 0 writes the gathered parameters
    with tempfile.TemporaryDirectory() as tmp:
        _, _, wrapped, opt = _stage_run(w, x, y, "p_g_os", steps=1)
        path = os.path.join(tmp, "m")
        Z.save_group_sharded_model(wrapped, path, opt)
        ptd.barrier()
        if world.rank == 0:
            saved = torch.load(path + ".pdparams")
            out["saved"] = dict(keys=sorted(saved),
                                shapes={k: tuple(v.shape)
                                        for k, v in saved.items()},
                                opt=os.path.exists(path + ".pdopt"))
        ptd.barrier()
    # the bridge: group_sharded_parallel('os').zero_train_step() is the
    # native engine at the sharding degree
    net = mlp4()
    load_reference_state(net, w)
    wrapped, _ = Z.group_sharded_parallel(
        net, Adam(learning_rate=LR, parameters=net.parameters()), level="os")
    step = wrapped.zero_train_step(lambda p, a, b: _ce(
        torch.func.functional_call(net, p, (a,)), b))
    p, st = step.init_state()
    loss, p, st = step(p, st, (torch.from_numpy(x), torch.from_numpy(y)),
                       LR, 1)
    n_losses, n_params, _, _ = _zero0(w, x, y, steps=1, stage=1)
    out["bridge"] = dict(stage=step.stage, dp=step.dp,
                         loss_equal=float(loss) == n_losses[0],
                         equal=all(torch.equal(p[k], n_params[k])
                                   for k in p))
    try:
        Z.group_sharded_parallel(net, Adam(parameters=net.parameters()),
                                 level="p_g_os")[0].zero_train_step()
        out["stage3_bridge"] = None
    except NotImplementedError as e:
        out["stage3_bridge"] = str(e)
    # fleet.distributed_optimizer at sharding 4: ZeRO-1 over the group
    _init(sharding=4)
    net = mlp4()
    load_reference_state(net, w)
    hybrid = fleet.distributed_optimizer(
        Adam(learning_rate=LR, parameters=net.parameters()))
    step = hybrid.zero_train_step(net, lambda p, a, b: _ce(
        torch.func.functional_call(net, p, (a,)), b))
    p, st = step.init_state()
    loss, p, st = step(p, st, (torch.from_numpy(x), torch.from_numpy(y)),
                       LR, 1)
    out["fleet_bridge"] = dict(dp=step.dp, stage=step.stage,
                               finite=bool(np.isfinite(float(loss))))
    return out
