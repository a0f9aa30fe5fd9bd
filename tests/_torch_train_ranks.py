"""Rank bodies of the port's ZeRO and training-telemetry tests, run by
`paddle_tpu_torch.distributed.spawn` over gloo on the CPU in a world of
four ranks. This module imports neither JAX nor paddle_tpu; the tests
compute the JAX references in their own process and read numpy results
from here.

The world of four also forms the groups {0, 1}, {2, 3} (dp 2) and one
group a rank (dp 1), so one spawn runs every degree: every rank runs
every leg of its groups and returns what it saw."""
import tempfile

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.optimizer import Adam, AdamW, Momentum, SGD
from paddle_tpu_torch.parallel import zero as Z

LR = 0.01


def mlp(weights):
    """The reference tests' MLP (Linear 16 -> 48, ReLU, Linear 48 -> 8) in
    torch, from `weights` (numpy, torch's (out, in) layout)."""
    net = torch.nn.Sequential(torch.nn.Linear(16, 48), torch.nn.ReLU(),
                              torch.nn.Linear(48, 8))
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in weights.items()})
    return net


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return {k: _np(v) for k, v in tree.items()}


def run(weights, x, y, group, stage, steps=3, opt_cls=Adam, host=None,
        params=None, start=1, **kw):
    """`steps` ZeRO steps of the MLP on `group`; returns (losses, params,
    step, state), the last two live."""
    net = mlp(weights)
    opt = opt_cls(learning_rate=LR, parameters=net.parameters())
    step = Z.zero_train_step(net, opt, stage=stage, group=group, **kw)
    p, st = step.init_state(params)
    if host is not None:
        st = step.load_optimizer_state(host)
    xb, yb = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for t in range(start, start + steps):
        loss, p, st = step(p, st, (xb, yb), LR, t)
        losses.append(float(loss))
    return losses, p, step, st


def _groups():
    g = ptd.get_group()
    pairs = [ptd.new_group([0, 1]), ptd.new_group([2, 3])]
    singles = [ptd.new_group([r]) for r in range(g.nranks)]
    return g, pairs[g.rank // 2], singles[g.rank]


def collective_legs(group):
    """The data-parallel collectives of parallel/mesh.py on this rank's
    seeded (n * 5,) vector: every form's result."""
    from paddle_tpu_torch.parallel import mesh as M

    gen = torch.Generator().manual_seed(100 + group.rank)
    x = torch.randn(group.nranks * 5, generator=gen)
    return dict(
        x=x.numpy(), psum=M.ordered_psum(x, group).numpy(),
        ring_psum=M.ring_ordered_psum(x, group).numpy(),
        scatter=M.ordered_psum_scatter(x, group).numpy(),
        ring_scatter=M.ring_ordered_psum_scatter(x, group).numpy(),
        start_scatter=M.start_ordered_psum_scatter(x, group).wait().numpy(),
        gathered=M.start_all_gather(x, group).wait().numpy(),
        ring_collect=M.ring_collect(x, group).numpy())


def zero_rank(weights, x, y):
    """Every ZeRO leg of tests/test_torch_zero.py on this rank."""
    world, pair, single = _groups()
    by_dp = {1: single, 2: pair, 4: world}
    out = {"rank": world.rank, "collectives": collective_legs(world)}

    def leg(name, group, stage, **kw):
        losses, p, step, st = run(weights, x, y, group, stage, **kw)
        out[name] = dict(losses=losses, params=_np(p),
                         opt_bytes=step.optimizer_state_bytes_per_chip(st))
        return p, step, st

    for dp in (2, 4):
        g = by_dp[dp]
        for stage in (0, 1, 2):
            leg(f"dp{dp} stage{stage}", g, stage)
        for b in (None, 1024, 4096):
            for ov in (False, True):
                if b is None and not ov:
                    continue
                for stage in (1, 2):
                    leg(f"dp{dp} stage{stage} bucket{b} overlap{ov}", g,
                        stage, bucket_bytes=b, overlap=ov)
    for accum in (2, 4):
        for stage in (0, 1, 2):
            leg(f"dp2 stage{stage} accum{accum}", pair, stage,
                grad_accum=accum)
    leg("dp2 stage1 accum1", pair, 1)
    # the degree-blind checkpoint: the host form is the same at every dp
    hosts = {}
    for dp in (1, 2, 4):
        _, _, step, st = run(weights, x, y, by_dp[dp], 1, steps=0)
        hosts[dp] = _np(step.save_optimizer_state(st))
        out[f"init bytes dp{dp}"] = step.optimizer_state_bytes_per_chip(st)
    out["init hosts"] = hosts
    # save at dp 2 after 2 steps, restore at dp 4 (stage 2 and stage 0)
    _, p2, s2, st2 = run(weights, x, y, pair, 1, steps=2)
    host = s2.save_optimizer_state(st2)
    saved_params = {k: v.clone() for k, v in p2.items()}
    for stage in (0, 2):
        losses, p, _, _ = run(weights, x, y, world, stage, steps=1,
                              host=host, params=saved_params, start=3)
        out[f"restored dp4 stage{stage}"] = dict(losses=losses,
                                                 params=_np(p))
    # sharded state == replicated state after identical steps
    for stage in (0, 1):
        _, _, step, st = run(weights, x, y, pair, stage, steps=2)
        out[f"saved dp2 stage{stage}"] = _np(step.save_optimizer_state(st))
    # elementwise rules other than Adam keep the parity
    for cls in (SGD, Momentum, AdamW):
        for stage in (0, 2):
            leg(f"dp4 stage{stage} {cls.__name__}", world, stage,
                opt_cls=cls)
    out.update(bf16_legs(weights, x, y, pair))
    out.update(probe_legs(weights, x, y, pair))
    return out


def bf16_legs(weights, x, y, group):
    """param_dtype="bf16": the master layout, a planted non-finite step,
    scale growth and the loss against fp32."""
    out = {}
    losses32, _, _, _ = run(weights, x, y, group, 2, steps=4)
    losses, p, step, st = run(weights, x, y, group, 2, steps=4,
                              param_dtype="bf16", scale_growth_interval=2,
                              loss_scale=2.0 ** 10)
    m = st["0.weight"]
    out["bf16"] = dict(
        losses=losses, losses32=losses32,
        param_dtypes=sorted({str(v.dtype) for v in p.values()}),
        slots=sorted(m), master_dtype=str(m["master_weight"].dtype),
        master_shape=tuple(m["master_weight"].shape),
        scale=float(st[Z._SCALER_KEY]["scale"]))
    # a planted inf: the step keeps parameters and state, the scale halves
    bad = x.copy()
    bad[0, 0] = np.inf
    before = {k: v.clone() for k, v in p.items()}
    st_before = {k: {s: v.clone() for s, v in a.items()}
                 for k, a in st.items()}
    loss, p_after, st_after = step(p, st, (torch.from_numpy(bad),
                                           torch.from_numpy(y)), LR, 5)
    out["bf16 planted"] = dict(
        params_kept=all(torch.equal(before[k], p_after[k]) for k in p),
        state_kept=all(torch.equal(st_before[k][s], st_after[k][s])
                       for k in st if k != Z._SCALER_KEY for s in st[k]),
        scale_before=float(st_before[Z._SCALER_KEY]["scale"]),
        scale_after=float(st_after[Z._SCALER_KEY]["scale"]))
    return out


def probe_legs(weights, x, y, group):
    out = {}
    _, _, step, st = run(weights, x, y, group, 2, steps=1,
                         bucket_bytes=1024, overlap=True)
    out["probes"] = dict(
        collective=step.collective_seconds(samples=2),
        comm=step.comm_seconds(samples=1, elems=1024, best_of=2),
        shard=step.shard_step_seconds(samples=1, best_of=2),
        overlap=step.measure_overlap_fraction(samples=1, best_of=2),
        describe={k: v for k, v in step.describe().items()
                  if k != "telemetry"})
    return out


def telemetry_rank(weights, x, y):
    """Telemetry on and off on the world of four: the same parameters,
    one host drain a step, the snapshot; then a diverging run whose
    sentinel trips and writes a bundle (rank 0 only writes)."""
    from paddle_tpu_torch.observability import training as T

    world = ptd.get_group()
    out = {}
    _, p_off, _, st_off = run(weights, x, y, world, 2, steps=3)
    tele = T.TrainingTelemetry(tokens_per_step=x.shape[0])
    losses, p_on, step, st_on = run(weights, x, y, world, 2, steps=3,
                                    telemetry=tele)
    out["on_equals_off"] = all(torch.equal(p_off[k], p_on[k])
                               for k in p_off)
    out["losses_on"] = losses
    out["snapshot"] = tele.snapshot()
    out["summary"] = tele.summary()
    # bf16 with telemetry: the scaler fields ride the same vector
    tele16 = T.TrainingTelemetry()
    run(weights, x, y, world, 2, steps=2, telemetry=tele16,
        param_dtype="bf16")
    out["bf16_last"] = tele16.summary()["last"]
    # a NaN step trips the sentinel: one bundle
    with tempfile.TemporaryDirectory() as tmp:
        trip = T.TrainingTelemetry(postmortem_dir=tmp if world.rank == 0
                                   else None)
        net = mlp(weights)
        opt = SGD(learning_rate=LR, parameters=net.parameters())
        step = Z.zero_train_step(net, opt, stage=1, group=world,
                                 telemetry=trip)
        p, st = step.init_state()
        bad = x.copy()
        bad[1, 2] = np.nan
        try:
            step(p, st, (torch.from_numpy(bad), torch.from_numpy(y)), LR, 1)
            out["tripped"] = None
        except T.TrainingDiverged as e:
            out["tripped"] = dict(condition=e.verdict["condition"],
                                  path=e.bundle_path is not None)
            if e.bundle_path is not None:
                with open(e.bundle_path) as f:
                    out["bundle_text"] = f.read()
    return out
