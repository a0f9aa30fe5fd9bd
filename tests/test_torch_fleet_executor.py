"""The port's FleetExecutor (paddle_tpu_torch.distributed.fleet_executor)
and auto tuner (paddle_tpu_torch.distributed.auto_tuner), copied host
modules, against tests/test_fleet_executor.py and tests/test_auto_tuner.py
and against the JAX package on the same inputs: candidate lists equal to
the JAX package's, every DAG's outputs equal, and tensor compute sections
(a two-stage pipeline over micro-batches, torch modules) held to the JAX
sections with the weights carried across (rtol 1e-5, atol 1e-6)."""
import json
import math
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import auto_tuner as jat
from paddle_tpu.distributed import fleet_executor as jfe
from paddle_tpu_torch.distributed import auto_tuner as pat
from paddle_tpu_torch.distributed import fleet_executor as pfe
from paddle_tpu_torch.distributed import FleetExecutor, TaskNode


def _linear(T):
    src = T(run_fn=lambda s, i: s + 1, max_run_times=4, node_type="Feed")
    mid = T(run_fn=lambda s, i: i[src.task_id] * 2, max_run_times=4)
    sink = T(run_fn=lambda s, i: i[mid.task_id] + 100, max_run_times=4)
    src.add_downstream_task(mid.task_id, buffer_size=1)
    mid.add_downstream_task(sink.task_id, buffer_size=1)
    return [src, mid, sink], {}, sink.task_id


def _diamond(T):
    a = T(run_fn=lambda s, i: s, max_run_times=3)
    b = T(run_fn=lambda s, i: i[a.task_id] + 10, max_run_times=3)
    c = T(run_fn=lambda s, i: i[a.task_id] + 20, max_run_times=3)
    d = T(run_fn=lambda s, i: i[b.task_id] + i[c.task_id], max_run_times=3)
    for x, y in ((a, b), (a, c), (b, d), (c, d)):
        x.add_downstream_task(y.task_id)
    return [a, b, c, d], {}, d.task_id


def _feed(T):
    n = T(run_fn=lambda s, i: i["feed"] * 2, max_run_times=2)
    return [n], {"feed": {n.task_id: [3, 5]},
                 "fetch_task_ids": [n.task_id]}, n.task_id


def _two_carriers(T):
    a = T(rank=0, run_fn=lambda s, ins: s * 10, max_run_times=3)
    b = T(rank=1, run_fn=lambda s, ins: ins[a.task_id] + 1, max_run_times=3)
    a.add_downstream_task(b.task_id, buffer_size=1)
    return [a, b], {}, b.task_id


def _amplifier(T):
    s = T(node_type="Source", run_fn=lambda st, ins: st, max_run_times=2)
    amp = T(node_type="Amplifier", amplify=3, max_run_times=2)
    k = T(node_type="Sink", max_run_times=6)
    s.add_downstream_task(amp.task_id, buffer_size=1)
    amp.add_downstream_task(k.task_id, buffer_size=2)
    return [s, amp, k], {}, k.task_id


DAGS = {"linear": _linear, "diamond": _diamond, "feed": _feed,
        "two carriers": _two_carriers, "amplifier": _amplifier}


@pytest.mark.parametrize("name", list(DAGS))
def test_dags_give_the_references_outputs(name):
    """The reference tests' DAGs (tests/test_fleet_executor.py), each built
    in both packages."""
    nodes, kw, fetch = DAGS[name](pfe.TaskNode)
    jnodes, jkw, jfetch = DAGS[name](jfe.TaskNode)
    ex = FleetExecutor(nodes)
    got = ex.run(**kw)[fetch]
    assert got == jfe.FleetExecutor(jnodes).run(**jkw)[jfetch]
    assert all(not c.interceptors for c in ex.carriers.values())


def test_cycle_rejected_and_errors_surface_fast():
    a = TaskNode(run_fn=lambda s, i: 0, max_run_times=1)
    b = TaskNode(run_fn=lambda s, i: 0, max_run_times=1)
    a.add_downstream_task(b.task_id)
    b.add_downstream_task(a.task_id)
    with pytest.raises(ValueError, match="cycle"):
        FleetExecutor([a, b])

    def boom(step, ins):
        raise RuntimeError("consumer died")

    a = TaskNode(run_fn=lambda s, i: s, max_run_times=50)
    b = TaskNode(run_fn=boom, max_run_times=50)
    a.add_downstream_task(b.task_id, buffer_size=1)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="consumer died"):
        FleetExecutor([a, b]).run(timeout=60.0)
    assert time.perf_counter() - t0 < 5.0


def test_stages_overlap():
    M, delay = 4, 0.05
    a = TaskNode(run_fn=lambda s, i: time.sleep(delay) or s, max_run_times=M)
    b = TaskNode(run_fn=lambda s, i: time.sleep(delay) or i[a.task_id],
                 max_run_times=M)
    a.add_downstream_task(b.task_id)
    t0 = time.perf_counter()
    FleetExecutor([a, b]).run()
    assert time.perf_counter() - t0 < 2 * M * delay * 0.9


def test_tensor_compute_sections_match_the_jax_sections():
    """A two-stage pipeline over two micro-batches: torch Linear sections
    against the JAX package's on the same weights and inputs."""
    paddle.seed(3)
    j1, j2 = jnn.Linear(4, 8), jnn.Linear(8, 2)
    x = np.random.RandomState(0).rand(4, 4).astype("float32")
    jmicro = [paddle.to_tensor(x[0:2]), paddle.to_tensor(x[2:4])]
    s1 = jfe.TaskNode(run_fn=lambda s, i: j1(jmicro[s]), max_run_times=2)
    s2 = jfe.TaskNode(run_fn=lambda s, i: j2(i[s1.task_id]), max_run_times=2)
    s1.add_downstream_task(s2.task_id)
    want = np.concatenate([o.numpy() for o in
                           jfe.FleetExecutor([s1, s2]).run()[s2.task_id]])

    def port_linear(j):
        lin = torch.nn.Linear(*np.asarray(j.weight._data).shape)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor(np.asarray(j.weight._data).T))
            lin.bias.copy_(torch.tensor(np.asarray(j.bias._data)))
        return lin

    l1, l2 = port_linear(j1), port_linear(j2)
    micro = [torch.from_numpy(x[0:2]), torch.from_numpy(x[2:4])]
    p1 = TaskNode(run_fn=lambda s, i: l1(micro[s]), max_run_times=2)
    p2 = TaskNode(run_fn=lambda s, i: l2(i[p1.task_id]), max_run_times=2)
    p1.add_downstream_task(p2.task_id)
    got = torch.cat(FleetExecutor([p1, p2]).run()[p2.task_id]).detach()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(),
                                   l2(l1(torch.from_numpy(x))).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_module_sections_take_the_merged_feed():
    """A `program` section is a torch module called with the section's
    feed dict (its own feed merged with upstream dict outputs)."""
    class Scale(torch.nn.Module):
        def forward(self, x, h):
            return x * 2.0 + h

    n1 = TaskNode(run_fn=lambda s, i: {"h": torch.ones(2)}, max_run_times=1)
    n2 = TaskNode(program=Scale(), max_run_times=1)
    n1.add_downstream_task(n2.task_id)
    out = FleetExecutor([n1, n2]).run(
        feed={n2.task_id: [{"x": torch.full((2,), 3.0)}]})
    assert torch.equal(out[n2.task_id][0], torch.full((2,), 7.0))


# --------------------------------------------------------------- auto_tuner
@pytest.mark.parametrize("kw", [
    dict(world_size=8, global_batch_size=16),
    dict(world_size=8, global_batch_size=8, num_layers=4,
         num_attention_heads=12, vocab_size=100),
    dict(world_size=4, global_batch_size=4),
    dict(world_size=8, global_batch_size=8,
         tuning_space={"pp_degree": [1], "use_recompute": [False],
                       "sharding_degree": [1]}),
])
def test_candidates_equal_the_references(kw):
    got = [c.to_dict() for c in pat.default_candidates(**kw)]
    assert got and got == [c.to_dict() for c in jat.default_candidates(**kw)]


def test_tune_picks_the_argmin_and_records_failures(tmp_path):
    cands = [pat.TuningConfig(dp_degree=8), pat.TuningConfig(mp_degree=8),
             pat.TuningConfig(pp_degree=8)]

    def cost_fn(cfg):
        if cfg.pp_degree == 8:
            raise MemoryError("trial OOM")
        return 1.0 if cfg.mp_degree == 8 else 2.0

    tuner = pat.AutoTuner(cands, log_dir=str(tmp_path))
    assert tuner.tune(cost_fn).mp_degree == 8 and tuner.best_cost == 1.0
    with open(tmp_path / "auto_tuner_history.json") as f:
        hist = json.load(f)
    assert hist["best"]["mp_degree"] == 8 and len(hist["history"]) == 3
    oom = [h for h in hist["history"] if "error" in h]
    assert len(oom) == 1 and "MemoryError" in oom[0]["error"]
    assert math.isinf(oom[0]["cost"])
    ran = []
    pat.AutoTuner(cands, max_trials=2).tune(lambda c: ran.append(c) or 1.0)
    assert len(ran) == 2


def test_tune_with_a_torch_cost_function():
    """The intended use: time a step under each candidate and keep the
    fastest (here a product over the candidate's micro batch)."""
    w = torch.ones(64, 64)

    def cost_fn(cfg):
        x = torch.ones(8 * cfg.micro_batch_size, 64)
        t0 = time.perf_counter()
        for _ in range(3):
            torch.relu(x @ w).sum()
        return time.perf_counter() - t0

    cands = pat.default_candidates(
        world_size=8, global_batch_size=16,
        tuning_space={"mp_degree": [1], "pp_degree": [1],
                      "sharding_degree": [1], "use_recompute": [False]})
    tuner = pat.AutoTuner(cands)
    best = tuner.tune(cost_fn)
    assert best is not None and best.dp_degree == 8
    assert all(h["cost"] != float("inf") for h in tuner.history)
