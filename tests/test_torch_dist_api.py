"""The rest of the port's collectives (paddle_tpu_torch.distributed:
reduce, reduce_scatter, broadcast, scatter, alltoall, the object
collectives, isend / irecv, wait, stream, get_backend), ParallelEnv and
init_parallel_env from the launcher's environment.

One world of four gloo ranks runs every collective once (a module-scoped
fixture; the rank body is tests/_torch_dist_ranks.py, which imports no
JAX). Each result is held to its definition computed here in numpy (the
sums in rank order, float32, so bit for bit), and the collectives the
JAX package has under shard_map (reduce_scatter, broadcast, scatter,
alltoall) to the reference's outputs on four fake devices, jitted. The
reference's object collectives echo the local value and its get_backend
says "XLA" (ROADMAP, facts of the reference); the port's really
communicate and say "GLOO".
"""
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_dist_ranks as ranks
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import env as penv

try:                                    # jax >= 0.5 exports it at top level
    from jax import shard_map
except ImportError:                     # jax 0.4.x: experimental home
    from jax.experimental.shard_map import shard_map

N = 4


@pytest.fixture(scope="module")
def seen():
    return ptd.spawn(ranks.api_rank, nprocs=N, device="cpu", timeout=120)


def _x(r):
    return ranks.api_value(r).numpy()


def _ordered(arrays, op=np.add):
    out = arrays[0]
    for a in arrays[1:]:
        out = op(out, a)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's reduce_scatter (tensor_list form), broadcast
    (src 2), scatter (every rank's list, as SPMD has it) and alltoall
    under shard_map over 4 fake devices, one jitted call."""
    g = jdist.new_group(list(range(N)), axis_name="x")
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("x",))
    xs = np.stack([_x(r) for r in range(N)])
    parts = np.stack([np.stack([p.numpy() for p in ranks.api_parts(r, N)])
                      for r in range(N)])
    lst = np.stack([np.full((2,), 10.0 * j + 0.5, np.float32)
                    for j in range(N)])
    ins = np.stack([np.stack([np.array([100.0 * r + j, -float(j)],
                                       np.float32) for j in range(N)])
                    for r in range(N)])

    def f(x, pr, ins_):
        rs = Tensor(jnp.zeros(3))
        rs = jdist.reduce_scatter(rs, [Tensor(p) for p in pr[0]], group=g)
        b = jdist.broadcast(Tensor(x[0]), src=2, group=g)
        sc = jdist.scatter(Tensor(jnp.zeros(2)),
                           [Tensor(jnp.asarray(v)) for v in lst], group=g)
        a2a = jdist.alltoall([Tensor(t) for t in ins_[0]], group=g)
        return (rs._data[None], b._data[None], sc._data[None],
                jnp.stack([t._data for t in a2a])[None])

    kw = {"check_vma": False} if hasattr(jax, "shard_map") else \
        {"check_rep": False}
    fn = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("x"),) * 3,
                           out_specs=(P("x"),) * 4, **kw))
    out = fn(jnp.asarray(xs), jnp.asarray(parts), jnp.asarray(ins))
    return [np.asarray(o) for o in out]


def test_world_and_backend(seen):
    assert [s["rank"] for s in seen] == list(range(N))
    assert {s["backend"] for s in seen} == {"GLOO"}
    assert ptd.get_backend() == "GLOO"      # the one-rank world
    assert jdist.get_backend() == "XLA"     # the reference's own answer


def test_broadcast_from_a_global_and_a_group_rank(seen, jax_ref):
    for me, s in enumerate(seen):
        np.testing.assert_array_equal(s["broadcast"], _x(2))
        np.testing.assert_array_equal(s["broadcast"], jax_ref[1][me])
        second = _x((me // 2) * 2 + 1)
        np.testing.assert_array_equal(s["broadcast_pair_global"], second)
        np.testing.assert_array_equal(s["broadcast_pair_local"], second)


def test_reduce_lands_on_dst_in_rank_order(seen):
    xs = [_x(r) for r in range(N)]
    for me, s in enumerate(seen):
        want = _ordered(xs) if me == 1 else xs[me]
        np.testing.assert_array_equal(s["reduce_sum"], want)
        want = _ordered(xs, np.maximum) if me == 3 else xs[me]
        np.testing.assert_array_equal(s["reduce_max"], want)


def test_reduce_scatter_sums_each_part_in_rank_order(seen, jax_ref):
    parts = [[p.numpy() for p in ranks.api_parts(r, N)] for r in range(N)]
    bigs = [np.arange(N * 2 * 3, dtype=np.float32).reshape(N * 2, 3)
            * np.float32(0.11) + np.float32(r * 0.7) for r in range(N)]
    for me, s in enumerate(seen):
        want = _ordered([parts[r][me] for r in range(N)])
        np.testing.assert_array_equal(s["reduce_scatter_list"], want)
        np.testing.assert_allclose(s["reduce_scatter_list"], jax_ref[0][me],
                                   rtol=1e-6)
        want = _ordered([b[2 * me:2 * me + 2] for b in bigs])
        np.testing.assert_array_equal(s["reduce_scatter"], want)


def test_scatter_and_alltoall(seen, jax_ref):
    for me, s in enumerate(seen):
        np.testing.assert_array_equal(s["scatter"], [10.0 * me + 0.5] * 2)
        np.testing.assert_array_equal(s["scatter"], jax_ref[2][me])
        want = [np.array([100.0 * j + me, -float(me)], np.float32)
                for j in range(N)]
        np.testing.assert_array_equal(np.stack(s["alltoall"]),
                                      np.stack(want))
        np.testing.assert_array_equal(np.stack(s["alltoall"]),
                                      jax_ref[3][me])


def test_object_collectives_communicate(seen):
    for me, s in enumerate(seen):
        assert s["all_gather_object"] == [{"rank": r, "sq": r * r}
                                          for r in range(N)]
        assert s["broadcast_object_list"] == [{"from": 3}, "xxxx", 3]
        assert s["scatter_object_list"] == [f"obj{me}"]
        assert "one entry per rank" in s["scatter_short"]


def test_reference_object_collectives_only_echo():
    """The single-controller reference: what this rank passed comes
    back; the port's one-rank world does the same."""
    for d in (jdist, ptd):
        objs = []
        d.all_gather_object(objs, {"a": 1})
        assert objs == [{"a": 1}]
        lst = [{"x": 1}]
        assert d.broadcast_object_list(lst) is lst
        out = []
        d.scatter_object_list(out, [42])
        assert out == [42]
        with pytest.raises(ValueError):
            d.scatter_object_list([], [])


def test_isend_irecv_wait_and_stream(seen):
    xs = [_x(r) for r in range(N)]
    for me, s in enumerate(seen):
        np.testing.assert_array_equal(s["irecv"], xs[(me - 1) % N] * 2)
        # all_reduce is gloo's own sum, whose order is not fixed
        np.testing.assert_allclose(s["stream_all_reduce"], _ordered(xs),
                                   rtol=1e-6)
    assert ptd.stream.broadcast is ptd.broadcast
    assert ptd.wait(7) == 7


def test_parallel_env_in_the_ranks(seen):
    for me, s in enumerate(seen):
        assert s["parallel_env"] == (me, N, N, me)


def test_parallel_env_reads_the_launcher(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_LOCAL_RANK", "1")
    monkeypatch.setenv("PADDLE_CURRENT_ENDPOINT", "10.0.0.2:6171")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS",
                       "10.0.0.1:6170,10.0.0.2:6171")
    pe = ptd.ParallelEnv()
    assert (pe.rank, pe.world_size, pe.nranks, pe.local_rank) == (3, 8, 8, 1)
    assert pe.device_id == 1                 # the local rank, no card
    monkeypatch.setenv("FLAGS_selected_gpus", "5,6")
    assert pe.device_id == 5
    assert pe.current_endpoint == "10.0.0.2:6171"
    assert pe.trainer_endpoints == ["10.0.0.1:6170", "10.0.0.2:6171"]
    assert penv.device_index(4) == 1         # 5 modulo the 4 cards


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("source", ["PADDLE_MASTER",
                                    "PADDLE_TRAINER_ENDPOINTS"])
def test_init_parallel_env_joins_the_launchers_world(monkeypatch, source):
    """No arguments: rank and world from PADDLE_*, the rendezvous from
    PADDLE_MASTER, else the first trainer endpoint."""
    port = _free_port()
    for name in ("MASTER_ADDR", "MASTER_PORT", "PADDLE_MASTER",
                 "PADDLE_TRAINER_ENDPOINTS", "RANK", "WORLD_SIZE"):
        # set, then delete: the test's end restores each as it was,
        # including the ones init_parallel_env sets
        monkeypatch.setenv(name, "")
        monkeypatch.delenv(name)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    monkeypatch.setenv(source, f"127.0.0.1:{port}"
                       + (",127.0.0.1:1" if source != "PADDLE_MASTER"
                          else ""))
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        g = ptd.init_parallel_env(device="cpu")
        assert (g.rank, g.nranks, g.backend) == (0, 1, "gloo")
        assert ptd.is_initialized()
        assert os.environ["MASTER_PORT"] == str(port)
        assert os.environ["MASTER_ADDR"] == "127.0.0.1"
    finally:
        ptd.destroy_process_group()
    assert not ptd.is_initialized()


def test_exports_the_references_names():
    """Every name the reference's distributed package exports
    (paddle_tpu/distributed/__init__.py:8-38) resolves in the port's."""
    missing = [n for n in dir(jdist) if not n.startswith("_")
               and not hasattr(ptd, n)]
    assert missing == []
    for n in ("broadcast", "reduce", "reduce_scatter", "scatter", "alltoall",
              "all_gather_object", "broadcast_object_list",
              "scatter_object_list", "get_backend", "isend", "irecv",
              "wait", "stream", "DataParallel", "ParallelEnv", "TCPStore",
              "save_state_dict", "load_state_dict", "ProcessMesh", "Shard",
              "Replicate", "Partial", "shard_tensor", "reshard",
              "shard_layer", "dtensor_from_fn", "Engine",
              "complete_param_shardings", "rpc", "auto_tuner", "elastic",
              "FleetExecutor", "TaskNode", "launch"):
        assert n in ptd.__all__, n
