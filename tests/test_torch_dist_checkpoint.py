"""The port's distributed checkpoint (paddle_tpu_torch.distributed.
checkpoint): the reference's on-disk layout, resharding on load, the
asynchronous save, and checkpoints crossing between the two packages.

One world of two gloo ranks (a module-scoped fixture; the rank body is
tests/_torch_dist_ranks.py, which imports no JAX) saves a Shard(0)
tensor over mesh [0, 1], a column-parallel layer's split weight, a
replicated tensor, an int64 tensor, a bfloat16 one and a scalar; loads a
world-1 checkpoint of the port and one the JAX package saved on its 8
fake devices into Shard(1) placements; and makes two async saves back to
back (tests/test_distributed.py:654-672). This process (a world of one)
loads the world-2 checkpoint, and the JAX package loads it too. Values
are compared exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_dist_ranks as ranks
import paddle_tpu.distributed as jdist
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import checkpoint as ck

W = np.arange(32.0, dtype=np.float32).reshape(8, 4) * 0.25 - 3.0
B = np.linspace(-1, 1, 4).astype(np.float32)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    world1 = os.path.join(tmp, "world1")
    ck.save_state_dict({"w": torch.from_numpy(W) * 3, "b":
                        torch.from_numpy(B) * 3, "step": 5}, world1)
    jax_dir = os.path.join(tmp, "jax")
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("dp",))
    sharded = jax.device_put(jnp.asarray(W * 5),
                             NamedSharding(mesh, P("dp", None)))
    jdist.save_state_dict({"w": Tensor(sharded),
                           "b": Tensor(jnp.asarray(B * 5)), "step": 11},
                          jax_dir)
    ck.save_state_dict({"gpt": _dense_gpt(7).state_dict()},
                       os.path.join(tmp, "gpt_world1"))
    return tmp, world1, jax_dir


def _dense_gpt(seed):
    from paddle_tpu_torch.models import GPTConfig, GPTModel

    return GPTModel(GPTConfig.tiny(), device="cpu", seed=seed)


@pytest.fixture(scope="module")
def world(dirs):
    tmp, world1, jax_dir = dirs
    return ptd.spawn(ranks.ckpt_rank, (tmp, world1, jax_dir, W, B),
                     nprocs=2, device="cpu", timeout=120)


def test_world2_layout_is_the_references(world, dirs):
    path = os.path.join(dirs[0], "world2")
    assert sorted(f for f in os.listdir(path)) == [
        "meta_rank0.json", "meta_rank1.json", "metadata.json",
        "shard_0.pkl", "shard_1.pkl"]
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert meta["world"] == 2
    w = meta["tensors"]["w"]
    assert w["shape"] == [8, 4] and w["dtype"] == "float32"
    assert sorted(s["index"] for s in w["shards"]) == [[[0, 4], [0, 4]],
                                                       [[4, 8], [0, 4]]]
    assert w["files"] == ["shard_0.pkl", "shard_1.pkl"]
    # a replicated tensor and the scalar are written once, by rank 0
    assert len(meta["tensors"]["b"]["shards"]) == 1
    assert meta["tensors"]["b"]["file"] == "shard_0.pkl"
    assert meta["tensors"]["step"] == {"scalar": True, "file": "shard_0.pkl"}
    assert meta["tensors"]["half"]["dtype"] == "bfloat16"
    for r, s in enumerate(world):
        np.testing.assert_array_equal(s["block"], W[4 * r:4 * r + 4])
    # the column-parallel weight: each rank's rows of the (8, 4) whole
    col = meta["tensors"]["col.weight"]
    assert col["shape"] == [8, 4]
    assert sorted(sh["index"] for sh in col["shards"]) == [
        [[0, 4], [0, 4]], [[4, 8], [0, 4]]]


def test_mp_split_parameter_round_trips(world, dirs):
    """Saved from its placement at mp 2, whole at world 1, each rank's
    rows again at world 2."""
    whole = np.concatenate([s["col_part"] for s in world])
    tgt = {"col": {"weight": torch.zeros(8, 4), "bias": torch.zeros(8)}}
    ck.load_state_dict(tgt, os.path.join(dirs[0], "world2"))
    np.testing.assert_array_equal(tgt["col"]["weight"].numpy(), whole)
    for s in world:
        np.testing.assert_array_equal(s["col_reloaded"], s["col_part"])


def test_mp_adam_state_round_trips_at_mp2(world):
    """Fleet mp layers and their Adam moments, saved at mp 2 and loaded
    into a fresh model and optimizer at mp 2: every rank gets back its
    own parts, moments included."""
    for s in world:
        leg = s["mp_adam"]
        assert set(leg["loaded"]) == set(leg["saved"])
        for k, v in leg["saved"].items():
            np.testing.assert_array_equal(leg["loaded"][k], v, err_msg=k)
    # the moments of a split parameter are split as it is
    axes = world[0]["mp_adam"]["axis"]
    assert {k for k, a in axes.items() if a is not None} >= {
        "model.0.weight", "model.1.weight"}
    assert sum(a is not None for k, a in axes.items()
               if k.startswith("opt.")) >= 6


def test_mp_adam_state_loads_whole_at_world1(world, dirs):
    """The mp-2 checkpoint at world 1: each split tensor (a parameter or
    a moment) is the ranks' parts side by side, a replicated one is any
    rank's."""
    path = os.path.join(dirs[0], "mp2_adam")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)["tensors"]
    legs = [s["mp_adam"] for s in world]
    for k, axis in legs[0]["axis"].items():
        top, rest = k.split(".", 1)
        tgt = {top: {rest: torch.zeros(meta[k]["shape"])}}
        ck.load_state_dict(tgt, path)
        whole = tgt[top][rest].numpy()
        want = (legs[0]["saved"][k] if axis is None else np.concatenate(
            [leg["saved"][k] for leg in legs], axis=axis))
        np.testing.assert_array_equal(whole, want, err_msg=k)


def test_gpt_interleaved_qkv_reshards_across_degrees(world, dirs):
    """GPT's fused QKV is split by head in the (mp, 3, heads / mp, hd)
    layout; the checkpoint holds it in the dense (3, heads, hd) layout, so
    an mp-2 checkpoint loads into the dense model and a dense one into
    the mp-2 model (the seeded tensor-parallel model holds the slices of
    the dense model of its seed)."""
    for s in world:
        assert s["gpt"]["differ"] == []
        assert s["gpt"]["qkv_rows"] == 3 * 128 // 2
    got = _dense_gpt(9)
    ck.load_state_dict({"gpt": got.state_dict(keep_vars=True)},
                       os.path.join(dirs[0], "gpt_mp2"))
    want = dict(_dense_gpt(3).named_parameters())
    assert [n for n, p in got.named_parameters()
            if not torch.equal(p, want[n])] == []


def test_stripped_split_parameters_are_refused(world):
    """`state_dict()` without keep_vars drops the mp placement, so both
    ranks claim one block with different values: the save raises on
    every rank rather than write rank 0's part as the whole."""
    for s in world:
        assert "different values" in s["mp_adam"]["refused"]
        assert "'model.0." in s["mp_adam"]["refused"]


def test_world2_loads_at_world1(dirs, world):
    tgt = {"w": torch.zeros(8, 4), "b": torch.zeros(4),
           "count": torch.zeros(5, dtype=torch.int64),
           "half": torch.zeros(8, 4, dtype=torch.bfloat16), "step": 0}
    ck.load_state_dict(tgt, os.path.join(dirs[0], "world2"))
    np.testing.assert_array_equal(tgt["w"].numpy(), W)
    np.testing.assert_array_equal(tgt["b"].numpy(), B)
    np.testing.assert_array_equal(tgt["count"].numpy(), np.arange(5) * 3)
    assert torch.equal(tgt["half"],
                       (torch.from_numpy(W) * 0.5).to(torch.bfloat16))
    assert tgt["step"] == 7


@pytest.mark.parametrize("tag,scale,step", [("world1", 3, 5),
                                            ("jax", 5, 11)])
def test_loads_reshard_to_this_ranks_placement(world, tag, scale, step):
    """A world-1 port checkpoint and a JAX checkpoint sharded over 8
    devices, each loaded at world 2 into a Shard(1) placement."""
    for r, s in enumerate(world):
        got = s[tag]
        np.testing.assert_array_equal(got["w"], (W * scale)[:, 2 * r:2 * r
                                                            + 2])
        np.testing.assert_array_equal(got["b"], B * scale)
        assert got["step"] == step


def test_jax_checkpoint_loads_at_world1(dirs):
    tgt = {"w": torch.zeros(8, 4), "b": torch.zeros(4), "step": 0}
    ck.load_state_dict(tgt, dirs[2])
    np.testing.assert_array_equal(tgt["w"].numpy(), W * 5)
    np.testing.assert_array_equal(tgt["b"].numpy(), B * 5)
    assert tgt["step"] == 11


def test_port_checkpoint_loads_in_jax(dirs, world):
    sd = {"w": Tensor(jnp.zeros((8, 4))), "b": Tensor(jnp.zeros(4)),
          "count": Tensor(jnp.zeros(5, jnp.int32)), "step": 0}
    jdist.load_state_dict(sd, os.path.join(dirs[0], "world2"))
    np.testing.assert_array_equal(np.asarray(sd["w"]._data), W)
    np.testing.assert_array_equal(np.asarray(sd["b"]._data), B)
    np.testing.assert_array_equal(np.asarray(sd["count"]._data),
                                  np.arange(5) * 3)
    assert int(sd["step"]) == 7


def test_async_saves_order_and_wait(world):
    """Two async saves back to back: the second joins the first first,
    and wait_save leaves nothing pending."""
    for s in world:
        assert s["pending_after_wait"] == 0
        np.testing.assert_array_equal(s["async_b"], W * 2)


def test_async_save_at_world1(tmp_path):
    w = torch.from_numpy(W).clone()
    ck.save_state_dict({"w": w}, str(tmp_path / "a"), async_save=True)
    w.mul_(2)       # training may overwrite the tensor at once
    ck.save_state_dict({"w": w}, str(tmp_path / "b"), async_save=True)
    ck.wait_save()
    assert not ck._PENDING
    for sub, want in (("a", W), ("b", W * 2)):
        got = {"w": torch.zeros(8, 4)}
        ck.load_state_dict(got, str(tmp_path / sub))
        np.testing.assert_array_equal(got["w"].numpy(), want)


def test_missing_tensor_raises(dirs):
    with pytest.raises(KeyError, match="nope"):
        ck.load_state_dict({"nope": torch.zeros(1)}, dirs[1])
