"""The port's ZeRO trainer (paddle_tpu_torch.parallel.zero) over four gloo
ranks on the CPU, held against itself and against the JAX package's
`ZeroTrainStep` (counterpart of tests/test_zero.py and
tests/test_zero_bucket.py, the classes that need no tp).

One world of four ranks runs every leg once (a module-scoped fixture;
the rank body is tests/_torch_train_ranks.py, which imports no JAX): dp 4
on the world, dp 2 on {0, 1} and {2, 3}, dp 1 on each rank alone. The
tests read rank 0's results.

Port against port, bit for bit (np.array_equal, and equal losses):
stage 1 and 2 against stage 0 at dp 2 and 4; bucketed (1 KiB, 4 KiB) and
overlapped runs against them; grad_accum 2 and 4 at every stage; a dp 2
checkpoint restored at dp 4 (stage 2 against stage 0); the gathered
stage-1 state against the stage-0 state. Optimizer bytes a rank are
exactly 1/dp of stage 0's (every leaf of the MLP divides 4).

Against the JAX package: `build_bucket_layout` equal to the reference's,
and the port's dp 2 stage 2 parameters after 3 Adam steps within an
absolute 2e-5 and relative 1e-4 of the JAX `ZeroTrainStep` at dp 2 on
fake devices (both fp32; the ranks' matmuls and the XLA CPU dots round
differently in the last bits, and Adam's first steps scale a gradient to
about lr * sign(g)).

bf16 (`param_dtype="bf16"`): bf16 parameters, an fp32 master slot in the
sharded layout, the loss within 1e-2 relative of fp32 at every step, a
planted inf that keeps parameters and state and halves the scale, and
the scale doubled every `scale_growth_interval` good steps.
"""
import functools
import inspect

import numpy as np
import pytest
import torch

import _torch_train_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.parallel import zero as jzero
from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, Lamb
from paddle_tpu_torch.parallel import zero as Z

HID = 48
_rng = np.random.RandomState(0)
X = _rng.randn(32, 16).astype("float32")
Y = _rng.randn(32, 8).astype("float32")


@functools.lru_cache(maxsize=None)
def _jax_net():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(16, HID), jnn.ReLU(),
                          jnn.Linear(HID, 8))


@functools.lru_cache(maxsize=None)
def _weights():
    """The JAX MLP's initial weights in torch's (out, in) layout."""
    params, _ = extract_state(_jax_net())
    return {k: (np.asarray(v).T.copy() if k.endswith("weight")
                else np.asarray(v)) for k, v in params.items()}


@pytest.fixture(scope="module")
def every_rank():
    return ptd.spawn(ranks.zero_rank, (_weights(), X, Y), nprocs=4,
                     device="cpu", timeout=240)


@pytest.fixture(scope="module")
def world(every_rank):
    return every_rank[0]


def _bit_equal(a, b):
    return all(np.array_equal(a[k], b[k]) for k in a)


def _same(r, a, b):
    assert r[a]["losses"] == r[b]["losses"], (a, b)
    assert _bit_equal(r[a]["params"], r[b]["params"]), (a, b)


class TestCollectives:
    """parallel/mesh.py's data-parallel collectives over the four ranks:
    the all-gather, all-to-all and ring forms give the same bits, and
    the sum is rank 0 + rank 1 + ... in that order (fp32 numpy)."""

    def test_every_form_gives_the_fixed_order_sum(self, every_rank):
        xs = [r["collectives"]["x"] for r in every_rank]
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        for rank, r in enumerate(every_rank):
            c = r["collectives"]
            mine = total[rank * 5:(rank + 1) * 5]
            assert np.array_equal(c["psum"], total)
            assert np.array_equal(c["ring_psum"], total)
            for form in ("scatter", "ring_scatter", "start_scatter"):
                assert np.array_equal(c[form], mine), form
            assert np.array_equal(c["gathered"], np.stack(xs))
            assert np.array_equal(c["ring_collect"], np.stack(xs))


class TestZeroParity:
    @pytest.mark.parametrize("dp", [2, 4])
    @pytest.mark.parametrize("stage", [1, 2])
    def test_sharded_equals_replicated_bitwise(self, world, dp, stage):
        _same(world, f"dp{dp} stage0", f"dp{dp} stage{stage}")
        b0 = world[f"dp{dp} stage0"]["opt_bytes"]
        b1 = world[f"dp{dp} stage{stage}"]["opt_bytes"]
        assert b1 * dp == b0

    @pytest.mark.parametrize("accum", [2, 4])
    def test_grad_accumulation_parity(self, world, accum):
        _same(world, f"dp2 stage0 accum{accum}", f"dp2 stage1 accum{accum}")
        _same(world, f"dp2 stage0 accum{accum}", f"dp2 stage2 accum{accum}")

    def test_grad_accumulation_approximates_full_batch(self, world):
        p1 = world["dp2 stage1 accum1"]["params"]
        p4 = world["dp2 stage1 accum4"]["params"]
        for k in p1:
            np.testing.assert_allclose(p1[k], p4[k], rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("opt", ["SGD", "Momentum", "AdamW"])
    def test_other_elementwise_rules_keep_parity(self, world, opt):
        _same(world, f"dp4 stage0 {opt}", f"dp4 stage2 {opt}")


class TestBucketsAndOverlap:
    @pytest.mark.parametrize("dp", [2, 4])
    @pytest.mark.parametrize("stage", [1, 2])
    @pytest.mark.parametrize("bucket,overlap", [
        (1024, False), (4096, False), (None, True), (1024, True),
        (4096, True)])
    def test_bucketed_and_overlapped_equal_serial(self, world, dp, stage,
                                                  bucket, overlap):
        _same(world, f"dp{dp} stage0",
              f"dp{dp} stage{stage} bucket{bucket} overlap{overlap}")

    @pytest.mark.parametrize("dp,cap", [(2, None), (2, 1024), (4, 4096),
                                        (4, 1 << 20), (8, 100)])
    def test_layout_equals_the_reference(self, dp, cap):
        names = [f"leaf{i}" for i in range(7)]
        chunks = {n: (i * 37) % 300 + 1 for i, n in enumerate(names)}
        assert Z.build_bucket_layout(names, chunks, 4, dp, cap) == \
            jzero.build_bucket_layout(names, chunks, 4, dp, cap)

    def test_layout_refuses_a_bad_cap(self):
        with pytest.raises(ValueError, match="bucket_bytes"):
            Z.build_bucket_layout(["a"], {"a": 1}, 4, 2, 0)


class TestDegreeBlindCheckpoint:
    def test_layout_roundtrip_any_degree(self, world):
        hosts = world["init hosts"]
        for dp in (2, 4):
            for k, slots in hosts[1].items():
                for s, v in slots.items():
                    assert np.array_equal(v, hosts[dp][k][s])
        sizes = [world[f"init bytes dp{dp}"] for dp in (1, 2, 4)]
        assert sizes[2] < sizes[1] < sizes[0]

    def test_save_dp2_restore_dp4_stays_in_lockstep(self, world):
        _same(world, "restored dp4 stage0", "restored dp4 stage2")

    def test_sharded_state_equals_replicated_state_on_save(self, world):
        h0, h1 = world["saved dp2 stage0"], world["saved dp2 stage1"]
        for k in h0:
            for s in h0[k]:
                assert np.array_equal(h0[k][s], h1[k][s]), (k, s)


class TestMixedPrecision:
    def test_master_layout(self, world):
        r = world["bf16"]
        assert r["param_dtypes"] == ["torch.bfloat16"]
        assert r["slots"] == ["master_weight", "moment1", "moment2"]
        assert r["master_dtype"] == "torch.float32"
        assert r["master_shape"] == (16 * HID // 2,)    # a dp 2 slice

    def test_loss_within_tolerance_of_fp32(self, world):
        r = world["bf16"]
        np.testing.assert_allclose(r["losses"], r["losses32"], rtol=1e-2)

    def test_scale_grows_after_good_steps(self, world):
        # 4 good steps at scale_growth_interval 2 from 2^10
        assert world["bf16"]["scale"] == 2.0 ** 12

    def test_planted_nonfinite_step_is_skipped(self, world):
        r = world["bf16 planted"]
        assert r["params_kept"] and r["state_kept"]
        assert r["scale_after"] == r["scale_before"] / 2


class TestAgainstReference:
    def test_dp2_stage2_matches_jax(self, world, monkeypatch):
        orig = jzero._shard_map
        params = inspect.signature(orig).parameters

        def shard_map(*args, check_rep=None, **kw):
            if check_rep is not None:
                kw["check_rep" if "check_rep" in params
                   else "check_vma"] = check_rep
            return orig(*args, **kw)

        monkeypatch.setattr(jzero, "_shard_map", shard_map)
        net = _jax_net()
        opt = paddle.optimizer.Adam(learning_rate=ranks.LR,
                                    parameters=net.parameters())
        step = jzero.zero_train_step(net, opt, stage=2, dp=2)
        p, st = step.init_state()
        for t in range(1, 4):
            loss, p, st = step(p, st, (X, Y), ranks.LR, t)
        port = world["dp2 stage2"]
        assert abs(float(loss) - port["losses"][-1]) <= 1e-5 * abs(
            float(loss))
        for k, v in p.items():
            ref = np.asarray(v)
            got = port["params"][k]
            got = got.T if k.endswith("weight") else got
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)


def _mlp():
    return ranks.mlp(_weights())


class TestValidation:
    """The refusals, in the test process (a world of one rank)."""

    def test_stage3_refused_with_pointer_to_gspmd(self):
        net = _mlp()
        with pytest.raises(ValueError, match="p_g_os"):
            Z.zero_train_step(net, Adam(parameters=net.parameters()),
                              stage=3)

    def test_global_norm_clip_refused(self):
        net = _mlp()
        opt = Adam(parameters=net.parameters(),
                   grad_clip=ClipGradByGlobalNorm(1.0))
        with pytest.raises(NotImplementedError, match="norm"):
            Z.zero_train_step(net, opt, stage=1)

    def test_non_elementwise_optimizer_refused(self):
        net = _mlp()
        with pytest.raises(NotImplementedError, match="Lamb"):
            Z.zero_train_step(net, Lamb(parameters=net.parameters()),
                              stage=1)

    def test_accum_needs_dp_sharded_batch(self):
        net = _mlp()
        with pytest.raises(ValueError, match="grad_accum"):
            Z.zero_train_step(net, Adam(parameters=net.parameters()),
                              stage=1, grad_accum=2,
                              batch_specs=("dp", None))

    def test_batch_that_does_not_split_refused(self):
        net = _mlp()
        step = Z.zero_train_step(net, Adam(parameters=net.parameters()),
                                 stage=1, grad_accum=3)
        p, st = step.init_state()
        with pytest.raises(ValueError, match="does not split"):
            step(p, st, (torch.from_numpy(X), torch.from_numpy(Y)), 0.01, 1)

    def test_buckets_at_stage0_refused(self):
        net = _mlp()
        for kw in (dict(bucket_bytes=1024), dict(overlap=True)):
            with pytest.raises(ValueError, match="stage 0"):
                Z.zero_train_step(net, Adam(parameters=net.parameters()),
                                  stage=0, **kw)

    def test_tp_and_group_sharded_name_fleet(self):
        net = _mlp()
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            Z.zero_train_step(net, Adam(parameters=net.parameters()), tp=2)
        for cls in (Z.GroupShardedStage2, Z.GroupShardedStage3,
                    Z.GroupShardedOptimizerStage2):
            with pytest.raises(NotImplementedError, match="queue 1 item 5"):
                cls(net)
        for fn in (Z.group_sharded_parallel, Z.save_group_sharded_model):
            with pytest.raises(NotImplementedError, match="queue 1 item 5"):
                fn(net)

    def test_one_rank_world_runs_the_stage0_step(self):
        """Without a process group dp is 1 and stage 2 is stage 0."""
        out = {}
        for stage in (0, 2):
            net = _mlp()
            step = Z.zero_train_step(net, Adam(learning_rate=ranks.LR,
                                               parameters=net.parameters()),
                                     stage=stage)
            p, st = step.init_state()
            for t in (1, 2):
                loss, p, st = step(p, st, (torch.from_numpy(X),
                                           torch.from_numpy(Y)), ranks.LR, t)
            out[stage] = (float(loss), p)
        assert out[0][0] == out[2][0]
        assert all(torch.equal(out[0][1][k], out[2][1][k]) for k in out[0][1])


class TestProbes:
    def test_probes_and_describe(self, world):
        r = world["probes"]
        assert len(r["collective"]) == 2 and all(s > 0
                                                 for s in r["collective"])
        assert set(r["comm"]) == {"reduce_scatter", "all_gather"}
        assert all(s > 0 for s in r["comm"].values())
        assert set(r["shard"]) == {"0", "1"}
        assert 0.0 <= r["overlap"] <= 1.0
        d = r["describe"]
        assert (d["dp"], d["stage"], d["buckets"], d["overlap"]) == (
            2, 2, 4, True)
        assert d["overlap_fraction"] == r["overlap"]

    def test_overlap_probe_needs_a_bucket_layout(self):
        net = _mlp()
        step = Z.zero_train_step(net, Adam(parameters=net.parameters()),
                                 stage=1)
        step.init_state()
        with pytest.raises(RuntimeError, match="bucket layout"):
            step.measure_overlap_fraction()
