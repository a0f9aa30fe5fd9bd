"""The port's fleet surface (paddle_tpu_torch.distributed.fleet: the
topology, fleet.init, the mp layers, sequence parallelism, the hybrid
clip, tensor-parallel GPT, ZeroTrainStep at tp 2) and F4's fixed-order
embedding backward, held against the JAX package (counterpart of
tests/test_fleet_hybrid.py :35, :73, :94, :436, :453, :512,
tests/test_distributed.py :168, :180, :195, tests/test_zero.py
TestTpComposition and tests/test_zero_bucket.py TestTpOverlapComposition).

One world of four gloo ranks runs every multi-rank leg once (a
module-scoped fixture; the rank body is tests/_torch_fleet_ranks.py,
which imports no JAX), at fleet's dp 2 x mp 2 (mp groups {0, 1} and
{2, 3}); the ZeRO legs carve dp 2 x tp 2 from the world. The JAX
references are computed once a module in this process, in fp32 with
dropout off, on the weights the ranks load (`load_reference_state`, each
rank its shard).

Tolerances: the mp layers, the embedding, the cross entropy and the
sequence-parallel linears within rtol 1e-5 / atol 1e-6 of the JAX dense
function (the mp sums reorder fp32 additions); tensor-parallel GPT's
hidden states within atol 2e-5 and every gradient within rtol 1e-4 /
atol 1e-5 x its largest magnitude (the output gradient is N(0, 1) a
token, so the bias gradients reach ~400); the clipped SGD parameters
within rtol 2e-4 / atol 1e-6 (the reference's own bound); ZeroTrainStep at dp 2 x tp 2: stages 1, 2 and
the overlapped stage 2 bit-identical to stage 0, and stage 0 within rtol
1e-4 / atol 2e-5 of the JAX ZeroTrainStep (Adam's first steps scale a
gradient to about lr * sign(g)). The embedding backward equals
`torch.nn.functional.embedding`'s within fp32 rounding (rtol 1e-6 /
atol 1e-5 at sums of up to 300 rows).
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fleet_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet import (CommunicateTopology as JTopo,
                                          HybridCommunicateGroup as JHCG)
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.parallel import zero as jzero
from paddle_tpu.parallel.mesh import (TP_AXIS, copy_to_tp_region,
                                      reduce_from_tp_region)

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
from paddle_tpu_torch.nn import torch_functional as F
from paddle_tpu_torch.ops import embedding as E

RTOL, ATOL = 1e-5, 1e-6
_rng = np.random.RandomState(0)


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _vjp(layer, params, x, gy):
    """(output, d params, d x) of a JAX layer in eval mode, jitted (op by
    op each primitive would compile on its own)."""
    def f(p, xx, g):
        y, pull = jax.vjp(lambda p_, x_: call_functional(
            layer, p_, {}, (x_,), training=False)[0], p, xx)
        return (y,) + pull(g)

    y, dp, dx = jax.jit(f)(params, x, jnp.asarray(gy))
    return np.asarray(y), _np_tree(dp), np.asarray(dx)


@functools.lru_cache(maxsize=None)
def _oracle():
    """Every JAX reference and the ranks' inputs, once a module."""
    data, ref = {}, {}
    # the Megatron MLP (dense in JAX outside a mesh)
    paddle.seed(0)

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jmp.ColumnParallelLinear(16, 32, gather_output=False)
            self.fc2 = jmp.RowParallelLinear(32, 8, input_is_parallel=True)

        def forward(self, x):
            return self.fc2(jnn.functional.relu(self.fc1(x)))

    mlp = MLP()
    p, _ = extract_state(mlp)
    x = _rng.rand(4, 16).astype("float32")
    gy = _rng.randn(4, 8).astype("float32")
    data.update(mlp=_np_tree(p), mlp_x=x, mlp_gy=gy)
    ref["mlp"] = _vjp(mlp, p, jnp.asarray(x), gy)
    # the vocab-parallel embedding: ids 0 and 40 repeated, both halves
    paddle.seed(1)
    emb = jmp.VocabParallelEmbedding(64, 8)
    p, _ = extract_state(emb)
    ids = _rng.randint(0, 64, (2, 10))
    ids[0, :4] = 0
    ids[1, :3] = 40
    egy = _rng.randn(2, 10, 8).astype("float32")
    y, dw, _ = _vjp(emb, p, jnp.asarray(ids), egy)
    ref["emb"] = (y, dw["weight"])
    data.update(emb_w=np.asarray(p["weight"]), emb_ids=ids, emb_gy=egy)
    # vocab-parallel cross entropy against paddle's cross entropy
    logits = (_rng.randn(12, 32) * 3).astype("float32")
    labels = _rng.randint(0, 32, (12,))
    labels[3] = -100
    ce = jmp.ParallelCrossEntropy()

    def ce_of(lg):
        out = call_functional(ce, {}, {}, (lg, jnp.asarray(labels)),
                              training=False)[0]
        return out.sum(), out

    (_, loss), dlogits = jax.jit(jax.value_and_grad(ce_of, has_aux=True))(
        jnp.asarray(logits))
    ref["ce"] = (np.asarray(loss), np.asarray(dlogits))
    data.update(ce_logits=logits, ce_labels=labels)
    # the sequence-parallel linears
    paddle.seed(13)
    col = jmp.ColumnSequenceParallelLinear(8, 16, gather_output=False)
    row = jmp.RowSequenceParallelLinear(16, 8, input_is_parallel=True)
    sx = _rng.rand(2, 12, 8).astype("float32")
    pc, _ = extract_state(col)
    pr, _ = extract_state(row)

    def sp_loss(pc_, pr_, xx):
        h = call_functional(col, pc_, {}, (xx,), training=False)[0]
        out = call_functional(row, pr_, {}, (h,), training=False)[0]
        return (out ** 2).sum(), out

    (_, sy), grads = jax.jit(jax.value_and_grad(
        sp_loss, argnums=(0, 1, 2), has_aux=True))(pc, pr, jnp.asarray(sx))
    ref["sp"] = (np.asarray(sy), _np_tree(grads[0]), _np_tree(grads[1]),
                 np.asarray(grads[2]))
    data.update(sp={"col": _np_tree(pc), "row": _np_tree(pr)}, sp_x=sx)
    # the hybrid clip: three clipped SGD steps of the dense MLP
    paddle.seed(11)
    net = MLP()
    data["clip_mlp"] = _np_tree(extract_state(net)[0])
    cx = (_rng.rand(8, 16) * 4).astype("float32")
    cy = _rng.rand(8, 8).astype("float32")
    opt = paddle.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.05))

    @jax.jit
    def clipped_step(p, state, t):
        grads = jax.grad(lambda p_: jnp.mean((call_functional(
            net, p_, {}, (jnp.asarray(cx),), training=False)[0]
            - jnp.asarray(cy)) ** 2))(p)
        return opt.functional_step(p, grads, state, jnp.float32(0.1), t)

    cp, _ = extract_state(net)
    state = opt.functional_state(cp)
    for t in range(1, 4):
        cp, state = clipped_step(cp, state, jnp.int32(t))
    ref["clip"] = _np_tree(cp)
    data.update(clip_x=cx, clip_y=cy)
    # GPT (dense: the reference's TP model is the same function)
    paddle.seed(2025)
    cfg = JGPTConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    gpt = JGPTModel(cfg)
    gp, _ = extract_state(gpt)
    gids = _rng.randint(0, cfg.vocab_size, (2, 16))
    ggy = _rng.randn(2, 16, cfg.hidden_size).astype("float32")
    h, dgp, _ = _vjp(gpt, gp, jnp.asarray(gids), ggy)
    ref["gpt"] = (h, dgp)
    data.update(gpt=_np_tree(gp), gpt_ids=gids, gpt_gy=ggy)
    # ZeroTrainStep at dp 2 x tp 2
    r3 = np.random.RandomState(3)
    full = {"w1": r3.randn(16, 32).astype("float32"),
            "w2": r3.randn(32, 8).astype("float32")}
    tx = np.random.RandomState(0).randn(32, 16).astype("float32")
    ty = np.random.RandomState(1).randn(32, 8).astype("float32")
    data.update(tp_full={k: v.T.copy() for k, v in full.items()},
                tp_x=tx, tp_y=ty)
    ref["zero_tp"] = (full, tx, ty)
    return data, ref


@pytest.fixture(scope="module")
def every_rank():
    data, _ = _oracle()
    return ptd.spawn(ranks.fleet_rank, (data,), nprocs=4, device="cpu",
                     timeout=240)


@pytest.fixture(scope="module")
def world(every_rank):
    return every_rank[0]


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


# ------------------------------------------------------------- topology
def test_communicate_topology():
    for T in (fleet.CommunicateTopology, JTopo):
        topo = T(["pp", "dp", "sharding", "sep", "mp"], [2, 2, 1, 1, 2])
        assert topo.world_size() == 8
        assert topo.get_rank(pp=1, dp=0, sharding=0, sep=0, mp=1) == 5
        assert topo.get_coord(5) == (1, 0, 0, 0, 1)
        assert [0, 1] in topo.get_comm_list("mp")
        assert len(topo.get_comm_list("mp")) == 4
        assert [0, 4] in topo.get_comm_list("pp")
    mine = fleet.CommunicateTopology(dims=[2, 2, 1, 1, 2])
    theirs = JTopo(dims=[2, 2, 1, 1, 2])
    for axis in ("pp", "dp", "sharding", "sep", "mp"):
        assert mine.get_comm_list(axis) == theirs.get_comm_list(axis)
        assert mine.get_axis_list(axis, 0) == theirs.get_axis_list(axis, 0)
    assert mine.get_rank_from_stage(5, pp=0) == theirs.get_rank_from_stage(
        5, pp=0)


def test_hcg_accessors():
    topo = fleet.CommunicateTopology(["pp", "dp", "sharding", "sep", "mp"],
                                     [2, 2, 1, 1, 2])
    hcg = fleet.HybridCommunicateGroup(topo, global_rank=5)
    ref = JHCG(JTopo(["pp", "dp", "sharding", "sep", "mp"],
                     [2, 2, 1, 1, 2]), global_rank=5)
    for name in ("get_stage_id", "get_model_parallel_rank",
                 "get_data_parallel_rank", "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size", "is_first_stage",
                 "is_last_stage", "get_parallel_mode",
                 "get_sharding_parallel_world_size",
                 "get_data_parallel_group_src_rank",
                 "get_model_parallel_group_src_rank"):
        assert getattr(hcg, name)() == getattr(ref, name)(), name
    g = hcg.get_model_parallel_group()
    assert g.axis_name == "mp" and g.nranks == 2 and g.ranks == [4, 5]
    assert hcg.get_p2p_groups().ranks == [1, 5]
    assert hcg.get_rank_from_stage(0) == ref.get_rank_from_stage(0)


def test_fleet_init(world):
    h = world["hcg"]
    assert h["mode"] == "hybrid" and h["axis"] == "mp"
    assert h["dp"] == (0, [0, 2]) and h["mp"] == (0, [0, 1])
    assert h["pp"] == [0] and h["same"] and h["strategy"]


def test_fleet_init_takes_the_world_and_checks_the_degrees():
    s = fleet.DistributedStrategy()
    hcg = fleet.init(strategy=s)        # a world of one: every degree 1
    assert hcg.get_parallel_mode() == "single"
    assert fleet.worker_num() == 1 and fleet.is_first_worker()
    s.hybrid_configs = {"mp_degree": 2}
    with pytest.raises(ValueError, match="world has 1"):
        fleet.init(strategy=s)


def test_distributed_model_data_branch_names_item_5b(world):
    """The branch item 5b brought: pure data parallelism returns a
    DataParallel over the hcg's dp group (it was refused before)."""
    assert world["dp_branch"] == ("DataParallel", True)


def test_strategy_fields_match_the_reference():
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS

    mine, theirs = fleet.DistributedStrategy(), JS()
    assert vars(mine).keys() == vars(theirs).keys()
    mine.hybrid_configs = {"dp_degree": 4}
    assert mine.hybrid_configs["mp_degree"] == 1
    assert repr(mine) == ("DistributedStrategy(dp=4, mp=1, pp=1, "
                          "sharding=1, sep=1)")


# ------------------------------------------------------------ mp layers
def test_tp_layers_match_dense(every_rank):
    _, ref = _oracle()
    y, dp, dx = ref["mlp"]
    for r in every_rank:
        _close(r["mlp"]["y"], y)
        _close(r["mlp"]["gx"], dx)
        _close(r["gathered_forms"], y)
        for k, g in dp.items():
            got = r["mlp"]["grads"][k]
            _close(got.T if k.endswith("weight") else got, g)


def test_vocab_parallel_embedding(every_rank):
    _, ref = _oracle()
    y, dw = ref["emb"]
    for r in every_rank:
        assert r["emb"]["rows"] == 32
        assert r["emb"]["start"] == 32 * (r["rank"] % 2)
        _close(r["emb"]["y"], y)
        _close(r["emb"]["grad"], dw)


def test_parallel_cross_entropy(every_rank):
    _, ref = _oracle()
    loss, grad = ref["ce"]
    for r in every_rank:
        _close(r["ce"]["loss"], loss)
        _close(r["ce"]["grad"], grad)
        assert r["ce"]["loss"][3] == 0.0          # ignore_index


def test_rng_states_tracker():
    tr = mpl.RNGStatesTracker(device="cpu")
    with tr.rng_state("model-parallel-rng") as g:
        a = torch.rand(4, generator=g)
    with tr.rng_state("model-parallel-rng") as g:
        b = torch.rand(4, generator=g)
    assert not torch.equal(a, b)              # one stream, two draws
    torch.manual_seed(5)
    c = torch.rand(4)
    torch.manual_seed(5)
    assert torch.equal(c, torch.rand(4))      # the default one untouched
    mpl.model_parallel_random_seed(3, device="cpu")
    t = mpl.get_rng_state_tracker()
    assert set(t.get_states_tracker()) == {"global_seed",
                                          "model-parallel-rng"}
    with pytest.raises(ValueError, match="exists"):
        t.add("global_seed", 1, device="cpu")
    with pytest.raises(KeyError, match="model_parallel_random_seed"):
        mpl.RNGStatesTracker().generator("global_seed")


def test_sequence_parallel_linears_match_dense(every_rank):
    _, ref = _oracle()
    y, gcol, grow, gx = ref["sp"]
    for r in every_rank:
        _close(r["sp"]["y"], y)
        _close(r["sp"]["gx"], gx)
        for prefix, grads in (("col", gcol), ("row", grow)):
            for k, g in grads.items():
                got = r["sp"]["grads"][f"{prefix}.{k}"]
                _close(got.T if k == "weight" else got, g)


# ----------------------------------------------------- hybrid clip
def test_hybrid_clip_grad_tp_matches_dense(every_rank):
    _, ref = _oracle()
    for r in every_rank:
        assert r["clip"]["kind"] == "HybridParallelClipGrad"
        for k, v in ref["clip"].items():
            got = r["clip"]["params"][k]
            np.testing.assert_allclose(got.T if k.endswith("weight")
                                       else got, v, rtol=2e-4, atol=1e-6,
                                       err_msg=k)


def test_hybrid_clip_sums_split_norms_over_mp(world):
    # global norm sqrt(4 * 1 + 4): mp-split ones counted on both ranks,
    # the replicated 2.0 once
    d, r = world["clip_psum"]
    expect = 1.0 / np.sqrt(8.0)
    np.testing.assert_allclose(d, np.full(2, expect), rtol=1e-6)
    np.testing.assert_allclose(r, np.full(1, 2 * expect), rtol=1e-6)


# ------------------------------------------------- tensor-parallel GPT
def test_tensor_parallel_gpt_matches_the_reference(every_rank):
    _, ref = _oracle()
    h, grads = ref["gpt"]
    lin = ("qkv.weight", "out.weight", "ffn_in.weight", "ffn_out.weight")
    for r in every_rank:
        assert r["gpt"]["heads"] == 2               # 4 heads over mp 2
        np.testing.assert_allclose(r["gpt"]["h"], h, atol=2e-5)
        for k, g in grads.items():
            got = r["gpt"]["grads"][k]
            got = got.T if k.endswith(lin) else got
            np.testing.assert_allclose(got, g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)


def test_tensor_parallel_gpt_holds_the_dense_slices(every_rank):
    assert all(r["gpt_seeded_slices"] for r in every_rank)


def test_tensor_parallel_gpt_dropout_streams(every_rank):
    for r in every_rank:
        assert r["gpt_dropout"]["finite"]
        assert r["gpt_dropout"]["same_on_mp"]


# --------------------------------------------- ZeroTrainStep at tp 2
def _jax_zero_tp(stage, monkeypatch, **kw):
    orig = jzero._shard_map
    params = inspect.signature(orig).parameters

    def shard_map(*args, check_rep=None, **k):
        if check_rep is not None:
            k["check_rep" if "check_rep" in params else "check_vma"] = \
                check_rep
        return orig(*args, **k)

    monkeypatch.setattr(jzero, "_shard_map", shard_map)
    full, x, y = _oracle()[1]["zero_tp"]
    from jax.sharding import PartitionSpec as P

    def loss_fn(params, xx, yy):
        h = jax.nn.relu(copy_to_tp_region(xx) @ params["w1"])
        out = reduce_from_tp_region(h @ params["w2"])
        return jnp.mean((out - yy) ** 2)

    opt = paddle.optimizer.Adam(learning_rate=0.01,
                                parameters=jnn.Linear(2, 2).parameters())
    step = jzero.ZeroTrainStep(None, opt, loss_fn, stage=stage, dp=2, tp=2,
                               param_specs={"w1": P(None, TP_AXIS),
                                            "w2": P(TP_AXIS, None)}, **kw)
    p, st = step.init_state(full)
    for t in range(1, 4):
        loss, p, st = step(p, st, (x, y), 0.01, t)
    return float(loss), {k: np.asarray(jax.device_put(
        v, jax.sharding.NamedSharding(step.mesh, P())))
        for k, v in p.items()}


class TestTpComposition:
    @pytest.mark.parametrize("leg", ["stage1", "stage2", "stage2 overlap"])
    def test_dp2_tp2_parity_and_bytes(self, every_rank, leg):
        for r in every_rank:
            assert r[leg]["losses"] == r["stage0"]["losses"]
            for k, v in r["stage0"]["params"].items():
                assert np.array_equal(r[leg]["params"][k], v), (leg, k)
            assert r[leg]["opt_bytes"] * 2 == r["stage0"]["opt_bytes"]

    def test_tp_parts_and_full_logical_state(self, world):
        assert world["stage1"]["local"] == (16, 16)     # w1 (32, 16) / tp
        s0, s1 = world["stage0"]["saved"], world["stage1"]["saved"]
        assert s1["w1"]["moment1"].shape == (32, 16)
        for k in s0:
            for slot in s0[k]:
                assert np.array_equal(s0[k][slot], s1[k][slot]), (k, slot)

    def test_dp2_tp2_matches_jax(self, world, monkeypatch):
        loss, params = _jax_zero_tp(2, monkeypatch)
        port = world["stage2"]
        assert abs(loss - port["losses"][-1]) <= 1e-5 * abs(loss)
        for k, v in params.items():
            np.testing.assert_allclose(port["params"][k].T, v, rtol=1e-4,
                                       atol=2e-5)


# ------------------------------------------------- F4: the embedding
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_backward_equals_torch(dtype):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(50, 8, generator=g).to(dtype).requires_grad_(True)
    ids = torch.randint(0, 50, (4, 300), generator=g)
    ids[0] = 3                                 # one row, 300 + tokens
    ids[1, :7] = 49
    gy = torch.randn(4, 300, 8, generator=g).to(dtype)
    got, = torch.autograd.grad(F.embedding(ids, w), w, gy)
    w32 = w.detach().float().requires_grad_(True)
    want, = torch.autograd.grad(torch.nn.functional.embedding(ids, w32),
                                w32, gy.float())
    assert got.dtype == dtype
    # fp32: rounding of the reordered sum; bf16: the fp32 sum rounded once
    tol = dict(rtol=1e-6, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -8, atol=1e-6)
    torch.testing.assert_close(got.float(), want, **tol)
    # untouched rows stay zero, and two calls give the same bits
    assert not got[~torch.isin(torch.arange(50), ids)].any()
    again, = torch.autograd.grad(F.embedding(ids, w), w, gy)
    assert torch.equal(got, again)


def test_embedding_backward_sums_each_row_in_pieces_in_token_order():
    """The fixed order: a row's tokens in token order, in pieces of
    PIECE, the pieces in order (checked against that sum written out)."""
    g = torch.Generator().manual_seed(1)
    n = 3 * E.PIECE + 5
    ids = torch.zeros(n, dtype=torch.int64)
    gy = torch.randn(n, 4, generator=g)
    got = E.embedding_backward(gy, ids, 2)
    pieces = []
    for i in range(0, n, E.PIECE):
        acc = gy[i]
        for j in range(i + 1, min(i + E.PIECE, n)):
            acc = acc + gy[j]
        pieces.append(acc)
    want = pieces[0]
    for p in pieces[1:]:
        want = want + p
    assert torch.equal(got[0], want) and not got[1].any()
