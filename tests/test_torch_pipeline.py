"""The port's pipeline parallelism (fleet.meta_parallel.pipeline_parallel:
`PipelineLayer`, `PipelineParallel` with the 1F1B chains and the
interleaved layout; `spmd_pipeline`; GPT's pipe layers and
`gpt_spmd_pipeline_fn`) held against the JAX package (counterpart of
tests/test_fleet_hybrid.py :125-231 and tests/test_spmd_pipeline.py).

Two regimes:

- one process (no world joined) holds every stage, as the reference's
  single controller: the reference tests' MLP pipelines, at 2 stages and
  at 2 stages x 2 chunks, against the JAX `PipelineParallel` on the same
  weights (SGD; loss and parameters within rtol 2e-4 / atol 1e-5, the
  reference's own bound);
- one world of four gloo ranks (a module-scoped fixture; rank bodies in
  tests/_torch_fleet_ranks.py, no JAX there) runs GPT's pipe layers
  (`GPTConfig.tiny()`, fp32, dropout 0, Adam) at pp 2 x dp 2: the loss and
  every parameter bit for bit equal to the single-rank step that
  accumulates the same micro-batches in the engine's order; the
  interleaved engine (2 stages x 2 chunks) the same bits; pp 2 x mp 2
  with the tensor-parallel pipe layers, one SGD step, within 1e-7 of it
  (fp32 rounding of the mp sums, times lr 0.01) and its hybrid global
  gradient norm within rtol 1e-5 of the dense one; the first loss within
  rtol 1e-5 of the JAX pipe layers' loss on the same weights; the SPMD pipeline over 4 stages
  against the JAX sequential model (loss rtol 1e-5, gradients rtol 1e-4
  / atol 1e-5, the reference's bounds) and GPT's SPMD pipeline at pp 2 x
  dp 2 against the JAX model's logits (atol 2e-4, the reference's); a
  layer shared by both stages, its gradient summed over them, within
  1e-6 of the model held whole in one process.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fleet_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed.fleet import (CommunicateTopology as JTopo,
                                          DistributedStrategy as JStrategy,
                                          HybridCommunicateGroup as JHCG)
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
from paddle_tpu.models.gpt import gpt_pipe_layers as jgpt_pipe_layers

from paddle_tpu_torch import distributed as ptd
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
from paddle_tpu_torch.nn import torch_functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.weights import load_reference_state

_F = 8


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_cfg():
    cfg = JGPTConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _stage_fn(params, x):
    return x + jnp.tanh(x @ params["w1"]) @ params["w2"]


@functools.lru_cache(maxsize=None)
def _oracle():
    data, ref = {}, {}
    rng = np.random.RandomState(4)
    # GPT's pipe layers and the loss of the whole list on the batch
    paddle.seed(2025)
    cfg = _jax_cfg()
    pipe = jmp.PipelineLayer(jgpt_pipe_layers(cfg), num_stages=1,
                             loss_fn=JCriterion())
    gp, _ = extract_state(pipe)
    ids = rng.randint(0, cfg.vocab_size, (8, 16))
    loss = jax.jit(lambda p: JCriterion()(
        call_functional(pipe, p, {}, (jnp.asarray(ids),),
                        training=False)[0], jnp.asarray(ids))._data)(gp)
    ref["gpt_loss"] = float(loss)
    data.update(gpt=_np_tree(gp), ids=ids)
    # the SPMD pipeline's stage weights and the sequential model
    r = np.random.default_rng(0)
    params = {"w1": r.standard_normal((4, _F, 16)).astype(np.float32) * 0.3,
              "w2": r.standard_normal((4, 16, _F)).astype(np.float32) * 0.3}
    x = r.standard_normal((16, _F)).astype(np.float32)
    y = r.standard_normal((16, _F)).astype(np.float32)

    def seq_loss(p, xx):
        for s in range(4):
            xx = _stage_fn({k: v[s] for k, v in p.items()}, xx)
        return jnp.mean((xx - y) ** 2)

    loss, (gp_, gx) = jax.jit(jax.value_and_grad(seq_loss, argnums=(0, 1)))(
        params, x)
    ref["spmd"] = (float(loss), _np_tree(gp_), np.asarray(gx))
    data.update(spmd=params, spmd_x=x, spmd_y=y)
    # GPT's model forward with the tied head
    paddle.seed(0)
    model = JGPTModel(_jax_cfg())
    mp, _ = extract_state(model)
    sids = np.random.RandomState(0).randint(0, 1024, (8, 16))
    hid = jax.jit(lambda p: call_functional(
        model, p, {}, (jnp.asarray(sids),), training=False)[0])(mp)
    ref["gpt_spmd"] = np.asarray(hid) @ np.asarray(mp["wte.weight"]).T
    data.update(gpt_model=_np_tree(mp), spmd_ids=sids)
    return data, ref


@pytest.fixture(scope="module")
def every_rank():
    data, _ = _oracle()
    return ptd.spawn(ranks.pipeline_rank, (data,), nprocs=4, device="cpu",
                     timeout=240)


@pytest.fixture(scope="module")
def world(every_rank):
    return every_rank[0]


# ------------------------------------------- one process, every stage
def _ce(out, y):
    return F.cross_entropy(out, y.reshape(-1))


def _pair(build, vpp=None, accumulate=2):
    """The JAX engine and the port's on the same MLP weights."""
    topo = [2, 1, 1, 1, 1]
    jlayers = build()
    jpipe = jmp.PipelineLayer([jmp.LayerDesc(l) for l in jlayers],
                              num_stages=2, loss_fn=jnn.CrossEntropyLoss(),
                              num_virtual_pipeline_stages=vpp)
    jst = JStrategy()
    jst.pipeline_configs = {"accumulate_steps": accumulate}
    jengine = jmp.PipelineParallel(
        jpipe, JHCG(JTopo(dims=topo), global_rank=0), jst)
    torch_layers = []
    for layer in jlayers:
        p, _ = extract_state(layer)
        if p:
            lin = torch.nn.Linear(*np.asarray(p["weight"]).shape)
            load_reference_state(lin, _np_tree(p))
            torch_layers.append(lin)
        else:
            torch_layers.append(torch.nn.ReLU())
    pipe = mpl.PipelineLayer([mpl.LayerDesc(l) for l in torch_layers],
                             num_stages=2, loss_fn=_ce,
                             num_virtual_pipeline_stages=vpp)
    st = fleet.DistributedStrategy()
    st.pipeline_configs = {"accumulate_steps": accumulate}
    engine = mpl.PipelineParallel(
        pipe, fleet.HybridCommunicateGroup(fleet.CommunicateTopology(
            dims=topo), global_rank=0), st)
    return jengine, jpipe, engine, pipe


def _mlp(seed, widths):
    paddle.seed(seed)
    layers = []
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        if i:
            layers.append(jnn.ReLU())
        layers.append(jnn.Linear(a, b))
    return layers


def _train_both(jengine, jpipe, engine, pipe, x, y, steps=2):
    jopt = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=jpipe.parameters())
    opt = SGD(learning_rate=0.05, parameters=pipe.parameters())
    for _ in range(steps):
        jl = jengine.train_batch((paddle.to_tensor(x), paddle.to_tensor(y)),
                                 jopt)
        tl = engine.train_batch((torch.from_numpy(x), torch.from_numpy(y)),
                                opt)
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=2e-4)
    theirs = {k: np.asarray(v.numpy()) for k, v in jpipe.named_parameters()}
    for k, v in pipe.named_parameters():
        got = v.detach().numpy()
        np.testing.assert_allclose(got.T if k.endswith("weight") else got,
                                   theirs[k], rtol=2e-4, atol=1e-5)


def test_pipeline_parallel_matches_the_reference_engine():
    engines = _pair(lambda: _mlp(7, [8, 16, 16, 4]), accumulate=4)
    rng = np.random.RandomState(3)
    _train_both(*engines, rng.rand(8, 8).astype("float32"),
                rng.randint(0, 4, (8, 1)))


def test_pipeline_vs_single_process_sgd():
    engines = _pair(lambda: _mlp(11, [6, 12, 3]))
    rng = np.random.RandomState(5)
    _train_both(*engines, rng.rand(4, 6).astype("float32"),
                rng.randint(0, 3, (4, 1)))


def test_interleaved_vpp_matches_the_reference_engine():
    engines = _pair(lambda: _mlp(13, [6, 12, 12, 3]), vpp=2)
    pipe = engines[3]
    assert pipe.num_chunks == 4
    assert [pipe.chunk_to_stage(c) for c in range(4)] == [0, 1, 0, 1]
    assert pipe.stage_layers[0] == pipe.chunk_layers[0] + \
        pipe.chunk_layers[2]
    rng = np.random.RandomState(6)
    _train_both(*engines, rng.rand(4, 6).astype("float32"),
                rng.randint(0, 3, (4, 1)))


def test_vpp_too_few_layers_raises():
    with pytest.raises(ValueError, match="virtual"):
        mpl.PipelineLayer([mpl.LayerDesc(torch.nn.Linear, 4, 4)] * 3,
                          num_stages=2, num_virtual_pipeline_stages=2)


def test_segment_by_layer_name_and_stage_of_index():
    descs = [mpl.LayerDesc(torch.nn.Linear, 4, 4), mpl.LayerDesc(
        torch.nn.ReLU)] * 4
    pipe = mpl.PipelineLayer(descs, num_stages=2, seg_method="layer:Linear")
    jpipe = jmp.PipelineLayer([jmp.LayerDesc(jnn.Linear, 4, 4),
                               jmp.LayerDesc(jnn.ReLU)] * 4, num_stages=2,
                              seg_method="layer:Linear")
    assert pipe._segments == jpipe._segments
    assert [pipe.get_stage_from_index(i) for i in range(8)] == \
        [jpipe.get_stage_from_index(i) for i in range(8)]


def test_shared_layer_is_one_module_in_a_process():
    shared = mpl.SharedLayerDesc("emb", torch.nn.Linear, None, "weight",
                                 4, 4)
    pipe = mpl.PipelineLayer([shared, mpl.LayerDesc(torch.nn.ReLU), shared],
                             num_stages=1)
    assert pipe._all_layers[0] is pipe._all_layers[2]


# ------------------------------------------------------- the world of four
def test_pp2_dp2_equals_the_single_rank_accumulated_step(every_rank):
    for r in every_rank:
        leg = r["pp2dp2"]
        assert leg["losses"] == leg["ref_losses"]
        assert leg["keys"] and all(leg["equal"].values()), leg["equal"]
        # ranks 0, 1 hold stage 0 (embeddings, a block), 2, 3 stage 1
        assert leg["stage"] == r["rank"] // 2
    assert {k.split(".")[0] for k in every_rank[0]["pp2dp2"]["keys"]} == \
        {"0", "1"}


def test_first_loss_equals_the_reference_pipe_layers(world):
    _, ref = _oracle()
    np.testing.assert_allclose(world["pp2dp2"]["losses"][0], ref["gpt_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(world["pp2mp2"]["losses"][0],
                               ref["gpt_loss"], rtol=1e-5)


def test_eval_batch_gives_the_loss_on_every_stage(every_rank):
    assert len({r["eval"] for r in every_rank}) == 1
    assert np.isfinite(every_rank[0]["eval"])


def test_interleaved_equals_the_plain_engine(every_rank):
    for r in every_rank:
        assert r["vpp"]["losses"] == r["pp2dp2"]["losses"]
        assert all(r["vpp"]["equal"].values())
        assert r["vpp"]["chunks"] == [r["rank"] // 2, r["rank"] // 2 + 2]


def test_pp2_mp2_tensor_parallel_pipe(every_rank):
    for r in every_rank:
        leg = r["pp2mp2"]
        np.testing.assert_allclose(leg["losses"], leg["ref_losses"],
                                   rtol=1e-6)
        # the hybrid clip's global norm: mp-split parameters summed over
        # mp, replicated ones (norms, biases, wpe) once, stages summed
        np.testing.assert_allclose(leg["norms"], leg["ref_norms"], rtol=1e-5)
        assert max(leg["err"].values()) <= 1e-7, leg["err"]
        assert leg["seeded"]


def test_shared_layer_across_stages(every_rank):
    for r in every_rank:
        assert r["shared"]["stage"] == r["rank"] // 2
        assert r["shared"]["err"] <= 1e-6


def test_spmd_pipeline_matches_sequential_fwd_bwd(every_rank):
    _, ref = _oracle()
    loss, grads, gx = ref["spmd"]
    for r in every_rank:
        np.testing.assert_allclose(r["spmd"]["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["spmd"]["gx"], gx, rtol=1e-4,
                                   atol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(r["spmd"]["grads"][k], g[r["rank"]],
                                       rtol=1e-4, atol=1e-5)


def test_gpt_spmd_pipeline_matches_model_forward(every_rank):
    _, ref = _oracle()
    for r in every_rank:
        np.testing.assert_allclose(r["gpt_spmd"]["logits"], ref["gpt_spmd"],
                                   rtol=2e-4, atol=2e-4)
        assert r["gpt_spmd"]["finite"] and r["gpt_spmd"]["live"]
