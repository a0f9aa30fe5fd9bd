"""paddle_tpu_torch's GPT (models/gpt.py) against the JAX package's GPT on
the same weights (carried by `load_reference_state`) and the same batch.

The reference step is built from `call_functional`, `jax.value_and_grad`
and `Adam.functional_step`, as tests/test_torch_ernie.py does.
`GPTConfig.tiny()`, 2 layers, dropout 0 (the two packages' random streams
differ).

- parameter names equal to the reference's;
- fp32: logits within atol 1e-4; the shifted causal LM loss, plain and
  fused, within 1e-5; every parameter gradient within rtol 1e-4 / atol
  1e-5; the parameters after one Adam update within atol 1e-6;
- O1 bf16 on both sides: the loss within 2e-2 relative and the cosine of
  every gradient above 0.99, fused and unfused;
- causality, `start_pos` in its three forms, positions past the table,
  and `tensor_parallel=True` on one rank equal to the dense model.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.jit.functional import call_functional, extract_state
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion

from paddle_tpu_torch import amp
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, GPTModel,
                                     GPTPretrainingCriterion, init_caches)
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.training import make_causal_lm_train_step
from paddle_tpu_torch.weights import load_reference_state

LR = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls, fused):
    cfg = cls.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    cfg.fused_lm_loss = fused
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(fused):
    paddle.seed(2025)
    m = JGPT(_cfg(JGPTConfig, fused))
    m.train()
    return m


def _params(fused=False):
    params, _ = extract_state(_jax_model(fused))
    return {k: np.asarray(v) for k, v in params.items()}


def _port(fused=False, **kw):
    m = GPTForCausalLM(_cfg(GPTConfig, fused), device="cpu", **kw)
    load_reference_state(m, _params(fused))
    return m


def _batch():
    r = np.random.RandomState(5)
    return (r.randint(0, 1024, (B, S)).astype(np.int64),
            r.randint(0, 1024, (B, S)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_step(fused, o1):
    """(loss, grads, params after one Adam update) of the reference."""
    model = _jax_model(fused)
    params, buffers = extract_state(model)
    ids, labels = _batch()

    def loss_of(p):
        ctx = (jamp.auto_cast(level="O1", dtype="bfloat16") if o1
               else contextlib.nullcontext())
        with ctx:
            loss, _ = call_functional(model, p, buffers, (jnp.asarray(ids),),
                                      kwargs={"labels": jnp.asarray(labels)},
                                      training=True)
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    opt = paddle.optimizer.Adam(learning_rate=LR,
                                parameters=model.parameters())
    new, _ = opt.functional_step(params, grads, opt.functional_state(params),
                                 jnp.float32(LR), jnp.int32(1))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return float(loss), as_np(grads), as_np(new)


def _linear_names(model):
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def _port_step(fused, o1):
    model = _port(fused)
    model.train()
    ids, labels = _batch()
    ctx = amp.auto_cast(level="O1") if o1 else contextlib.nullcontext()
    with ctx:
        loss = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    lin = _linear_names(model)
    grads = {n: (p.grad.numpy().T if n in lin else p.grad.numpy())
             for n, p in model.named_parameters()}
    return model, loss.item(), grads


def test_parameter_names_match_the_reference():
    port = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    assert set(dict(port.named_parameters())) == set(_params())


def test_logits_match_jax():
    ids, _ = _batch()
    jm = _jax_model(False)
    jm.eval()
    try:
        ref = jm(paddle.to_tensor(ids)).numpy()
    finally:
        jm.train()
    with torch.no_grad():
        got = _port()(torch.from_numpy(ids)).numpy()
    assert got.shape == ref.shape == (B, S, 1024)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["loss", "fused loss"])
def test_fp32_step_matches_reference(fused):
    ref_loss, ref_grads, ref_new = _jax_step(fused, False)
    model, loss, grads = _port_step(fused, False)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=1e-5)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # one Adam update, both optimizers fed the reference's gradients
    lin = _linear_names(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = torch.from_numpy(np.array(ref_grads[name]))
            p.grad = g.t().contiguous() if name in lin else g
    Adam(learning_rate=LR, parameters=model.parameters()).step()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if name in lin else got,
                                   ref_new[name], rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["loss", "fused loss"])
def test_o1_bf16_step_matches_reference(fused):
    ref_loss, ref_grads, _ = _jax_step(fused, True)
    _, loss, grads = _port_step(fused, True)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
    for name, g in grads.items():
        r = ref_grads[name].astype(np.float64).ravel()
        gg = g.astype(np.float64).ravel()
        cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
        assert cos > 0.99, (name, cos)


def test_causal_lm_train_step_equals_the_step_by_hand():
    """make_causal_lm_train_step: O1 forward with labels, backward, one
    Adam update, gradients dropped; equal to the same step written out."""
    ids, labels = _batch()
    a, b = _port(True), _port(True)
    step = make_causal_lm_train_step(a, Adam(learning_rate=LR,
                                             parameters=a.parameters()))
    loss_a = step(torch.from_numpy(ids), torch.from_numpy(labels),
                  torch.Generator().manual_seed(0))
    opt_b = Adam(learning_rate=LR, parameters=b.parameters())
    b.train()
    with amp.auto_cast(level="O1"):
        loss_b = b(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss_b.backward()
    opt_b.step()
    assert float(loss_a) == float(loss_b.detach())
    assert all(p.grad is None for p in a.parameters())
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n


def test_criterion_equals_the_model_loss_and_the_reference():
    r = np.random.RandomState(3)
    logits = r.randn(2, 6, 11).astype(np.float32)
    labels = r.randint(0, 11, (2, 6))
    got = GPTPretrainingCriterion()(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    ref = JCriterion()(paddle.to_tensor(logits), paddle.to_tensor(labels))
    np.testing.assert_allclose(float(got), float(ref.numpy()), rtol=1e-6)
    assert float(got) == float(_port().loss(torch.from_numpy(logits),
                                            torch.from_numpy(labels)))


def test_causality():
    """Changing a later token moves no earlier position's logits
    (tests/test_attention_causality.py's check on the port)."""
    ids, _ = _batch()
    other = ids.copy()
    other[:, 15:] = (other[:, 15:] + 7) % 1024
    m = _port()
    with torch.no_grad():
        a = m(torch.from_numpy(ids)).numpy()
        b = m(torch.from_numpy(other)).numpy()
    np.testing.assert_array_equal(a[:, :15], b[:, :15])
    assert not np.allclose(a[:, 15:], b[:, 15:])


def test_start_pos_in_its_three_forms():
    """A host int (static cache), a (b,) tensor of per-row offsets (paged
    decode) and a (b, s) tensor of positions: each gives the positions the
    reference's arithmetic gives, and the cached logits equal the no-cache
    forward's at those positions."""
    m = _port()
    g = m.gpt
    cache = [None]
    steps = np.arange(3)
    np.testing.assert_array_equal(g._positions(3, cache, 5, "cpu").numpy(),
                                  (5 + steps)[None])
    np.testing.assert_array_equal(
        g._positions(3, cache, torch.tensor(4), "cpu").numpy(),
        (4 + steps)[None])
    np.testing.assert_array_equal(
        g._positions(3, cache, torch.tensor([2, 9], dtype=torch.int32),
                     "cpu").numpy(), np.array([[2, 3, 4], [9, 10, 11]]))
    flat = torch.tensor([[7, 0, 3, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(g._positions(4, cache, flat, "cpu").numpy(),
                                  flat.numpy())
    np.testing.assert_array_equal(g._positions(3, None, 5, "cpu").numpy(),
                                  steps[None])
    seq = np.random.RandomState(1).randint(0, 1024, (2, 12))
    with torch.no_grad():
        full = m(torch.from_numpy(seq))
        # the static cache: prefill 10, then token 10 at host int 10
        caches = init_caches(m, 2, 12)
        m(torch.from_numpy(seq[:, :10]), caches=caches, start_pos=0)
        step, _ = m(torch.from_numpy(seq[:, 10:11]), caches=caches,
                    start_pos=10)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, 10].numpy(),
                                   rtol=0, atol=2e-5)
        # the paged cache: row 1 one token behind row 0, a (b,) offset
        pc = PagedKVCache.for_model(m, num_pages=9, page_size=4)
        table = pc.page_table_array([pc.allocator.alloc_n(3)
                                     for _ in range(2)], 3)
        m(torch.from_numpy(seq[:, :9]), caches=pc.layer_views(table),
          start_pos=0)
        tok = torch.from_numpy(np.stack([seq[0, 9:10], seq[1, 8:9]]))
        out, _ = m(tok, caches=pc.layer_views(table),
                   start_pos=torch.tensor([9, 8], dtype=torch.int32))
        np.testing.assert_allclose(out[0, 0].numpy(), full[0, 9].numpy(),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(out[1, 0].numpy(), full[1, 8].numpy(),
                                   rtol=0, atol=2e-5)


def test_positions_past_the_table_take_its_last_row():
    """The serving engine parks dead rows at the table-overflow position;
    the lookup clamps it (F.embedding on the card would stop on it)."""
    m = _port()
    ids = torch.tensor([[5]])
    with torch.no_grad():
        past, _ = m(ids, caches=init_caches(m, 1, 1), start_pos=0,
                    position_ids=torch.tensor([[300]]))
        last, _ = m(ids, caches=init_caches(m, 1, 1), start_pos=0,
                    position_ids=torch.tensor([[127]]))
    assert torch.equal(past, last)


def test_tensor_parallel_raises_naming_the_roadmap():
    """Ported with fleet: outside an mp group, `tensor_parallel=True`
    builds fleet's mp layers at mp 1, the dense model's function and its
    weights from the same seed (the mp 2 cases are in
    tests/test_torch_fleet.py)."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl

    tp = GPTModel(GPTConfig.tiny(), tensor_parallel=True, device="cpu",
                  seed=4)
    dense = GPTModel(GPTConfig.tiny(), device="cpu", seed=4)
    assert isinstance(tp.wte, mpl.VocabParallelEmbedding)
    assert isinstance(tp.blocks[0].attn.qkv, mpl.ColumnParallelLinear)
    assert isinstance(tp.blocks[0].ffn_out, mpl.RowParallelLinear)
    for (n, a), b in zip(tp.named_parameters(), dense.parameters()):
        assert torch.equal(a, b), n
    ids = torch.from_numpy(_batch()[0])
    tp.eval()
    dense.eval()
    with torch.no_grad():
        assert torch.equal(tp(ids), dense(ids))


def test_seeded_init_and_default_device():
    a = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=3)
    b = GPTForCausalLM(GPTConfig.tiny(), device="cpu", seed=3)
    for (n, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), n
    blk = a.gpt.blocks[0]
    assert float(blk.attn.qkv.weight.std()) == pytest.approx(0.02, rel=0.05)
    assert not blk.attn.qkv.bias.any() and bool((blk.ln1.weight == 1).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            GPTForCausalLM(GPTConfig.tiny())
