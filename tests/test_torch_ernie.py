"""paddle_tpu_torch's ERNIE pretraining step against the JAX package's, on
the same weights and the same batch.

The reference step is built here from `call_functional`,
`jax.value_and_grad` and `Adam.functional_step` (bench.py's
`make_train_step` hard-codes O1 autocast, and the fp32 comparison needs it
off). `ErnieConfig.tiny()`, 2 layers, dropout 0 (the two packages' random
streams differ), weights carried by `load_reference_state`.

- fp32: the MLM loss within 1e-5, every parameter gradient within rtol
  1e-4 / atol 1e-5, the parameters after one Adam update within atol 1e-6.
- O1 bf16 on both sides: the loss within 2e-2 relative and the cosine of
  every gradient above 0.99 (the two frameworks round bf16 at different
  places).
- The port's auto_cast gives the reference's types op by op; the train
  step draws every dropout mask from its explicit generator.
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
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie

from paddle_tpu_torch import amp
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import cross_entropy as tce
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.training import make_train_step
from paddle_tpu_torch.weights import load_reference_state

LR = 1e-4       # the bench step's learning rate (bench.py:1167)
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
    cfg.fused_mlm_loss = fused
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(fused):
    paddle.seed(2024)
    m = JErnie(_cfg(JErnieConfig, fused))
    m.train()
    return m


def _batch(with_mask):
    r = np.random.RandomState(5)
    ids = r.randint(0, 1024, (B, S)).astype(np.int64)
    labels = r.randint(0, 1024, (B, S)).astype(np.int64)
    labels[:, ::5] = -100                        # ignored rows
    mask = None
    if with_mask:
        mask = np.ones((B, S), np.int64)
        mask[1, S - 7:] = 0                      # padding of the second row
    return ids, labels, mask


def _jax_step(fused, with_mask, o1):
    """(loss, grads, params after one Adam update) of the reference."""
    model = _jax_model(fused)
    params, buffers = extract_state(model)
    ids, labels, mask = _batch(with_mask)
    args = (jnp.asarray(ids), None, None,
            None if mask is None else jnp.asarray(mask), jnp.asarray(labels))

    def loss_of(p):
        ctx = (jamp.auto_cast(level="O1", dtype="bfloat16") if o1
               else contextlib.nullcontext())
        with ctx:
            (loss, _), _ = call_functional(model, p, buffers, args,
                                           training=True)
        return loss

    loss, grads = jax.value_and_grad(loss_of)(params)
    opt = paddle.optimizer.Adam(learning_rate=LR,
                                parameters=model.parameters())
    new, _ = opt.functional_step(params, grads, opt.functional_state(params),
                                 jnp.float32(LR), jnp.int32(1))
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return float(loss), as_np(grads), as_np(new), as_np(params)


def _port(fused, params):
    m = ErnieForPretraining(_cfg(ErnieConfig, fused), device="cpu")
    load_reference_state(m, params)
    return m


def _linear_names(model):
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def _port_step(fused, with_mask, params, o1):
    model = _port(fused, params)
    ids, labels, mask = _batch(with_mask)
    ctx = amp.auto_cast(level="O1") if o1 else contextlib.nullcontext()
    with ctx:
        loss, _ = model(torch.from_numpy(ids),
                        attention_mask=(None if mask is None
                                        else torch.from_numpy(mask)),
                        masked_lm_labels=torch.from_numpy(labels))
    loss.backward()
    lin = _linear_names(model)
    grads = {}
    for n, p in model.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        grads[n] = g.T if n in lin else g
    return model, loss.item(), grads


CASES = {"fused MLM loss": (True, False),
         "logits + cross_entropy, attention mask": (False, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_step_matches_reference(case):
    fused, with_mask = CASES[case]
    ref_loss, ref_grads, ref_new, params = _jax_step(fused, with_mask, False)
    model, loss, grads = _port_step(fused, with_mask, params, False)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=1e-5)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # one Adam update: the port's optimizer against functional_step, both
    # fed the reference's gradients (at t = 1 Adam's step is ~lr * g/|g|,
    # so a gradient element near epsilon would amplify the two backends'
    # last-bit differences that the check above already bounds)
    lin = _linear_names(model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = torch.from_numpy(np.array(ref_grads[name]))
            p.grad = g.t().contiguous() if name in lin else g
    opt = Adam(learning_rate=LR, parameters=model.parameters())
    opt.step()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if name in lin else got,
                                   ref_new[name], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_o1_bf16_step_matches_reference():
    ref_loss, ref_grads, _, params = _jax_step(True, False, True)
    _, loss, grads = _port_step(True, False, params, True)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
    for name, g in grads.items():
        r = ref_grads[name].astype(np.float64).ravel()
        gg = g.astype(np.float64).ravel()
        if not r.any() and not gg.any():     # pooler / nsp: no loss path
            continue
        cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
        assert cos > 0.99, (name, cos)


def test_parameter_names_match_the_reference():
    params, _ = extract_state(_jax_model(True))
    port = ErnieForPretraining(_cfg(ErnieConfig, True), device="cpu")
    assert set(dict(port.named_parameters())) == set(params)
    assert "ernie.layers.0.attention.qkv.weight" in params


def test_auto_cast_gives_the_reference_types(monkeypatch):
    x32 = torch.randn(2, 6, 16)
    w = torch.randn(8, 16)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert F.linear(x32, w).dtype == torch.bfloat16
        assert F.matmul(x32, w, transpose_y=True).dtype == torch.bfloat16
        ln = F.layer_norm(x32.bfloat16(), 16, torch.ones(16),
                          torch.zeros(16))
        assert ln.dtype == torch.float32                 # black list
        rms = F.rms_norm(x32.bfloat16(), torch.ones(16).bfloat16())
        assert rms.dtype == torch.float32                # black list
        assert F.relu(x32.bfloat16()).dtype == torch.bfloat16
        q = torch.randn(2, 6, 2, 8)
        assert F.scaled_dot_product_attention(q, q, q).dtype == \
            torch.bfloat16
        # a float mask is cast with q, k and v (the reference's dispatch
        # casts every float input of the op), and a trainable one takes
        # its gradient back through that cast, in fp32
        mask = torch.randn(1, 2, 6, 6, requires_grad=True)
        types = []
        real = F._attention

        def spy(q_, k_, v_, m_, *rest):
            types.append((q_.dtype, m_.dtype))
            return real(q_, k_, v_, m_, *rest)

        monkeypatch.setattr(F, "_attention", spy)
        qg = q.clone().requires_grad_()
        out = F.scaled_dot_product_attention(qg, q, q, attn_mask=mask)
        monkeypatch.setattr(F, "_attention", real)
        assert types == [(torch.bfloat16, torch.bfloat16)]
        out.float().sum().backward()
        assert mask.grad.dtype == torch.float32
        assert float(mask.grad.abs().max()) > 0
        assert F.gelu(x32).dtype == torch.float32       # follows its input
        assert F.gelu(x32.bfloat16()).dtype == torch.bfloat16
        assert F.cross_entropy(torch.randn(3, 5).bfloat16(),
                               torch.tensor([0, 1, 2])).dtype == \
            torch.float32
        seen = []
        orig = tce._logits

        def spy(x_c, w_, bias_f, transpose_y):
            seen.append((x_c.dtype, w_.dtype))
            return orig(x_c, w_, bias_f, transpose_y)

        tce._logits = spy
        try:
            loss = F.fused_linear_cross_entropy(
                x32.reshape(-1, 16), torch.randn(30, 16), torch.zeros(30),
                torch.randint(0, 30, (12,)), transpose_y=True)
        finally:
            tce._logits = orig
        assert seen and all(d == (torch.bfloat16, torch.bfloat16)
                            for d in seen)
        assert loss.dtype == torch.float32              # fp32 lse
    assert F.linear(x32, w).dtype == torch.float32      # off again outside


def test_o2_and_recompute_raise_naming_their_roadmap_items():
    """O2 (ROADMAP T4) and recompute (T6) are ported: neither raises any
    more. O2 runs an op off both lists in bf16, and a recomputing ERNIE
    builds and trains; the tests of their numbers are
    tests/test_torch_amp.py and tests/test_torch_recompute.py."""
    with amp.auto_cast(level="O2"):
        assert F.gelu(torch.ones(3)).dtype == torch.bfloat16
    cfg = _cfg(ErnieConfig, True)
    cfg.recompute = True
    model = ErnieForPretraining(cfg, device="cpu")
    model.train()
    ids = torch.zeros((1, 8), dtype=torch.int64)
    loss, _ = model(ids, masked_lm_labels=ids,
                    generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the raise needs a card-less "
                    "machine")
    with pytest.raises(RuntimeError, match="cuda"):
        ErnieForPretraining(ErnieConfig.tiny())


def test_dropout_in_training_needs_an_explicit_generator():
    cfg = ErnieConfig.tiny()
    model = ErnieForPretraining(cfg, device="cpu")
    ids = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="Generator"):
        model(ids, masked_lm_labels=ids)
    model.eval()
    model(ids, masked_lm_labels=ids)          # eval: no dropout, no draw


def test_train_step_is_a_function_of_its_generator():
    """make_train_step with dropout 0.1: the loss is finite and falls, and
    the same generator seed replays the same losses bit for bit."""
    cfg = ErnieConfig.tiny()
    cfg.fused_mlm_loss = True
    r = np.random.RandomState(0)
    ids = torch.from_numpy(r.randint(0, cfg.vocab_size, (2, 32)))
    labels = torch.from_numpy(r.randint(0, cfg.vocab_size, (2, 32)))

    def run(seed):
        model = ErnieForPretraining(cfg, device="cpu", seed=1)
        step = make_train_step(model, Adam(learning_rate=1e-3,
                                           parameters=model.parameters()))
        gen = torch.Generator().manual_seed(seed)
        return [step(ids, labels, gen).item() for _ in range(4)]

    a, b, c = run(7), run(7), run(8)
    assert all(np.isfinite(a)) and a[-1] < a[0]
    assert a == b and a != c
