"""paddle_tpu_torch's T5 against the JAX package's, on the same weights and
the same batch.

`T5Config.tiny()` (2 + 2 layers, d_model 32, 4 heads of 8, 8 buckets up to
distance 16), dropout 0 (the two packages' random streams differ), weights
carried by `load_reference_state`. Two cases: ReLU with 12 source and 8
target tokens, and gated-GELU with ragged 37 / 19 (past the largest bucket
distance, so the log buckets and their cap are reached). The reference
step is built from `call_functional`, `jax.value_and_grad` and
`Adam.functional_step`, as tests/test_torch_ernie.py builds ERNIE's.

- Buckets, bidirectional and causal, bucket for bucket.
- fp32: encoder states and logits within rtol 1e-4 / atol 1e-5; the loss
  within 1e-5, every gradient (both relative-bias tables included) within
  rtol 1e-4 / atol 1e-5, one Adam update within 1e-6.
- O1 bf16 on both sides (the attention mask cast to bf16, as the
  reference's dispatch casts it): the loss within 2e-2 relative and every
  gradient's cosine above 0.99.
- The port alone: causal decoder, bidirectional encoder, `shift_right`
  with -100, the default device, explicit generators, the seq2seq step as
  a function of its generator, and greedy generation: cached decode
  against the uncached decoder, and `generate` token-identical to the
  JAX T5's, with and without eos.
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
from paddle_tpu.models.t5 import T5Config as JT5Config
from paddle_tpu.models.t5 import T5ForConditionalGeneration as JT5
from paddle_tpu.models.t5 import \
    _relative_position_bucket as j_relative_position_bucket
from paddle_tpu.ops import nn_ops

from paddle_tpu_torch import amp
from paddle_tpu_torch.models import T5Config, T5ForConditionalGeneration
from paddle_tpu_torch.models.t5 import _relative_position_bucket
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.training import make_seq2seq_train_step
from paddle_tpu_torch.weights import load_reference_state

LR = 1e-4
B = 2
# name: (feed_forward_proj, source tokens, target tokens)
CASES = {"relu, 12 / 8": ("relu", 12, 8),
         "gated-gelu, ragged 37 / 19": ("gated-gelu", 37, 19)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(cls, ff="relu", dropout=0.0):
    cfg = cls.tiny()
    cfg.dropout_rate = dropout
    cfg.feed_forward_proj = ff
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_model(ff):
    paddle.seed(2024)
    m = JT5(_cfg(JT5Config, ff))
    m.train()
    return m


def _batch(src_len, tgt_len):
    r = np.random.RandomState(src_len * 100 + tgt_len)
    src = r.randint(0, 256, (B, src_len)).astype(np.int64)
    labels = r.randint(1, 256, (B, tgt_len)).astype(np.int64)
    labels[0, -3:] = -100                       # ignored target positions
    labels[1, 2] = -100
    return src, labels


def _jax_dec_in(model, labels):
    return np.asarray(model.shift_right(labels).numpy())


@functools.lru_cache(maxsize=None)
def _jax_step(case, o1):
    """(loss, grads, params after one Adam update, params, logits, enc) of
    the reference."""
    ff, src_len, tgt_len = CASES[case]
    model = _jax_model(ff)
    params, buffers = extract_state(model)
    src, labels = _batch(src_len, tgt_len)
    dec_in = _jax_dec_in(model, labels)
    args = (jnp.asarray(src), jnp.asarray(dec_in))

    def loss_of(p):
        ctx = (jamp.auto_cast(level="O1", dtype="bfloat16") if o1
               else contextlib.nullcontext())
        with ctx:
            logits, _ = call_functional(model, p, buffers, args,
                                        training=True)
        # model.loss: cross_entropy, black-listed (fp32) under O1
        loss = nn_ops.cross_entropy(
            logits.astype(jnp.float32).reshape(-1, logits.shape[-1]),
            jnp.asarray(labels).reshape(-1), ignore_index=-100)
        return loss, logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    enc, _ = jax.jit(lambda p: call_functional(
        model, p, buffers, (args[0],), training=True)[0])(params)
    opt = paddle.optimizer.Adam(learning_rate=LR,
                                parameters=model.parameters())
    new, _ = jax.jit(lambda p, g: opt.functional_step(
        p, g, opt.functional_state(p), jnp.float32(LR), jnp.int32(1)))(
            params, grads)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (float(loss), as_np(grads), as_np(new), as_np(params),
            np.asarray(logits.astype(jnp.float32)), np.asarray(enc))


def _port(ff, params):
    m = T5ForConditionalGeneration(_cfg(T5Config, ff), device="cpu")
    load_reference_state(m, params)
    return m


def _linear_names(model):
    return {f"{n}.weight" for n, mod in model.named_modules()
            if isinstance(mod, torch.nn.Linear)}


def _port_step(case, params, o1):
    ff, src_len, tgt_len = CASES[case]
    model = _port(ff, params)
    model.train()
    src, labels = _batch(src_len, tgt_len)
    src, labels = torch.from_numpy(src), torch.from_numpy(labels)
    ctx = amp.auto_cast(level="O1") if o1 else contextlib.nullcontext()
    with ctx:
        logits = model(src, model.shift_right(labels))
        loss = model.loss(logits, labels)
    loss.backward()
    lin = _linear_names(model)
    grads = {}
    for n, p in model.named_parameters():
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        grads[n] = g.T if n in lin else g
    return model, loss.item(), grads, logits.detach().float().numpy()


# ------------------------------------------------------------------ buckets

@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["bidirectional", "causal"])
@pytest.mark.parametrize("buckets", [(8, 16), (32, 128)],
                         ids=["tiny", "t5"])
def test_buckets_match_reference(bidirectional, buckets):
    num_buckets, max_distance = buckets
    ctx = np.arange(600, dtype=np.int32)[:, None]
    mem = np.arange(600, dtype=np.int32)[None, :]
    rp = mem - ctx
    ref = np.asarray(j_relative_position_bucket(
        jnp.asarray(rp), bidirectional, num_buckets, max_distance))
    got = _relative_position_bucket(torch.from_numpy(rp), bidirectional,
                                    num_buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.max() == num_buckets - 1         # the cap is reached


# ------------------------------------------------------------ fp32 parity

@pytest.mark.parametrize("case", list(CASES))
def test_fp32_forward_matches_reference(case):
    ff, src_len, tgt_len = CASES[case]
    _, _, _, params, ref_logits, ref_enc = _jax_step(case, False)
    model = _port(ff, params)
    model.train()                 # dropout 0: train and eval agree
    src, labels = _batch(src_len, tgt_len)
    src_t, labels_t = torch.from_numpy(src), torch.from_numpy(labels)
    with torch.no_grad():
        logits = model(src_t, model.shift_right(labels_t))
        enc, cross = model(src_t)
    np.testing.assert_allclose(enc.numpy(), ref_enc, rtol=1e-4, atol=1e-5,
                               err_msg="encoder states")
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-4,
                               atol=1e-5, err_msg="logits")
    assert len(cross) == 2 and cross[0][0].shape == (B, src_len, 4, 8)


@pytest.mark.parametrize("case", list(CASES))
def test_fp32_step_matches_reference(case):
    ref_loss, ref_grads, ref_new, params, _, _ = _jax_step(case, False)
    model, loss, grads, _ = _port_step(case, params, False)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=1e-5)
    assert grads.keys() == ref_grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref_grads[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    for table in ("t5.encoder_layers.0.attn.relative_attention_bias.weight",
                  "t5.decoder_layers.0.self_attn.relative_attention_bias"
                  ".weight"):
        assert np.abs(grads[table]).max() > 0, table
    # one Adam update, both fed the reference's gradients (see
    # tests/test_torch_ernie.py for why)
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


@pytest.mark.parametrize("case", list(CASES))
def test_o1_bf16_step_matches_reference(case):
    ref_loss, ref_grads, _, params, _, _ = _jax_step(case, True)
    _, loss, grads, _ = _port_step(case, params, True)
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
    for name, g in grads.items():
        r = ref_grads[name].astype(np.float64).ravel()
        gg = g.astype(np.float64).ravel()
        cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
        assert cos > 0.99, (name, cos)


def test_parameter_names_match_the_reference():
    params, _ = extract_state(_jax_model("gated-gelu"))
    port = T5ForConditionalGeneration(_cfg(T5Config, "gated-gelu"),
                                      device="cpu")
    assert set(dict(port.named_parameters())) == set(params)
    assert "t5.decoder_layers.0.self_attn.relative_attention_bias.weight" \
        in params
    assert "t5.encoder_layers.1.ff.wi_0.weight" in params


def test_shift_right_matches_reference():
    _, labels = _batch(12, 8)
    ref = _jax_dec_in(_jax_model("relu"), labels)
    model = T5ForConditionalGeneration(_cfg(T5Config), device="cpu")
    got = model.shift_right(torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got != -100).all() and (got[:, 0] == 0).all()


# --------------------------------------------------------- the port alone

def _model(seed, ff="relu", dropout=0.0):
    m = T5ForConditionalGeneration(_cfg(T5Config, ff, dropout),
                                   device="cpu", seed=seed)
    m.eval()
    return m


def test_causal_decoder():
    """Future target tokens do not move earlier logits."""
    model = _model(2)
    r = np.random.RandomState(2)
    src = torch.from_numpy(r.randint(0, 256, (1, 6)))
    dec = r.randint(1, 256, (1, 6))
    dec2 = dec.copy()
    dec2[0, -1] = (dec2[0, -1] + 7) % 256
    with torch.no_grad():
        la = model(src, torch.from_numpy(dec)).numpy()
        lb = model(src, torch.from_numpy(dec2)).numpy()
    np.testing.assert_allclose(la[0, :-1], lb[0, :-1], atol=1e-6)
    assert not np.allclose(la[0, -1], lb[0, -1])


def test_encoder_is_bidirectional():
    model = _model(3)
    r = np.random.RandomState(3)
    src = r.randint(0, 256, (1, 6))
    src2 = src.copy()
    src2[0, -1] = (src2[0, -1] + 3) % 256
    with torch.no_grad():
        e1 = model.t5.encode(torch.from_numpy(src)).numpy()
        e2 = model.t5.encode(torch.from_numpy(src2)).numpy()
    # changing the LAST source token changes EVERY encoder position
    assert not np.allclose(e1[0, 0], e2[0, 0])


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists; the raise needs a card-less "
                    "machine")
    with pytest.raises(RuntimeError, match="cuda"):
        T5ForConditionalGeneration(T5Config.tiny())


def test_dropout_in_training_needs_an_explicit_generator():
    model = _model(4, dropout=0.1)
    ids = torch.zeros((1, 8), dtype=torch.int64)
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(ids, ids)
    model.eval()
    model(ids, ids)                           # eval: no dropout, no draw


def test_seq2seq_step_is_a_function_of_its_generator():
    """make_seq2seq_train_step with dropout 0.1 (hidden and attention): the
    loss is finite and falls, and the same generator seed replays the same
    losses bit for bit."""
    r = np.random.RandomState(0)
    src = torch.from_numpy(r.randint(0, 256, (2, 20)))
    labels = torch.from_numpy(r.randint(1, 256, (2, 9)))
    labels[1, -2:] = -100

    def run(seed):
        model = T5ForConditionalGeneration(_cfg(T5Config, dropout=0.1),
                                           device="cpu", seed=1)
        step = make_seq2seq_train_step(model, Adam(
            learning_rate=1e-2, parameters=model.parameters()))
        gen = torch.Generator().manual_seed(seed)
        return [step(src, labels, gen).item() for _ in range(4)]

    a, b, c = run(7), run(7), run(8)
    assert all(np.isfinite(a)) and a[-1] < a[0]
    assert a == b and a != c


def test_generation_raises_naming_s10():
    """The three surfaces that refused generation before the static cache
    was ported now run: `generate`, the decode call shape of the forward
    (returns (logits, caches)) and the decoder self-attention over a
    (k, v) cache, which it writes in place at `start_pos`."""
    model = _model(5)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    out = model.generate(ids, max_new_tokens=3)
    assert out.shape == (1, 3) and out.dtype == torch.int32
    enc, cross = model(ids)
    caches = [(torch.zeros(1, 3, 4, 8), torch.zeros(1, 3, 4, 8))
              for _ in range(2)]
    with torch.no_grad():
        logits, new = model(None, ids[:, :1], caches=caches, start_pos=0,
                            enc=enc, cross_kvs=cross)
        assert logits.shape == (1, 1, 256) and new[0][0] is caches[0][0]
        attn = model.t5.decoder_layers[0].self_attn
        kc = torch.zeros(1, 3, 4, 8)
        a, bias, (wk, _) = attn(torch.randn(1, 1, 32), cache=(
            kc, torch.zeros(1, 3, 4, 8)), start_pos=1)
    assert a.shape == (1, 1, 32) and tuple(bias.shape) == (1, 4, 1, 3)
    assert wk is kc and kc[:, 1].abs().sum() > 0 and not kc[:, 0].any()
    with pytest.raises(ValueError, match="caches"):
        model(None, ids[:, :1], caches=caches[:1], enc=enc, cross_kvs=cross)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_cached_decode_matches_full_forward(ff):
    """tests/test_t5.py's check on the port: greedy decoding over the
    caches equals the argmax of the uncached decoder over the greedy
    prefix at every step, and the step logits agree (atol 2e-5)."""
    model = _model(5, ff)
    src = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (2, 7)))
    out = model.generate(src, max_new_tokens=6)
    assert out.shape == (2, 6)
    with torch.no_grad():
        enc, cross = model(src)
        caches = [(torch.zeros(2, 6, 4, 8), torch.zeros(2, 6, 4, 8))
                  for _ in range(2)]
        cur = torch.full((2, 1), model.config.decoder_start_token_id)
        for t in range(6):
            full = model._logits(model.t5.decode(cur, enc))[:, -1]
            step, caches = model(None, cur[:, -1:], caches=caches,
                                 start_pos=t, enc=enc, cross_kvs=cross)
            np.testing.assert_allclose(step[:, 0].numpy(), full.numpy(),
                                       rtol=0, atol=2e-5)
            np.testing.assert_array_equal(full.argmax(-1).numpy(),
                                          out[:, t].numpy())
            cur = torch.cat([cur, out[:, t:t + 1].long()], dim=1)


def test_generate_token_identical_to_jax():
    """Greedy `generate` against the JAX T5's on the same weights (gated
    GELU, 37 source tokens), 10 new tokens with an eos that row 0 meets at
    once, over both rows and over row 0 alone (every row finished: the
    early exit at the 8-step poll leaves the same columns out)."""
    ff, src_len, _ = CASES["gated-gelu, ragged 37 / 19"]
    jm = _jax_model(ff)
    params, _ = extract_state(jm)
    pm = _port(ff, {k: np.asarray(v) for k, v in params.items()})
    src, _ = _batch(src_len, 8)
    eos = int(pm.generate(torch.from_numpy(src), max_new_tokens=2)[0, 1])

    def both(ids):
        got = pm.generate(torch.from_numpy(ids), max_new_tokens=10,
                          eos_token_id=eos)
        ref = jm.generate(paddle.to_tensor(ids), max_new_tokens=10,
                          eos_token_id=eos)
        jm.train()                 # the cached reference stays in train
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        return got.numpy()

    two = both(src)
    assert (two[0, 1:] == eos).all()
    one = both(src[:1])
    assert one.shape == (1, 8) and (one[0, 1:] == eos).all()
