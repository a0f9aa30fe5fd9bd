"""paddle_tpu_torch LLaMA against the JAX package's LLaMA on the same
weights: parameter names, the weights converter, no-cache logits, and the
paged-cache forward against the port's own no-cache forward.

fp32 on both sides, JAX at matmul precision "highest" (conftest); logits
within atol 1e-4 (two backends, two summation orders, two layers deep).
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving.kv_cache import PagedKVCache
from paddle_tpu_torch.weights import load_reference_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_llama():
    paddle.seed(1234)
    m = JLlama(JLlamaConfig.tiny())
    m.eval()
    return m


def _jax_params():
    params, _ = extract_state(_jax_llama())
    return {k: np.asarray(v) for k, v in params.items()}


def _port_llama():
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(m, _jax_params())
    return m


class TestWeights:
    def test_parameter_names_match_the_reference(self):
        port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        assert set(dict(port.named_parameters())) == set(_jax_params())

    def test_linear_weights_are_transposed_on_the_way_in(self):
        port = _port_llama()
        ref = _jax_params()["llama.layers.0.self_attn.k_proj.weight"]
        got = port.llama.layers[0].self_attn.k_proj.weight
        assert ref.shape == (64, 32) and tuple(got.shape) == (32, 64)
        np.testing.assert_array_equal(got.detach().numpy(), ref.T)
        np.testing.assert_array_equal(
            port.llama.embed_tokens.weight.detach().numpy(),
            _jax_params()["llama.embed_tokens.weight"])

    def test_missing_extra_and_misshapen_keys_raise(self):
        port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        params = _jax_params()
        missing = dict(params)
        missing.pop("lm_head.weight")
        with pytest.raises(KeyError, match="lm_head.weight"):
            load_reference_state(port, missing)
        with pytest.raises(KeyError, match="bogus"):
            load_reference_state(port, {**params, "bogus": np.zeros(1)})
        bad = dict(params)
        bad["llama.norm.weight"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="llama.norm.weight"):
            load_reference_state(port, bad)


class TestForward:
    def test_no_cache_logits_match_jax(self):
        ids = np.random.RandomState(0).randint(0, 512, (2, 13))
        ref = _jax_llama()(paddle.to_tensor(ids)).numpy()
        with torch.no_grad():
            got = _port_llama()(torch.from_numpy(ids)).numpy()
        assert got.shape == ref.shape == (2, 13, 512)
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_paged_prefill_then_decode_matches_no_cache(self):
        """Prefill a padded prompt into the pool, then decode two tokens
        through the paged decode path: each step's logits equal the
        no-cache forward's at that position."""
        model = _port_llama()
        seq = np.random.RandomState(1).randint(0, 512, (12,))
        cache = PagedKVCache.for_model(model, num_pages=8, page_size=4)
        pages = cache.allocator.alloc_n(4)
        table = cache.page_table_array([pages], 4)
        with torch.no_grad():
            full = model(torch.from_numpy(seq[None]))[0]
            ids = torch.zeros((1, 16), dtype=torch.int64)
            ids[0, :10] = torch.from_numpy(seq[:10])      # padded to 16
            logits, _ = model(ids, caches=cache.layer_views(table),
                              start_pos=0)
            np.testing.assert_allclose(logits[0, :10].numpy(),
                                       full[:10].numpy(), atol=1e-5)
            for pos in (10, 11):
                step, _ = model(torch.from_numpy(seq[None, pos:pos + 1]),
                                caches=cache.layer_views(table),
                                start_pos=torch.tensor([pos],
                                                       dtype=torch.int32))
                np.testing.assert_allclose(step[0, 0].numpy(),
                                           full[pos].numpy(), atol=1e-5)


class TestConstruction:
    def test_default_device_is_cuda_and_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            LlamaForCausalLM(LlamaConfig.tiny())

    def test_seeded_init_is_reproducible(self):
        a = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
        b = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=3)
        c = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=4)
        wa, wb, wc = (m.llama.layers[1].mlp.up_proj.weight for m in (a, b, c))
        assert torch.equal(wa, wb) and not torch.equal(wa, wc)
        std = float(wa.detach().std())
        assert 0.015 < std < 0.025               # N(0, 0.02)
        assert torch.all(a.llama.norm.weight == 1.0)

    def test_bf16_model_keeps_its_dtype(self):
        m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             dtype=torch.bfloat16)
        with torch.no_grad():
            out = m(torch.zeros((1, 4), dtype=torch.int64))
        assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 512)


# ------------------------------------------- the causal-LM training surface

def _jax_loss_step(fused, o1, ids):
    """(loss, grads) of the reference LLaMA's `forward(labels=)`, through
    `call_functional` and `jax.value_and_grad` (as tests/test_torch_ernie.py
    builds its reference step)."""
    import contextlib

    import jax
    import jax.numpy as jnp
    from paddle_tpu import amp as jamp
    from paddle_tpu.jit.functional import call_functional

    model = _jax_llama()
    model.llama.config.fused_lm_loss = fused
    params, buffers = extract_state(model)

    def loss_of(p):
        ctx = (jamp.auto_cast(level="O1", dtype="bfloat16") if o1
               else contextlib.nullcontext())
        with ctx:
            loss, _ = call_functional(model, p, buffers, (jnp.asarray(ids),),
                                      kwargs={"labels": jnp.asarray(ids)},
                                      training=True)
        return loss

    try:
        loss, grads = jax.jit(jax.value_and_grad(loss_of))(params)
    finally:
        model.llama.config.fused_lm_loss = False
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _port_grads(model):
    lin = {f"{n}.weight" for n, mod in model.named_modules()
           if isinstance(mod, torch.nn.Linear)}
    return {n: (p.grad.numpy().T if n in lin else p.grad.numpy())
            for n, p in model.named_parameters()}


class TestLossSurface:
    """`labels=` and `fused_lm_loss` against the reference
    (tests/test_llama.py's TestFusedLMLoss): the shifted causal CE, plain
    and fused, loss within 1e-5 and every gradient within rtol 1e-4 / atol
    1e-5 at fp32; `make_causal_lm_train_step` at O1 within the bf16 bounds
    of tests/test_torch_ernie.py (loss 2e-2 relative, gradient cosines
    above 0.99)."""

    IDS = np.random.RandomState(0).randint(0, 512, (2, 12))

    @pytest.mark.parametrize("fused", [False, True],
                             ids=["logits path", "fused head"])
    def test_fp32_loss_and_gradients_match_jax(self, fused):
        ref_loss, ref_grads = _jax_loss_step(fused, False, self.IDS)
        model = _port_llama()
        model.llama.config.fused_lm_loss = fused
        ids = torch.from_numpy(self.IDS)
        loss = model(ids, labels=ids)
        with torch.no_grad():
            by_hand = model.loss(model(ids), ids)
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=0, atol=1e-5)
        np.testing.assert_allclose(loss.item(), by_hand.item(), rtol=1e-5)
        loss.backward()
        grads = _port_grads(model)
        assert grads.keys() == ref_grads.keys()
        for name, g in grads.items():
            np.testing.assert_allclose(g, ref_grads[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)

    def test_o1_train_step_matches_jax(self):
        from paddle_tpu_torch.optimizer import Adam
        from paddle_tpu_torch.training import make_causal_lm_train_step

        ref_loss, ref_grads = _jax_loss_step(True, True, self.IDS)
        model = _port_llama()
        model.llama.config.fused_lm_loss = True
        opt = Adam(learning_rate=1e-4, parameters=model.parameters())
        grads = {}
        real_step = opt.step

        def keep_grads():
            grads.update(_port_grads(model))
            real_step()

        opt.step = keep_grads
        step = make_causal_lm_train_step(model, opt)
        ids = torch.from_numpy(self.IDS)
        loss = float(step(ids, ids, torch.Generator()))
        assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss), (loss, ref_loss)
        assert grads.keys() == ref_grads.keys()
        for name, g in grads.items():
            r = ref_grads[name].astype(np.float64).ravel()
            gg = g.astype(np.float64).ravel()
            cos = gg @ r / (np.linalg.norm(gg) * np.linalg.norm(r))
            assert cos > 0.99, (name, cos)
        assert all(p.grad is None for p in model.parameters())
