"""paddle_tpu_torch collective / compute overlap in the tensor-parallel step
(serving/overlap.py), port against port, mirrored from the classes of
tests/test_tp_overlap.py that pass on the reference.

The overlapped engine cuts each layer reduction into row chunks and
issues chunk j+1's transport before chunk j is reduced and consumed by
the residual add and the next norm; the arithmetic over a chunk is the
serial reduction's over its rows, so the logits are bit-identical to the
serial tensor-parallel engine's (fp32 and bf16, fixed-order and int8
all-reduce), and so are the streams: tp 2 / 4, chunks 2 / 3, greedy and
seeded, horizons 1 and 4, LLaMA and GPT. Plus: chunks=1 runs the serial
reduction and never imports the module (poisoned-module proof, with tp=1
and serial tp=2 engines), snapshot -> restore across overlap on / off,
the best-of probe aggregator, the warmed collective probe, the
`overlap_fraction` stats surface and the histogram's `overlap` label,
the schedule's issue order, and the knob's validation.

The reference's `TestChunksOneIsSerial` jit-key tests pin `jax.jit`
caches, which an eager port does not keep: here `chunks=1` is pinned by
the reduction object the engine runs and by the poisoned module.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.serving import RequestJournal, ServingEngine

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """PyTorch's CPU ops would spread over every core; the suite runs in
    parallel workers on a shared machine, so keep this file to one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(family, dtype=torch.float32):
    """kv_heads=4 LLaMA (tp 2 and 4) or tiny GPT, seeded weights."""
    if family == "gpt":
        return GPTForCausalLM(GPTConfig.tiny(), device="cpu", dtype=dtype,
                              seed=1234)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=128, max_position_embeddings=64), device="cpu",
        dtype=dtype, seed=1234)


_ENGINE_KW = dict(page_size=4, num_pages=64, max_batch_size=4,
                  max_seq_len=48, decode_horizon=4)

_PROMPTS = [[7, 3, 9, 1, 4], [2, 8, 6, 5, 1, 9, 3, 7, 2],
            [4, 4, 1, 8, 8, 2, 6, 3, 9, 5, 1, 7, 3]]


def _engine(model, **kw):
    return ServingEngine(model, device="cpu", **{**_ENGINE_KW, **kw})


def _staggered(model, prompts=_PROMPTS, max_new=6, seeded=True, **kw):
    """Staggered arrivals; seeded sampling is the stricter probe (any
    drift in the logits moves some Gumbel argmax)."""
    eng = _engine(model, **kw)

    def req(i, p):
        knobs = (dict(temperature=0.8, top_k=5, seed=100 + i) if seeded
                 else dict(seed=7))
        return eng.add_request(p, max_new_tokens=max_new, **knobs)

    rids = [req(i, p) for i, p in enumerate(prompts[:2])]
    for _ in range(2):
        eng.step()
    for j, p in enumerate(prompts[2:], start=2):
        rids.append(req(j, p))
        eng.step()
    outs = eng.run()
    return eng, [outs[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _serial(family, tp, quant, horizon=4, seeded=True):
    """The serial TP engine's streams for one knob set: the overlap
    contract is identity with the SAME config without overlap (the int8
    all-reduce is lossy against the fixed-order sum)."""
    return _staggered(_model(family), tp_size=tp,
                      tp_quantized_allreduce=quant, decode_horizon=horizon,
                      seeded=seeded)[1]


# ------------------------------------------------------------ token parity

class TestBitIdentity:
    @pytest.mark.parametrize("chunks", [2, 3])
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("tp", [2, 4])
    def test_llama_streams_match_serial(self, tp, quant, chunks):
        _, got = _staggered(_model("llama"), tp_size=tp, tp_overlap=True,
                            tp_overlap_chunks=chunks,
                            tp_quantized_allreduce=quant)
        assert got == _serial("llama", tp, quant)

    @pytest.mark.parametrize("horizon", [1, 4])
    @pytest.mark.parametrize("seeded", [False, True])
    def test_llama_horizons_match_serial(self, horizon, seeded):
        _, got = _staggered(_model("llama"), tp_size=2, tp_overlap=True,
                            tp_overlap_chunks=2, decode_horizon=horizon,
                            seeded=seeded)
        assert got == _serial("llama", 2, False, horizon, seeded)

    @pytest.mark.parametrize("chunks", [2, 3])
    def test_gpt_streams_match_serial(self, chunks):
        """GPT adds the row-parallel biases after the reduction, as
        `resid + (reduced + bias)` in both engines."""
        _, got = _staggered(_model("gpt"), tp_size=2, tp_overlap=True,
                            tp_overlap_chunks=chunks)
        assert got == _serial("gpt", 2, False)

    def test_chunked_ragged_matches_serial(self):
        kw = dict(tp_size=2, enable_chunked_prefill=True,
                  prefill_chunk_tokens=8)
        _, want = _staggered(_model("llama"), **kw)
        _, got = _staggered(_model("llama"), tp_overlap=True,
                            tp_overlap_chunks=3, **kw)
        assert got == want

    @pytest.mark.parametrize("family,dtype,quant", [
        ("llama", torch.float32, False), ("llama", torch.float32, True),
        ("llama", torch.bfloat16, False), ("llama", torch.bfloat16, True),
        ("gpt", torch.float32, False), ("gpt", torch.bfloat16, False)])
    def test_logits_bit_identical_to_serial(self, family, dtype, quant):
        """Prefill and decode logits of the overlapped runner equal the
        serial runner's bit for bit, in fp32 and in bf16."""
        model = _model(family, dtype)
        ids = torch.from_numpy(np.random.RandomState(5).randint(
            0, 512, (3, 7)))
        outs = []
        for kw in (dict(), dict(tp_overlap=True, tp_overlap_chunks=2)):
            eng = _engine(model, tp_size=2, tp_quantized_allreduce=quant,
                          **kw)
            pages = [eng.cache.allocator.alloc_n(4) for _ in range(3)]
            table = eng.cache.page_table_array(pages, eng.max_pages_per_seq)
            with torch.no_grad():
                pre, _ = eng._fwd(ids, caches=eng.cache.layer_views(table),
                                  start_pos=0)
                dec, _ = eng._fwd(ids[:, -1:],
                                  caches=eng.cache.layer_views(table),
                                  start_pos=torch.full((3,), 7,
                                                       dtype=torch.int32))
            outs.append((pre, dec))
        for a, b in zip(*outs):
            assert a.dtype == dtype and torch.equal(a, b)


# --------------------------------------- chunks=1 is the serial engine

class TestChunksOneIsSerial:
    def test_chunks1_runs_the_serial_reduction(self):
        from paddle_tpu_torch.serving.tp import SerialReduce

        eng, got = _staggered(_model("llama"), tp_size=2, tp_overlap=True,
                              tp_overlap_chunks=1)
        assert got == _serial("llama", 2, False)
        assert type(eng._tp.reduce) is SerialReduce
        assert eng._tp.overlap is False
        d = eng._tp.describe()
        assert d["overlap"] is False and d["overlap_chunks"] == 1
        assert d["overlap_fraction"] is None

    def test_overlap_runs_the_pipeline(self):
        from paddle_tpu_torch.serving.overlap import OverlapPlan

        eng = _engine(_model("llama"), tp_size=2, tp_overlap=True,
                      tp_overlap_chunks=3)
        assert isinstance(eng._tp.reduce, OverlapPlan)
        assert eng._tp.reduce.chunks == 3


# ------------------------------------------------- zero touch when off

class TestZeroTouchWhenOff:
    def test_serial_engines_never_import_overlap_module(self, monkeypatch):
        """Poison serving.overlap: tp=1, serial tp=2 and chunks=1 engines
        run a full request without it; chunks >= 2 trips the poison."""
        poison = types.ModuleType("paddle_tpu_torch.serving.overlap")

        def _boom(name):
            raise AssertionError(
                f"overlap module touched with overlap off: {name}")

        poison.__getattr__ = _boom
        monkeypatch.setitem(sys.modules, "paddle_tpu_torch.serving.overlap",
                            poison)
        monkeypatch.setattr(tserving, "overlap", poison, raising=False)
        _, out = _staggered(_model("llama"), prompts=_PROMPTS[:1])
        assert len(out[0]) > len(_PROMPTS[0])
        _staggered(_model("llama"), prompts=_PROMPTS[:1], tp_size=2)
        _staggered(_model("llama"), prompts=_PROMPTS[:1], tp_size=2,
                   tp_overlap=True, tp_overlap_chunks=1)
        with pytest.raises(AssertionError, match="overlap module touched"):
            _engine(_model("llama"), tp_size=2, tp_overlap=True)


# --------------------------------------- snapshot across overlap modes

def _partial_snapshot(**kw):
    eng = _engine(_model("llama"), journal=RequestJournal(), **kw)
    rids = [eng.add_request(p, max_new_tokens=6, temperature=0.8, top_k=5,
                            seed=100 + i)
            for i, p in enumerate(_PROMPTS)]
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    eng.release_pools()
    return eng, rids, snap


class TestSnapshotAcrossOverlap:
    def test_overlap_snapshot_restores_on_serial_tp4(self):
        """A snapshot taken mid-run on an overlapped tp=2 engine restores
        onto a serial tp=4 engine (another degree and another reduction)
        and finishes with the serial engine's streams (seeded streams
        follow each request's seed and draw index, not its arrival)."""
        want = _serial("llama", 2, False)
        eng, rids, snap = _partial_snapshot(tp_size=2, tp_overlap=True,
                                            tp_overlap_chunks=2)
        eng2 = _engine(_model("llama"), journal=eng._journal, tp_size=4)
        eng2.restore(snap)
        out = eng2.run()
        assert [out[r] for r in rids] == want
        eng._journal.check_consistency()

    def test_serial_snapshot_restores_on_overlap(self):
        want = _serial("llama", 2, False)
        eng, rids, snap = _partial_snapshot(tp_size=2)
        eng2 = _engine(_model("llama"), journal=eng._journal, tp_size=2,
                       tp_overlap=True, tp_overlap_chunks=3)
        eng2.restore(snap)
        out = eng2.run()
        assert [out[r] for r in rids] == want


# ----------------------------------------------- probe + observability

class TestProbeAndStats:
    def test_probe_best_of_is_monotone_nonincreasing(self):
        from paddle_tpu_torch.serving.tp import TPContext

        trials = [3.0, 2.0, 5.0, 1.0, 4.0]
        prev = None
        for n in range(1, len(trials) + 1):
            cur = TPContext.probe_best_of(trials[:n])
            assert cur > 0.0
            if prev is not None:
                assert cur <= prev
            prev = cur
        assert prev == 1.0

    @pytest.mark.parametrize("quant", [False, True])
    def test_collective_seconds_warmed_and_positive(self, quant):
        eng = _engine(_model("llama"), tp_size=2,
                      tp_quantized_allreduce=quant)
        ts = eng._tp.collective_seconds(samples=3, rows=2, best_of=2)
        assert len(ts) == 3
        assert all(isinstance(t, float) and t > 0.0 for t in ts)

    def test_overlap_fraction_published_in_stats(self):
        eng, _ = _staggered(_model("llama"), tp_size=2, tp_overlap=True,
                            tp_overlap_chunks=2)
        frac = eng.stats()["tp"]["overlap_fraction"]
        assert isinstance(frac, float) and 0.0 <= frac <= 1.0
        d = eng._tp.describe()
        assert d["overlap"] is True and d["overlap_chunks"] == 2

    def test_serial_stats_report_no_overlap(self):
        eng, _ = _staggered(_model("llama"), tp_size=2)
        tp = eng.stats()["tp"]
        assert tp["overlap"] is False and tp["overlap_fraction"] is None

    def test_collective_histogram_carries_overlap_label(self):
        eng, _ = _staggered(_model("llama"), tp_size=2, tp_overlap=True,
                            tp_overlap_chunks=2)
        h = eng.metrics.get("serving_tp_collective_seconds",
                            labels={"overlap": "on"})
        assert h is not None and h.count >= 3
        assert eng.metrics.get("serving_tp_collective_seconds",
                               labels={"overlap": "off"}) is None


# --------------------------------------------------------------- schedule

class TestSchedule:
    def test_next_transport_is_issued_before_this_consume(self):
        from paddle_tpu_torch.serving.overlap import pipeline_chunks

        log = []
        pipeline_chunks([0, 1, 2],
                      lambda i: log.append(("transport", i)) or i,
                      lambda m: m,
                      lambda idx, red: log.append(("consume", red)))
        assert log == [("transport", 0), ("transport", 1), ("consume", 0),
                       ("transport", 2), ("consume", 1), ("consume", 2)]

    def test_pipelined_step_equals_serial_step(self):
        """The reduction step alone: chunked over 5 rows in 3 chunks, the
        residual and normed outputs are the serial step's bit for bit."""
        from paddle_tpu_torch.nn.layers import RMSNorm
        from paddle_tpu_torch.serving.overlap import OverlapPlan
        from paddle_tpu_torch.serving.tp import SerialReduce

        rng = np.random.RandomState(2)
        parts = [torch.from_numpy(rng.randn(1, 5, 64).astype(np.float32))
                 for _ in range(3)]
        resid = {CPU: torch.from_numpy(rng.randn(1, 5, 64).astype(
            np.float32))}
        bias = {CPU: torch.from_numpy(rng.randn(64).astype(np.float32))}
        norms = {CPU: RMSNorm(64, device="cpu")}
        for quant in (False, True):
            a = SerialReduce([CPU] * 3, quant).add_norm(parts, bias, resid,
                                                        norms)
            b = OverlapPlan([CPU] * 3, 3, quant).add_norm(parts, bias,
                                                          resid, norms)
            assert torch.equal(a[0][CPU], b[0][CPU])
            assert torch.equal(a[1][CPU], b[1][CPU])


# ----------------------------------------------------------- validation

class TestValidation:
    def test_overlap_at_tp1_is_rejected(self):
        with pytest.raises(ValueError, match="tp_size >= 2"):
            _engine(_model("llama"), tp_overlap=True)

    def test_zero_chunks_rejected(self):
        with pytest.raises(ValueError, match="chunks"):
            _engine(_model("llama"), tp_size=2, tp_overlap=True,
                    tp_overlap_chunks=0)

    def test_plan_needs_two_shards_and_two_chunks(self):
        from paddle_tpu_torch.serving.overlap import OverlapPlan

        with pytest.raises(ValueError, match="tp_size >= 2"):
            OverlapPlan([CPU], 2, False)
        with pytest.raises(ValueError, match="chunks >= 2"):
            OverlapPlan([CPU, CPU], 1, False)
