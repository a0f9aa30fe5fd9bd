"""paddle_tpu_torch.serving's recovery layer (serving/recovery.py and the
engine's journal, salvage, snapshot and restore), mirrored from
tests/test_recovery.py.

Against the JAX package:
- a journal file written by the port is read by the JAX package's
  `RequestJournal.load` to the same records, and the reverse; the torn-tail
  variants (a writer killed mid-record, mid-file damage) behave the same in
  both packages;
- the slice as a whole: the JAX engine and the port's, each under its own
  `EngineSupervisor` with `fail_at("device_lost", k)` for every step k of
  a short run, unchunked and chunked with the ragged step, give greedy
  streams token-identical to each other and to the JAX engine's
  uninterrupted run, each delivered exactly once.

Port against port (the port's draws are counter-based, not threefry):
seeded restore == uninterrupted at decode horizons 1 and 8; kill-anywhere
plain, across horizons, mid chunked prefill, under preemption pressure,
while sharing prefix pages, and with speculation on; the watchdog through
an injected clock; the fault storm, `max_restarts` -> `EngineDead` and
fatal faults bypassing retry; the manual restart; a deadline that passes
during the outage; a cancel issued mid-restore; restored ids never
colliding with new ones; the dead supervisor answering from the journal;
a journal-free engine never importing `serving.recovery`; and the entry
points raising without a card unless given the CPU.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import dataclasses
import functools
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import EngineSupervisor as JEngineSupervisor
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import RequestJournal as JRequestJournal
from paddle_tpu.serving import ServingEngine as JServingEngine

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.serving import (
    EngineDead, EngineSnapshot, EngineSupervisor, FaultInjector,
    RequestJournal, ServingEngine, SpecConfig, is_fatal, replay_key_state,
)
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


@functools.lru_cache(maxsize=None)
def _port_llama():
    params, _ = extract_state(_jax_llama())
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state(m, {k: np.asarray(v) for k, v in params.items()})
    return m


_KNOBS = dict(page_size=4, num_pages=64, max_batch_size=4, max_seq_len=64,
              decode_horizon=4, retry_backoff_s=0.0)


def _engine(**kw):
    return ServingEngine(_port_llama(), device="cpu", **{**_KNOBS, **kw})


def _jengine(**kw):
    return JServingEngine(_jax_llama(), **{**_KNOBS, **kw})


_PROMPTS = [[7, 3, 9, 1, 4], [2, 8, 6, 5, 1, 9, 3, 7, 2],
            [4, 4, 1, 8, 8, 2, 6, 3, 9, 5, 1, 7, 3]]
_SHARED = [6, 1, 6, 1, 8, 0, 3, 3]
_SHARED_PROMPTS = [_SHARED + [7, 3, 9], _SHARED + [2, 8, 6, 5, 1],
                   _SHARED + [4, 4, 1, 8, 8, 2, 6]]
_CHUNKED = dict(enable_chunked_prefill=True, prefill_chunk_tokens=8)

_SUBMIT_KW = dict(max_new_tokens=6, temperature=0.0, top_k=0, top_p=1.0,
                  seed=7, eos_token_id=None, deadline_wall=None)


def _sampling_kw(i, seeded):
    return dict(temperature=0.8, top_k=5, seed=100 + i) if seeded else {}


def _uninterrupted(make, prompts=_PROMPTS, max_new=6, seeded=False, **kw):
    eng = make(**kw)
    rids = [eng.add_request(p, max_new_tokens=max_new,
                            **_sampling_kw(i, seeded))
            for i, p in enumerate(prompts)]
    out = eng.run()
    return [out[r] for r in rids], eng


def _supervised(sup_cls, make, fi, prompts=_PROMPTS, max_new=6,
                seeded=False, journal=None, **kw):
    """One supervised run; returns (supervisor, rids, streamed tokens)."""
    sup = sup_cls(lambda: make(fault_injector=fi, **kw),
                  journal=journal)
    rids = [sup.add_request(p, max_new_tokens=max_new,
                            **_sampling_kw(i, seeded))
            for i, p in enumerate(prompts)]
    streamed = {r: [] for r in rids}
    for rid, tok, _ in sup.stream():
        streamed[rid].append(tok)
    return sup, rids, streamed


def _steps_of(eng_factory, prompts=_PROMPTS, max_new=6, **kw):
    """How many step() calls an uninterrupted run takes."""
    eng = eng_factory(**kw)
    for p in prompts:
        eng.add_request(p, max_new_tokens=max_new)
    n = 0
    while eng.scheduler.has_work():
        eng.step()
        n += 1
    return n


# ------------------------------------------------------------ draw replay

class TestReplayKeyState:
    def test_draw_index_is_the_delivered_count(self):
        eng = _engine(journal=RequestJournal())
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6,
                              temperature=0.8, top_k=5, seed=3)
        while eng.scheduler.has_work():
            eng.step()
            delivered = eng._journal.delivered(rid)
            if eng._pending is None:
                assert eng._draws[rid] == replay_key_state(3, len(delivered))
        assert replay_key_state(3, 4) == replay_key_state(9, 4) == 4

    def test_snapshot_replays_from_delivered_not_live_draws(self):
        """snapshot() never trusts the live draw index: a block past the
        budget or a spill lost to the crash leaves it AHEAD of what was
        delivered."""
        eng = _engine(journal=RequestJournal())
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6,
                              temperature=0.8, top_k=5, seed=3)
        eng.step()
        eng._draws[rid] += 5
        rs = next(r for r in eng.snapshot().requests if r.request_id == rid)
        assert rs.draws == len(eng._journal.delivered(rid)) == 1


# ------------------------------------------------------------ journal

def _records(j):
    return [dataclasses.asdict(j.record(r)) for r in j.request_ids()]


def _write_journal(cls, path):
    j = cls(path=path)
    j.submit(request_id=5, prompt=[1, 2], **dict(_SUBMIT_KW, seed=11))
    j.tokens(5, [7, 8], t_wall=123.0)
    j.submit(request_id=6, prompt=[3], arrival_wall=50.0,
             **dict(_SUBMIT_KW, eos_token_id=2, deadline_wall=99.5))
    j.terminal(6, "cancelled", error="caller")
    j.submit(request_id=9, prompt=[4, 4], key_splits=3, arrival_wall=51.0,
             **_SUBMIT_KW)
    j.tokens(9, [1], t_wall=124.0)
    j.restart(1, "manual", 0.5, readmitted=1, replayed_tokens=4)
    j.close()


class TestRequestJournal:
    def test_submit_tokens_terminal_flow(self):
        j = RequestJournal()
        j.submit(request_id=1, prompt=[1, 2, 3], **_SUBMIT_KW)
        assert j.known(1) and not j.known(2) and j.record(1).live
        j.tokens(1, [4, 5])
        j.tokens(1, [6])
        assert j.delivered(1) == [4, 5, 6]
        assert [r.request_id for r in j.live_records()] == [1]
        j.terminal(1, "finished")
        assert j.record(1).status == "finished" and j.live_records() == []
        assert j.check_consistency()

    def test_duplicate_submit_and_bad_terminal_raise(self):
        j = RequestJournal()
        j.submit(request_id=1, prompt=[1], **_SUBMIT_KW)
        with pytest.raises(ValueError, match="already journaled"):
            j.submit(request_id=1, prompt=[1], **_SUBMIT_KW)
        with pytest.raises(ValueError, match="not a terminal status"):
            j.terminal(1, "running")
        j.terminal(1, "cancelled")
        j.terminal(1, "finished")      # first terminal wins
        assert j.record(1).status == "cancelled"

    def test_is_complete_and_corruption_audit(self):
        j = RequestJournal()
        kw = dict(_SUBMIT_KW, max_new_tokens=3, eos_token_id=9)
        j.submit(request_id=1, prompt=[1], **kw)
        assert not j.record(1).is_complete()
        j.tokens(1, [4, 9])
        assert j.record(1).is_complete()
        j.submit(request_id=2, prompt=[1], **kw)
        j.tokens(2, [4, 5, 6, 7])
        with pytest.raises(RuntimeError, match="over its budget"):
            j.check_consistency()
        j2 = RequestJournal()
        j2.submit(request_id=1, prompt=[1], **dict(_SUBMIT_KW,
                                                   eos_token_id=9))
        j2.tokens(1, [9, 4])
        with pytest.raises(RuntimeError, match="past EOS"):
            j2.check_consistency()

    def test_file_backed_round_trip(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        _write_journal(RequestJournal, path)
        j2 = RequestJournal.load(path)
        assert j2.request_ids() == [5, 6, 9]
        assert j2.delivered(5) == [7, 8] and j2.record(5).seed == 11
        assert j2.record(5).first_token_wall == 123.0
        assert j2.record(6).status == "cancelled"
        assert j2.record(6).error == "caller"
        assert j2.record(9).key_splits == 3
        assert j2.restarts[0]["reason"] == "manual"
        j2.tokens(5, [9])
        j2.close()
        j3 = RequestJournal.load(path)
        assert j3.delivered(5) == [7, 8, 9]
        j3.close()

    @pytest.mark.parametrize("writer,reader", [
        (RequestJournal, JRequestJournal), (JRequestJournal, RequestJournal)],
        ids=["port_to_jax", "jax_to_port"])
    def test_each_package_reads_the_others_file(self, tmp_path, writer,
                                                reader):
        path = str(tmp_path / "journal.jsonl")
        _write_journal(writer, path)
        a, b = writer.load(path), reader.load(path)
        assert _records(a) == _records(b)
        assert a.restarts == b.restarts
        assert b.check_consistency()
        a.close()
        b.close()

    def test_engine_journal_is_read_by_the_jax_package(self, tmp_path):
        path = str(tmp_path / "engine.jsonl")
        j = RequestJournal(path=path)
        eng = _engine(journal=j)
        rids = [eng.add_request(p, max_new_tokens=6,
                                **_sampling_kw(i, i == 1))
                for i, p in enumerate(_PROMPTS)]
        out = eng.run()
        j.close()
        jj = JRequestJournal.load(path)
        assert _records(jj) == _records(j)
        for r in rids:
            rec = jj.record(r)
            assert rec.status == "finished"
            assert rec.prompt + rec.delivered == out[r]
        assert jj.record(rids[1]).seed == 101
        jj.close()

    def test_engine_journals_at_delivery_not_computation(self):
        eng = _engine(journal=RequestJournal())
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        delivered = []
        while (eng.scheduler.has_work() or eng._pending is not None
               or eng._spill):
            delivered += [t for r, t in eng.step() if r == rid]
            assert eng._journal.delivered(rid) == delivered
        assert eng._journal.record(rid).status == "finished"
        assert eng.output(rid) == list(_PROMPTS[0]) + delivered


# ------------------------------------------------- torn journal tail

def _torn_journal_file(cls, path):
    j = cls(path=path)
    j.submit(request_id=1, prompt=[1, 2, 3], **dict(_SUBMIT_KW, seed=11))
    j.tokens(1, [7, 8], t_wall=50.0)
    j.submit(request_id=2, prompt=[4], **_SUBMIT_KW)
    j.terminal(2, "finished")
    j.close()


def _load_outcome(cls, path):
    """(records or error text, warning texts, file bytes after)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            j = cls.load(path)
            out = _records(j)
            j.close()
        except ValueError as e:
            out = f"ValueError: {str(e).split(':')[0]}"
    return out, [str(w.message) for w in caught], open(path, "rb").read()


class TestTornJournalLine:
    @pytest.mark.parametrize("tail", [
        b'{"ev": "tokens", "rid": 1, "toks": [9, 1', b'{"ev": "term',
        b'{"ev": "tokens", "rid"', b'\xff\xfe garbage'],
        ids=["mid_record", "mid_key", "mid_field", "garbage"])
    def test_torn_tail_same_in_both_packages(self, tmp_path, tail):
        _torn_journal_file(RequestJournal, str(tmp_path / "intact.jsonl"))
        intact = (tmp_path / "intact.jsonl").read_bytes()
        outcomes = []
        for i, cls in enumerate((RequestJournal, JRequestJournal)):
            path = str(tmp_path / f"torn{i}.jsonl")
            with open(path, "wb") as fh:
                fh.write(intact + tail)
            records, warned, after = _load_outcome(cls, path)
            assert after == intact         # the tail is truncated off
            assert len(warned) == 1 and "torn final record" in warned[0]
            assert [r["request_id"] for r in records] == [1, 2]
            outcomes.append((records, after))
        assert outcomes[0] == outcomes[1]

    def test_appends_resume_after_a_truncated_tail(self, tmp_path):
        path = str(tmp_path / "torn.jsonl")
        _torn_journal_file(RequestJournal, path)
        with open(path, "ab") as fh:
            fh.write(b'{"ev": "tokens", "rid": 1, "toks": [9, 1')
        with pytest.warns(RuntimeWarning, match="torn final record"):
            j = RequestJournal.load(path)
        assert j.delivered(1) == [7, 8]
        j.tokens(1, [9])
        j.close()
        assert JRequestJournal.load(path).delivered(1) == [7, 8, 9]

    def test_corruption_before_the_tail_is_fatal_in_both(self, tmp_path):
        for i, cls in enumerate((RequestJournal, JRequestJournal)):
            path = str(tmp_path / f"mid{i}.jsonl")
            _torn_journal_file(RequestJournal, path)
            lines = open(path, "rb").read().splitlines(keepends=True)
            lines[1] = lines[1][:len(lines[1]) // 2] + b"\n"
            with open(path, "wb") as fh:
                fh.writelines(lines)
            with pytest.raises(ValueError, match="corrupt journal record"):
                cls.load(path)


# --------------------------------------------------- snapshot / restore

class TestSnapshotRestore:
    @pytest.mark.parametrize("seeded", [False, True])
    @pytest.mark.parametrize("horizon", [1, 8])
    def test_restore_resumes_bit_identically(self, seeded, horizon):
        ref, _ = _uninterrupted(_engine, seeded=seeded,
                                decode_horizon=horizon)
        eng = _engine(decode_horizon=horizon, journal=RequestJournal())
        rids = [eng.add_request(p, max_new_tokens=6,
                                **_sampling_kw(i, seeded))
                for i, p in enumerate(_PROMPTS)]
        for _ in range(4):
            eng.step()
        snap = EngineSnapshot.from_json(eng.snapshot().to_json())
        eng2 = _engine(decode_horizon=horizon, journal=eng._journal)
        assert set(eng2.restore(snap)) <= set(rids)
        out = eng2.run()
        for want, rid in zip(ref, rids):
            assert out[rid] == want, (seeded, horizon, rid)
            assert eng2.status(rid)[0] == "finished"
        eng2.scheduler.check_consistency()
        eng._journal.check_consistency()

    def test_complete_but_unfinalized_request_is_reconstructed(self):
        j = RequestJournal()
        j.submit(request_id=1, prompt=[1, 2, 3],
                 **dict(_SUBMIT_KW, max_new_tokens=3))
        j.tokens(1, [4, 5, 6])
        snap = _engine(journal=j).snapshot()
        eng = _engine(journal=j)
        assert eng.restore(snap) == []
        assert eng.status(1)[0] == "finished"
        assert eng.output(1) == [1, 2, 3, 4, 5, 6]
        assert j.record(1).status == "finished"
        assert not eng.scheduler.has_work()

    def test_snapshot_and_restore_preconditions(self):
        with pytest.raises(RuntimeError, match="journal"):
            _engine().snapshot()
        eng = _engine(journal=RequestJournal())
        eng.add_request(_PROMPTS[0], max_new_tokens=4)
        snap = eng.snapshot()
        with pytest.raises(RuntimeError, match="fresh engine"):
            eng.restore(snap)
        small = _engine(max_seq_len=32, journal=RequestJournal())
        with pytest.raises(ValueError, match="max_seq_len"):
            small.restore(snap)

    def test_restored_ids_never_collide_with_new_requests(self):
        eng = _engine(journal=RequestJournal())
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        eng.step()
        snap = eng.snapshot()
        eng2 = _engine(journal=eng._journal)
        eng2.restore(snap)
        fresh = eng2.add_request(_PROMPTS[1], max_new_tokens=2)
        assert fresh > rid
        out = eng2.run()
        assert len(out[fresh]) == len(_PROMPTS[1]) + 2

    def test_adopt_request_continues_the_stream(self):
        ref, _ = _uninterrupted(_engine, seeded=True)
        eng = _engine(journal=RequestJournal())
        got = []
        for i, p in enumerate(_PROMPTS):
            # the first half of the stream was delivered elsewhere
            rid = eng.adopt_request(prompt=p, delivered=ref[i][len(p):][:3],
                                    max_new_tokens=6, temperature=0.8,
                                    top_k=5, seed=100 + i)
            got.append(rid)
        out = eng.run()
        for i, rid in enumerate(got):
            assert out[rid] == ref[i]
            assert eng._journal.record(rid).key_splits == 3
        with pytest.raises(ValueError, match="nothing left"):
            eng.adopt_request(prompt=[1], delivered=[2, 3],
                              max_new_tokens=2, seed=0)

    def test_adopted_request_restores_at_its_draw_index(self):
        """A restore replays an adopted request from `key_splits +
        len(delivered)`, so a fold of a fold continues its stream (the
        reference's snapshot replays from `len(delivered)` alone: ROADMAP,
        facts of the reference)."""
        ref, _ = _uninterrupted(_engine, seeded=True)
        eng = _engine(journal=RequestJournal())
        rids = [eng.adopt_request(prompt=p, delivered=ref[i][len(p):][:3],
                                  max_new_tokens=6, temperature=0.8,
                                  top_k=5, seed=100 + i)
                for i, p in enumerate(_PROMPTS)]
        for _ in range(4):
            eng.step()
        snap = EngineSnapshot.from_json(eng.snapshot().to_json())
        assert [r.draws for r in snap.requests] == [
            3 + len(eng._journal.delivered(r)) for r in rids]
        eng2 = _engine(journal=eng._journal)
        eng2.restore(snap)
        out = eng2.run()
        for i, rid in enumerate(rids):
            assert out[rid] == ref[i]


# ------------------------------------- the slice against the JAX package

class TestSupervisedAgainstJax:
    @pytest.mark.parametrize("chunked", [False, True],
                             ids=["unchunked", "chunked_ragged"])
    def test_kill_at_every_step_matches_the_jax_engine(self, chunked):
        kw = _CHUNKED if chunked else {}
        want, _ = _uninterrupted(_jengine, **kw)
        steps = _steps_of(_engine, **kw)
        assert steps == _steps_of(_jengine, **kw)
        for kill in range(steps):
            runs = []
            for sup_cls, make, inj, jr in (
                    (JEngineSupervisor, _jengine, JFaultInjector,
                     JRequestJournal),
                    (EngineSupervisor, _engine, FaultInjector,
                     RequestJournal)):
                sup, rids, streamed = _supervised(
                    sup_cls, make, inj().fail_at("device_lost", kill),
                    journal=jr(), **kw)
                assert [r["reason"] for r in sup.restarts] == \
                    ["fatal_fault"], kill
                outs = [sup.output(r) for r in rids]
                for i, r in enumerate(rids):
                    # exactly once: the streamed view is the whole stream
                    assert list(_PROMPTS[i]) + streamed[r] == outs[i]
                    assert sup.status(r)[0] == "finished"
                sup.journal.check_consistency()
                sup.engine.scheduler.check_consistency()
                runs.append((outs, sup.restarts[0]["replayed_tokens"]))
            assert runs[1][0] == runs[0][0] == want, kill
            assert runs[1][1] == runs[0][1], kill


# ------------------------------------------------- kill-anywhere chaos

class TestKillAnywhereParity:
    """A `device_lost` fatal injected at every interesting step leaves
    every stream identical to an uninterrupted run, exactly once, with the
    scheduler and journal invariants clean after the restore."""

    def _chaos(self, kills, *, prompts=_PROMPTS, seeded=False, max_new=6,
               **engine_kw):
        ref, ref_eng = _uninterrupted(_engine, prompts, max_new, seeded,
                                      **engine_kw)
        for kill in kills:
            fi = FaultInjector().fail_at("device_lost", kill)
            sup, rids, streamed = _supervised(
                EngineSupervisor, _engine, fi, prompts, max_new, seeded,
                journal=RequestJournal(), **engine_kw)
            assert len(sup.restarts) == 1, (kill, sup.restarts)
            assert sup.restarts[0]["reason"] == "fatal_fault"
            for i, rid in enumerate(rids):
                assert sup.output(rid) == ref[i], (kill, rid)
                assert list(prompts[i]) + streamed[rid] == ref[i], (kill,
                                                                    rid)
                assert sup.status(rid)[0] == "finished"
            sup.engine.scheduler.check_consistency()
            sup.journal.check_consistency()
        return ref_eng

    @pytest.mark.parametrize("seeded", [False, True])
    def test_kill_anywhere_plain(self, seeded):
        self._chaos(range(6), seeded=seeded)

    @pytest.mark.parametrize("horizon,kills", [(1, (1, 3, 5)),
                                               (8, (1, 3, 4))])
    def test_kill_anywhere_across_horizons(self, horizon, kills):
        self._chaos(kills, seeded=True, decode_horizon=horizon)

    @pytest.mark.parametrize("ragged", [False, True])
    def test_kill_during_chunked_prefill(self, ragged):
        self._chaos((1, 2, 4), seeded=True, enable_ragged_step=ragged,
                    **_CHUNKED)

    def test_kill_under_preemption_pressure(self):
        rng = np.random.RandomState(41)
        vocab = LlamaConfig.tiny().vocab_size
        prompts = [rng.randint(0, vocab, (n,)).tolist() for n in (10, 8, 12)]
        ref_eng = self._chaos(
            (2, 4, 6), prompts=prompts, max_new=12, page_size=8,
            max_batch_size=3, max_seq_len=32, prefill_buckets=(16, 32),
            num_pages=8)
        assert ref_eng.stats()["preemptions"] > 0

    def test_kill_while_sharing_prefix_pages(self):
        self._chaos((1, 3, 5), prompts=_SHARED_PROMPTS,
                    enable_prefix_caching=True)

    @pytest.mark.parametrize("chunked", [False, True])
    def test_kill_anywhere_with_speculation(self, chunked):
        # the port drains speculative records before schedule(), so the
        # oracle is its own uninterrupted spec run (which equals spec-off)
        kw = dict(spec_config=SpecConfig(lookahead=4), max_seq_len=96,
                  **(_CHUNKED if chunked else {}))
        prompts = [p * 3 for p in _PROMPTS[:2]]
        spec_on, _ = _uninterrupted(_engine, prompts, 12, **kw)
        spec_off, _ = _uninterrupted(_engine, prompts, 12, max_seq_len=96)
        assert spec_on == spec_off
        self._chaos(range(5), prompts=prompts, max_new=12, seeded=True,
                    **kw)


# ------------------------------------------------- supervisor ladder

class TestWatchdog:
    def test_slow_step_triggers_watchdog_restart(self):
        class FakeClock:
            t, tick = 0.0, 10.0

            def __call__(self):
                self.t += self.tick
                return self.t

        clk = FakeClock()
        sup = EngineSupervisor(_engine, journal=RequestJournal(),
                               max_step_wall_s=1.0, clock=clk)
        sup._mid_restore_hook = lambda s: setattr(clk, "tick", 0.0)
        ref, _ = _uninterrupted(_engine)
        rids = [sup.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        out = sup.run()
        assert [r["reason"] for r in sup.restarts] == ["watchdog"]
        assert [out[r] for r in rids] == ref


class TestFaultStorm:
    def test_fault_rate_threshold_restarts(self):
        fi = FaultInjector(seed=5).fail_every("dispatch", 3)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal(),
                               fault_rate_threshold=2, fault_rate_window=16)
        ref, _ = _uninterrupted(_engine)
        rids = [sup.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        out = sup.run()
        assert sup.restarts and all(r["reason"] == "fault_storm"
                                    for r in sup.restarts)
        assert [out[r] for r in rids] == ref
        assert all(sup.status(r)[0] == "finished" for r in rids)
        sup.journal.check_consistency()

    def test_max_restarts_gives_up(self):
        fi = FaultInjector().fail_every("device_lost", 1)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal(), max_restarts=2)
        sup.add_request(_PROMPTS[0], max_new_tokens=6)
        with pytest.raises(EngineDead, match="max_restarts") as ei:
            for _ in range(10):
                sup.step()
        assert ei.value.restarts == 2 and len(sup.restarts) == 2

    def test_fatal_faults_bypass_retry_and_quarantine(self):
        fi = FaultInjector().fail_at("dispatch", 0, fatal=True)
        eng = _engine(fault_injector=fi)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=4)
        with pytest.raises(Exception) as ei:
            for _ in range(10):
                eng.step()
        assert is_fatal(ei.value)
        assert eng.status(rid)[0] in ("waiting", "running")
        assert fi.counts["dispatch"] == 1          # never retried


class TestManualRestart:
    def test_operator_restart_mid_run_keeps_parity(self):
        ref, _ = _uninterrupted(_engine)
        reg = MetricsRegistry()
        sup = EngineSupervisor(_engine, journal=RequestJournal(),
                               metrics=reg)
        rids = [sup.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        sup.step()
        sup.step()
        sup.restart()
        out = sup.run()
        assert [r["reason"] for r in sup.restarts] == ["manual"]
        assert [out[r] for r in rids] == ref
        assert reg.get("serving_engine_restarts_total",
                       {"reason": "manual"}).value == 1
        assert reg.get("serving_recovery_seconds").count == 1
        assert reg.get("serving_recovery_replayed_tokens_total").value == \
            sup.restarts[0]["replayed_tokens"] > 0
        info = sup.restarts[0]
        parts = sum(info[k] for k in ("t_salvage_s", "t_snapshot_s",
                                      "t_factory_s", "t_restore_s"))
        assert 0 < parts <= info["t_recover_s"]
        assert sup.stats()["num_restarts"] == 1

    def test_the_wreck_releases_its_pools(self):
        engines = []

        def factory():
            engines.append(_engine())
            return engines[-1]

        sup = EngineSupervisor(factory, journal=RequestJournal())
        sup.add_request(_PROMPTS[0], max_new_tokens=6)
        sup.step()
        sup.restart()
        assert engines[0].cache.pools == [] and engines[0]._pending is None
        assert len(engines[1].cache.pools) == LlamaConfig.tiny() \
            .num_hidden_layers
        sup.run()


# ------------------------------------- deadlines / cancels over restore

class TestDeadlineAcrossRestore:
    def test_deadline_passing_during_outage_expires_not_resurrects(self):
        fi = FaultInjector().fail_at("device_lost", 0)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal())
        doomed = sup.add_request(_PROMPTS[0], max_new_tokens=6,
                                 deadline_s=0.4)
        safe = sup.add_request(_PROMPTS[1], max_new_tokens=6)
        sup._mid_restore_hook = lambda s: time.sleep(0.5)
        ref, _ = _uninterrupted(_engine, prompts=[_PROMPTS[1]])
        out = sup.run()
        assert sup.status(doomed)[0] == "expired"
        assert sup.journal.record(doomed).status == "expired"
        assert sup.restarts[0]["readmitted"] == 1
        assert out[safe] == ref[0] and sup.status(safe)[0] == "finished"

    def test_live_deadline_survives_restore_and_finishes(self):
        fi = FaultInjector().fail_at("device_lost", 1)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal())
        rid = sup.add_request(_PROMPTS[0], max_new_tokens=6,
                              deadline_s=30.0)
        out = sup.run()
        assert len(sup.restarts) == 1 and sup.status(rid)[0] == "finished"
        assert sup.engine.requests[rid].deadline_t is not None
        assert len(out[rid]) == len(_PROMPTS[0]) + 6


class TestCancelMidRestore:
    def test_cancel_issued_mid_restore_wins_over_readmission(self):
        ref, _ = _uninterrupted(_engine)
        fi = FaultInjector().fail_at("device_lost", 4)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal())
        rids = [sup.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        victim = rids[1]
        sup._mid_restore_hook = lambda s: s.cancel(victim)
        out = sup.run()
        assert len(sup.restarts) == 1
        assert sup.status(victim)[0] == "cancelled"
        assert victim not in [r.request_id
                              for r in sup.engine.scheduler.waiting]
        assert out[victim] == ref[1][:len(out[victim])]
        for i, rid in enumerate(rids):
            if rid != victim:
                assert out[rid] == ref[i]
        sup.engine.scheduler.check_consistency()
        sup.journal.check_consistency()


# -------------------------------------------------- dead supervisor

class TestDeadSupervisorStats:
    def _dead_supervisor(self):
        fi = FaultInjector().fail_every("device_lost", 1)
        sup = EngineSupervisor(lambda: _engine(fault_injector=fi),
                               journal=RequestJournal(), max_restarts=0)
        rids = [sup.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS[:2]]
        with pytest.raises(EngineDead, match="giving up"):
            sup.step()
        return sup, rids

    def test_stats_reports_terminal_reason_instead_of_raising(self):
        sup, _ = self._dead_supervisor()
        assert sup.dead and sup.engine is None
        s = sup.stats()
        assert s["dead"] is True and "fatal_fault" in s["dead_reason"]
        assert s["num_restarts"] == 0
        assert s["num_requests"] == 2 and s["num_live"] == 2
        assert s["num_finished"] == 0

    def test_queries_answer_from_journal_after_death(self):
        sup, rids = self._dead_supervisor()
        for i, rid in enumerate(rids):
            assert sup.status(rid)[0] == "waiting"
            assert sup.output(rid) == _PROMPTS[i]
        assert sup.has_work() is False
        assert sup.cancel(rids[0]) is True
        assert sup.status(rids[0])[0] == "cancelled"
        assert sup.cancel(rids[0]) is False
        s = sup.stats()
        assert s["terminal"] == {"cancelled": 1} and s["num_live"] == 1

    def test_drive_entry_points_raise_engine_dead(self):
        sup, _ = self._dead_supervisor()
        for call in (lambda: sup.add_request([1, 2], max_new_tokens=2),
                     sup.step, sup.restart):
            with pytest.raises(EngineDead, match="engine is dead"):
                call()
        exc = pytest.raises(EngineDead, sup.step).value
        assert exc.reason is not None and "fatal_fault" in exc.reason


# --------------------------------------------------- zero-cost-disabled

class TestZeroCostWhenDisabled:
    def test_journal_free_engine_never_touches_recovery(self, monkeypatch):
        """Poison serving.recovery and the engine's recovery methods: an
        engine without a journal serves a request without touching them."""
        import paddle_tpu_torch.serving as serving_pkg
        import paddle_tpu_torch.serving.engine as eng_mod

        poison = types.ModuleType("paddle_tpu_torch.serving.recovery")

        def _boom(*a, **kw):
            raise AssertionError("recovery code on a journal-free engine")

        poison.__getattr__ = _boom
        monkeypatch.setitem(sys.modules, "paddle_tpu_torch.serving.recovery",
                            poison)
        monkeypatch.setattr(serving_pkg, "recovery", poison, raising=False)
        for meth in ("_journal_delivery", "salvage", "snapshot", "restore",
                     "release_pools"):
            monkeypatch.setattr(eng_mod.ServingEngine, meth, _boom)
        eng = _engine()
        rid = eng.add_request([1, 2, 3], max_new_tokens=4)
        out = eng.run()
        assert len(out[rid]) == 7 and eng.status(rid)[0] == "finished"
        eng2 = _engine(journal=RequestJournal())
        eng2.add_request([1, 2, 3], max_new_tokens=4)
        with pytest.raises(AssertionError, match="recovery code"):
            eng2.run()

    def test_package_import_leaves_recovery_unloaded(self):
        probe = ("import sys, paddle_tpu_torch.serving as s; "
                 "print('paddle_tpu_torch.serving.recovery' in sys.modules);"
                 " s.FaultInjector; s.EngineDead; "
                 "print('paddle_tpu_torch.serving.recovery' in sys.modules);"
                 " s.RequestJournal; "
                 "print('paddle_tpu_torch.serving.recovery' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", probe],
                             capture_output=True, text=True, timeout=300,
                             cwd=Path(__file__).resolve().parent.parent)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False", "False", "True"]


# --------------------------------------------------- device selection

class TestDevice:
    def test_factory_engines_raise_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            EngineSupervisor(lambda: ServingEngine(_port_llama()),
                             journal=RequestJournal())
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(_port_llama(), journal=RequestJournal(),
                          fault_injector=FaultInjector())

    def test_supervisor_on_the_cpu_when_asked(self):
        sup = EngineSupervisor(
            lambda: ServingEngine(_port_llama(), device="cpu",
                                  **{**_KNOBS, "fault_injector": None}))
        assert sup.engine.device == torch.device("cpu")
        rid = sup.add_request(_PROMPTS[0], max_new_tokens=3)
        assert len(sup.run()[rid]) == len(_PROMPTS[0]) + 3
