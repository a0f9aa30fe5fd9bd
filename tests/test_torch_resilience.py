"""paddle_tpu_torch.serving's resilience layer (serving/resilience.py and
its hooks in the engine, scheduler, allocator and prefix cache), mirrored
from tests/test_resilience.py.

Against the JAX package, on the same weights:
- the port's FaultInjector fires at exactly the calls the JAX package's
  does, for `fail_at`, `fail_every` and `fail_rate`, over one seed and one
  call sequence;
- transient, persistent-prefill, persistent-drain, alloc and prefix-match
  faults on the port's engine and the JAX engine under one schedule give
  the same request statuses, the same fired faults, and survivors' greedy
  streams token-identical.

Port against port: the allocator and scheduler audits, backpressure,
cancellation in every state, deadlines at decode horizons 1 and 8,
queue-wait shedding, the preemption-storm guards, seeded chaos survivor
parity with the pools audited after every step, an engine without an
injector or deadlines running no resilience code, and the terminal counts
with metrics on and off.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import ServingEngine as JServingEngine

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (
    BlockAllocator, EngineOverloaded, FaultInjector, InjectedFault,
    Request, SamplingParams, Scheduler, ServingEngine, describe_fault,
    is_fatal, is_transient,
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
_SHARED = [5, 1, 3, 7, 2, 9, 4, 6]      # two full pages at page size 4


def _reference(prompts=_PROMPTS, max_new_tokens=6, **kw):
    eng = _engine(**kw)
    rids = [eng.add_request(p, max_new_tokens=max_new_tokens)
            for p in prompts]
    return eng.run(), rids


# -------------------------------------------- FaultInjector against JAX's

def _fire_trace(cls, rules, seed, sites, calls):
    fi = cls(seed=seed)
    for kind, site, arg, kw in rules:
        getattr(fi, kind)(site, arg, **kw)
    hits = []
    for i in range(calls):
        site = sites[i % len(sites)]
        try:
            fi.check(site)
        except Exception as e:  # noqa: BLE001 (either package's fault)
            hits.append((site, e.index, e.transient, e.fatal, str(e)))
    return hits, fi.log, dict(fi.counts), dict(fi.fired)


class TestInjectorAgainstJax:
    @pytest.mark.parametrize("rules", [
        [("fail_at", "alloc", 2, {}), ("fail_at", "dispatch", 5,
                                       dict(transient=False))],
        [("fail_every", "dispatch", 3, {}), ("fail_every", "drain", 4,
                                             dict(fatal=True))],
        [("fail_rate", "drain", 0.5, {}), ("fail_rate", "alloc", 0.3, {}),
         ("fail_rate", "device_lost", 0.1, {})],
    ], ids=["fail_at", "fail_every", "fail_rate"])
    @pytest.mark.parametrize("seed", [0, 3, 42])
    def test_fires_at_the_same_calls(self, rules, seed):
        sites = ("drain", "alloc", "dispatch", "device_lost", "alloc")
        got = _fire_trace(FaultInjector, rules, seed, sites, 300)
        want = _fire_trace(JFaultInjector, rules, seed, sites, 300)
        assert got == want
        assert got[0]                      # the schedule fired at all


class TestFaultInjector:
    def test_fail_at_fires_exactly_once(self):
        fi = FaultInjector().fail_at("alloc", 2)
        fi.check("alloc")
        fi.check("alloc")
        with pytest.raises(InjectedFault) as ei:
            fi.check("alloc")
        assert ei.value.site == "alloc" and ei.value.index == 2
        assert ei.value.transient
        fi.check("alloc")
        assert fi.counts["alloc"] == 4
        assert fi.fired == {"alloc": 1}
        assert fi.log == [("alloc", 2, True)]

    def test_persistent_fatal_flags_and_is_transient(self):
        fi = FaultInjector().fail_at("drain", 0, transient=False)
        with pytest.raises(InjectedFault) as ei:
            fi.check("drain")
        assert not is_transient(ei.value) and not is_fatal(ei.value)
        assert is_transient(InjectedFault("drain", 1))
        assert not is_transient(RuntimeError("boom"))
        lost = FaultInjector().fail_at("device_lost", 0)
        with pytest.raises(InjectedFault) as ei:
            lost.check("device_lost")
        assert is_fatal(ei.value) and not is_transient(ei.value)
        assert describe_fault(ei.value) == {
            "exc": "InjectedFault", "transient": False, "fatal": True}

    def test_bad_rules_rejected(self):
        with pytest.raises(ValueError, match="unknown fault site"):
            FaultInjector().fail_at("nonsense", 0)
        with pytest.raises(ValueError, match="n >= 1"):
            FaultInjector().fail_every("alloc", 0)
        with pytest.raises(ValueError, match="p in"):
            FaultInjector().fail_rate("alloc", 1.5)


# ----------------------------------------- engine faults against the JAX

def _faulted_pair(arm, *, prompts=_PROMPTS, max_new=6, warm=None,
                  drain_only=False, **kw):
    """Run the same prompts and fault schedule (`arm` builds it on either
    package's FaultInjector) through the JAX engine and the port's.
    Returns per engine (statuses, errors, outputs, injector)."""
    res = []
    for make, inj in ((_jengine, JFaultInjector), (_engine, FaultInjector)):
        fi = arm(inj())
        if drain_only:
            eng = make(**kw)
            eng._faults = fi                   # arm ONLY the drain site
        else:
            eng = make(fault_injector=fi, **kw)
        if warm is not None:
            eng.add_request(warm, max_new_tokens=1)
            eng.run()
        rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
        out = eng.run()
        eng.scheduler.check_consistency()
        res.append(([eng.status(r)[0] for r in rids],
                    [eng.status(r)[1] for r in rids],
                    [out[r] for r in rids], fi))
    return res


class TestEngineFaultsAgainstJax:
    def test_transient_dispatch_faults(self):
        (js, _, jout, jfi), (ts, _, tout, tfi) = _faulted_pair(
            lambda fi: fi.fail_every("dispatch", 3))
        assert ts == js == ["finished"] * 3
        assert tout == jout
        assert tfi.log == jfi.log and tfi.fired["dispatch"] >= 2

    def test_persistent_prefill_fault(self):
        (js, je, jout, jfi), (ts, te, tout, tfi) = _faulted_pair(
            lambda fi: fi.fail_at("dispatch", 0, transient=False))
        assert ts == js == ["failed", "finished", "finished"]
        assert te[0] == je[0] and "InjectedFault" in te[0]
        assert tout[1:] == jout[1:]
        assert tfi.log == jfi.log

    def test_persistent_drain_fault(self):
        (js, je, jout, _), (ts, te, tout, _) = _faulted_pair(
            lambda fi: fi.fail_every("drain", 2, transient=False),
            drain_only=True)
        assert ts == js and "failed" in ts
        assert [e is None for e in te] == [e is None for e in je]
        for s, a, b in zip(ts, tout, jout):
            if s == "finished":
                assert a == b

    def test_alloc_faults_degrade_losslessly(self):
        (js, _, jout, jfi), (ts, _, tout, tfi) = _faulted_pair(
            lambda fi: fi.fail_every("alloc", 2))
        assert ts == js == ["finished"] * 3
        assert tout == jout
        assert tfi.log == jfi.log and tfi.fired["alloc"] >= 1

    def test_prefix_match_faults_degrade_to_misses(self):
        (js, _, jout, jfi), (ts, _, tout, tfi) = _faulted_pair(
            lambda fi: fi.fail_every("prefix_match", 1),
            prompts=[_SHARED + [11, 12]], max_new=4, warm=_SHARED + [1],
            enable_prefix_caching=True, num_pages=128)
        assert ts == js == ["finished"]
        assert tout == jout
        assert tfi.log == jfi.log and tfi.fired["prefix_match"] >= 1


# ------------------------------------------------------- invariant audits

class TestCheckConsistency:
    def test_sound_allocator_passes(self):
        a = BlockAllocator(8)
        pages = [a.alloc() for _ in range(3)]
        a.acquire(pages[0])
        assert a.check_consistency() is True
        assert a.live_pages() == sorted(pages)
        a.free(pages[0])
        a.free_all(pages)
        assert a.check_consistency() is True and a.live_pages() == []

    def test_detects_double_accounting(self):
        a = BlockAllocator(8)
        p = a.alloc()
        a._free.append(p)
        with pytest.raises(RuntimeError, match="both free and referenced"):
            a.check_consistency()

    def test_detects_leak(self):
        a = BlockAllocator(8)
        a.alloc()
        del a._refs[next(iter(a._refs))]
        with pytest.raises(RuntimeError, match="leak or double-account"):
            a.check_consistency()

    def test_scheduler_audit_catches_status_mismatch(self):
        a = BlockAllocator(8)
        s = Scheduler(a, page_size=4, max_batch_size=2, max_pages_per_seq=2)
        req = Request(prompt=[1, 2], max_new_tokens=2,
                      sampling=SamplingParams())
        req.pages = [a.alloc()]
        s.running.append(req)
        with pytest.raises(RuntimeError, match="running queue with status"):
            s.check_consistency()
        req.status = "running"
        assert s.check_consistency() is True

    def test_alloc_site_fires_once_per_entry(self):
        a = BlockAllocator(8)
        fi = FaultInjector().fail_at("alloc", 1)
        a.bind_faults(fi)
        assert len(a.alloc_n(3)) == 3
        with pytest.raises(InjectedFault):
            a.alloc()
        assert a.alloc() is not None and fi.counts["alloc"] == 3
        assert a.num_used == 4 and a.check_consistency()


# --------------------------------------------------- backpressure/overload

class TestOverload:
    def test_bounded_queue_raises_typed_overload(self):
        eng = _engine(max_batch_size=1, max_waiting=2)
        eng.add_request(_PROMPTS[0])
        eng.add_request(_PROMPTS[1])
        with pytest.raises(EngineOverloaded, match="max_waiting=2"):
            eng.add_request(_PROMPTS[2])
        assert len(eng.requests) == 2
        out = eng.run()
        assert all(eng.status(r)[0] == "finished" for r in out)
        assert issubclass(EngineOverloaded, RuntimeError)
        assert not issubclass(EngineOverloaded, ValueError)

    def test_forced_add_bypasses_the_bound(self):
        s = Scheduler(BlockAllocator(8), page_size=4, max_batch_size=1,
                      max_pages_per_seq=4, max_waiting=1)
        s.add(Request(prompt=[1], max_new_tokens=2,
                      sampling=SamplingParams()))
        s.add(Request(prompt=[2], max_new_tokens=2,
                      sampling=SamplingParams()), force=True)
        assert len(s.waiting) == 2


# ------------------------------------------------------------ cancellation

class TestCancellation:
    def test_cancel_waiting_request(self):
        eng = _engine(max_batch_size=1)
        a = eng.add_request(_PROMPTS[0], max_new_tokens=4)
        b = eng.add_request(_PROMPTS[1], max_new_tokens=4)
        assert eng.cancel(b) is True
        assert eng.status(b) == ("cancelled", None)
        out = eng.run()
        assert eng.status(a)[0] == "finished"
        assert out[b] == list(_PROMPTS[1])

    def test_cancel_mid_block_drains_inflight_tokens_first(self):
        eng = _engine(decode_horizon=8)
        ref, _ = _reference(prompts=[_PROMPTS[0]], max_new_tokens=16)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=16)
        while eng._pending is None:
            eng.step()
        assert rid in eng._pending["rids"]
        assert eng.cancel(rid) is True
        got = eng.output(rid)
        assert len(got) > len(_PROMPTS[0])
        assert got == list(ref.values())[0][:len(got)]
        for _ in eng.stream():
            pass
        eng.scheduler.check_consistency()
        assert eng.cache.allocator.num_used == 0

    def test_cancel_unknown_and_terminal_returns_false(self):
        eng = _engine()
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=2)
        eng.run()
        assert eng.cancel(rid) is False
        assert eng.cancel(123456) is False
        assert eng.status(rid)[0] == "finished"

    def test_cancel_one_prefix_sharer_never_corrupts_survivors(self):
        pa, pb = _SHARED + [11, 12], _SHARED + [13, 14, 15]
        ref_eng = _engine(enable_prefix_caching=True, num_pages=128)
        ref_eng.add_request(_SHARED + [1], max_new_tokens=1)
        ref_eng.run()
        ref_eng.add_request(pa, max_new_tokens=8)
        rb = ref_eng.add_request(pb, max_new_tokens=8)
        ref = ref_eng.run()
        eng = _engine(enable_prefix_caching=True, num_pages=128)
        eng.add_request(_SHARED + [1], max_new_tokens=1)
        eng.run()
        a = eng.add_request(pa, max_new_tokens=8)
        b = eng.add_request(pb, max_new_tokens=8)
        while eng.requests[b].status != "running":
            eng.step()
        shared = [p for p in eng.requests[b].pages
                  if eng.cache.allocator.ref_count(p) > 1]
        assert shared
        assert eng.cancel(a) is True
        eng.scheduler.check_consistency()
        assert all(eng.cache.allocator.ref_count(p) >= 1 for p in shared)
        out = eng.run()
        assert eng.status(b)[0] == "finished" and out[b] == ref[rb]


# ------------------------------------------------- deadlines/load shedding

class TestDeadlines:
    def test_deadline_validation(self):
        eng = _engine()
        for bad in (0.0, -1.0):
            with pytest.raises(ValueError, match="deadline_s"):
                eng.add_request(_PROMPTS[0], deadline_s=bad)
        assert not eng.requests

    @pytest.mark.parametrize("horizon", [1, 8])
    def test_waiting_request_expires_before_admission(self, horizon):
        eng = _engine(max_batch_size=1, decode_horizon=horizon)
        a = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        b = eng.add_request(_PROMPTS[1], max_new_tokens=6, deadline_s=60.0)
        eng.requests[b].deadline_t = time.perf_counter() - 1.0
        out = eng.run()
        assert eng.status(b)[0] == "expired"
        assert out[b] == list(_PROMPTS[1])
        assert eng.status(a)[0] == "finished"
        eng.scheduler.check_consistency()

    @pytest.mark.parametrize("horizon", [1, 8])
    def test_running_request_expires_at_block_boundary(self, horizon):
        ref, _ = _reference(prompts=[_PROMPTS[0]], max_new_tokens=16,
                            decode_horizon=horizon)
        eng = _engine(decode_horizon=horizon)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=16,
                              deadline_s=60.0)
        while eng.requests[rid].status != "running":
            eng.step()
        eng.requests[rid].deadline_t = time.perf_counter() - 1.0
        for _ in eng.stream():
            pass
        assert eng.status(rid)[0] == "expired"
        got = eng.output(rid)
        assert len(got) < len(_PROMPTS[0]) + 16
        assert got == list(ref.values())[0][:len(got)]
        eng.scheduler.check_consistency()
        assert eng.cache.allocator.num_used == 0

    def test_queue_wait_shedding(self):
        eng = _engine(max_batch_size=1, max_queue_wait_s=30.0)
        a = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        b = eng.add_request(_PROMPTS[1], max_new_tokens=6)
        eng.requests[b].arrival_t -= 60.0
        eng.run()
        assert eng.status(a)[0] == "finished"
        assert eng.status(b)[0] == "shed"
        assert eng.stats()["terminal"]["shed"] == 1
        eng.scheduler.check_consistency()


# ------------------------------------------------------ preemption guards

class TestPreemptionGuards:
    def _sched(self, **kw):
        a = BlockAllocator(32)
        kw.setdefault("page_size", 4)
        kw.setdefault("max_batch_size", 2)
        kw.setdefault("max_pages_per_seq", 8)
        return a, Scheduler(a, **kw)

    def _running(self, sched, alloc, prompt, generated):
        req = Request(prompt=list(prompt), max_new_tokens=16,
                      sampling=SamplingParams())
        req.generated = list(generated)
        req.status = "running"
        req.pages = [alloc.alloc() for _ in range(2)]
        sched.running.append(req)
        return req

    def test_preempt_bucket_guard_raises_before_mutation(self):
        a, s = self._sched(max_prefill_tokens=8)
        req = self._running(s, a, range(6), range(4))
        with pytest.raises(RuntimeError, match="largest prefill bucket"):
            s._preempt(req)
        assert req.status == "running" and req in s.running
        assert len(req.pages) == 2 and req.generated == list(range(4))
        s.check_consistency()

    def test_preempt_within_bucket_still_works(self):
        a, s = self._sched(max_prefill_tokens=16)
        req = self._running(s, a, range(6), range(4))
        s._preempt(req)
        assert req.status == "waiting"
        assert req.prompt == list(range(6)) + list(range(4))
        s.check_consistency()

    def test_preemption_storm_parks_victim_at_back(self):
        a, s = self._sched(max_preemptions=2)
        other = Request(prompt=[1], max_new_tokens=2,
                        sampling=SamplingParams())
        s.waiting.append(other)
        req = self._running(s, a, range(4), [])
        req.preemptions = 2
        s._preempt(req)
        assert req.parked and req.preemptions == 3
        assert s.waiting == [other, req]

    def test_below_storm_limit_requeues_at_front(self):
        a, s = self._sched(max_preemptions=2)
        other = Request(prompt=[1], max_new_tokens=2,
                        sampling=SamplingParams())
        s.waiting.append(other)
        req = self._running(s, a, range(4), [])
        s._preempt(req)
        assert not req.parked
        assert s.waiting == [req, other]


# ------------------------------------------------------ failure isolation

class TestFailureIsolation:
    def test_transient_retries_counted(self):
        ref, _ = _reference()
        fi = FaultInjector().fail_every("dispatch", 3)
        eng = _engine(fault_injector=fi)
        rids = [eng.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        out = eng.run()
        assert eng.stats()["transient_retries"] == fi.fired["dispatch"]
        assert eng.fault_events == fi.fired["dispatch"]
        assert [out[r] for r in rids] == [ref[r] for r in sorted(ref)]

    def test_persistent_decode_fault_quarantines_the_batch(self):
        # calls 0-2 are the three prefills, call 3 the first decode block
        fi = FaultInjector().fail_at("dispatch", 3, transient=False)
        eng = _engine(fault_injector=fi)
        rids = [eng.add_request(p, max_new_tokens=6) for p in _PROMPTS]
        eng.run()
        for r in rids:
            status, err = eng.status(r)
            assert status == "failed" and err.startswith("decode:")
        assert eng.stats()["terminal"]["failed"] == 3
        eng.scheduler.check_consistency()
        assert eng.cache.allocator.num_used == 0

    @pytest.mark.parametrize("chunked", [False, True])
    def test_drain_fault_on_a_speculative_block(self, chunked):
        """A speculative record lost to a persistent drain fault takes its
        rows' worst-case page charge with them; the engine serves on."""
        from paddle_tpu_torch.serving import SpecConfig

        kw = dict(spec_config=SpecConfig(lookahead=4), max_seq_len=96,
                  **(dict(enable_chunked_prefill=True,
                          prefill_chunk_tokens=8) if chunked else {}))
        eng = _engine(**kw)
        eng._faults = FaultInjector().fail_at("drain", 1, transient=False)
        rids = [eng.add_request(p * 3, max_new_tokens=12)
                for p in _PROMPTS[:2]]
        for _ in range(200):
            if not (eng.scheduler.has_work() or eng._pending is not None):
                break
            eng.step()
            eng.scheduler.check_consistency()
        statuses = [eng.status(r) for r in rids]
        assert any(s == "failed" and e.startswith("drain")
                   for s, e in statuses)
        assert eng.cache.allocator.num_used == 0 and eng._pending is None
        ref, _ = _reference(prompts=[_PROMPTS[0] * 3], max_new_tokens=12,
                            **kw)
        rid = eng.add_request(_PROMPTS[0] * 3, max_new_tokens=12)
        assert eng.run()[rid] == list(ref.values())[0]

    @pytest.mark.parametrize("chunked", [False, True])
    def test_fatal_fault_leaves_the_engine_untouched(self, chunked):
        kw = (dict(enable_chunked_prefill=True, prefill_chunk_tokens=8)
              if chunked else {})
        fi = FaultInjector().fail_at("dispatch", 1, fatal=True)
        eng = _engine(fault_injector=fi, **kw)
        for p in _PROMPTS:
            eng.add_request(p, max_new_tokens=4)
        with pytest.raises(InjectedFault) as ei:
            for _ in range(20):
                eng.step()
        assert is_fatal(ei.value)
        assert all(eng.status(r)[0] in ("waiting", "running")
                   for r in eng.requests)
        assert eng.stats()["terminal"]["failed"] == 0


# ----------------------------------------------------------- chaos parity

class TestChaosParity:
    @pytest.mark.parametrize("chunked", [False, True])
    def test_seeded_chaos_survivor_parity(self, chunked):
        """A seeded schedule of alloc faults, transient dispatch and drain
        faults and a mid-block cancellation: every other request's stream
        equals the fault-free run, with the allocator and scheduler
        invariants holding after EVERY step."""
        kw = (dict(enable_chunked_prefill=True, prefill_chunk_tokens=8)
              if chunked else {})
        prompts = _PROMPTS + [[9, 9, 2, 4, 1, 6]]
        ref, ref_rids = _reference(prompts=prompts, max_new_tokens=10, **kw)
        fi = (FaultInjector(seed=42).fail_every("alloc", 4)
              .fail_every("dispatch", 5).fail_rate("drain", 0.2))
        eng = _engine(fault_injector=fi, **kw)
        rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        cancelled = None
        for _ in range(400):
            if not (eng.scheduler.has_work() or eng._pending is not None
                    or eng._spill):
                break
            eng.step()
            eng.scheduler.check_consistency()
            if cancelled is None and eng._pending is not None:
                victim = eng._pending["rids"][-1]
                assert eng.cancel(victim)
                cancelled = victim
                eng.scheduler.check_consistency()
        else:
            pytest.fail("chaos run did not converge")
        assert fi.total_fired() > 0 and cancelled is not None
        for a, b in zip(ref_rids, rids):
            out = eng.output(b)
            if b == cancelled:
                assert eng.status(b)[0] == "cancelled"
                assert out == ref[a][:len(out)]
            else:
                assert eng.status(b)[0] == "finished" and out == ref[a]
        assert eng.cache.allocator.num_used == 0


# ------------------------------------------------------ zero-overhead pin

class TestZeroResilienceHotPath:
    def test_disabled_resilience_executes_no_resilience_code(
            self, monkeypatch):
        """With no injector, no deadline and no queue-wait bound, a whole
        request lifecycle enters no resilience entry point."""
        import paddle_tpu_torch.serving.engine as eng_mod
        import paddle_tpu_torch.serving.kv_cache as kv_mod
        import paddle_tpu_torch.serving.scheduler as sched_mod

        eng = _engine()

        def boom(*a, **kw):
            raise AssertionError("resilience code on a clean hot path")

        for obj, meth in [
                (FaultInjector, "check"),
                (eng_mod.ServingEngine, "_quarantine"),
                (eng_mod.ServingEngine, "_expire_and_shed"),
                (eng_mod.ServingEngine, "_finalize"),
                (eng_mod.ServingEngine, "cancel"),
                (sched_mod.Scheduler, "finalize"),
                (sched_mod.Scheduler, "check_consistency"),
                (kv_mod.BlockAllocator, "check_consistency")]:
            monkeypatch.setattr(obj, meth, boom)
        monkeypatch.setattr(eng_mod, "is_transient", boom)
        monkeypatch.setattr(eng_mod, "is_fatal", boom)
        monkeypatch.setattr(sched_mod, "InjectedFault", ())   # except ()
        rid = eng.add_request([1, 2, 3], max_new_tokens=4)
        out = eng.run()
        assert len(out[rid]) == 7
        assert eng.status(rid) == ("finished", None)
        assert eng.fault_events == 0


# ----------------------------------------------------------- engine stats

class TestResilienceStats:
    @pytest.mark.parametrize("enable", [True, False])
    def test_terminal_counts_with_metrics_on_and_off(self, enable):
        eng = _engine(enable_metrics=enable, max_batch_size=1)
        a = eng.add_request(_PROMPTS[0], max_new_tokens=3)
        b = eng.add_request(_PROMPTS[1], max_new_tokens=3)
        eng.cancel(b)
        eng.run()
        st = eng.stats()
        assert st["terminal"] == {"cancelled": 1, "expired": 0,
                                  "failed": 0, "shed": 0}
        assert st["requests"][a]["status"] == "finished"
        assert st["requests"][b]["status"] == "cancelled"
        assert st["transient_retries"] == 0 and st["parked"] == 0
        if enable:
            term = eng.metrics.get("serving_requests_terminated_total",
                                   {"status": "cancelled"})
            assert term is not None and term.value == 1
