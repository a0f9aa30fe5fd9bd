"""paddle_tpu_torch.serving.cluster: `ServingCluster` over N supervised
engine replicas of the port, mirrored from tests/test_cluster.py, plus the
cluster post-mortem cases of tests/test_observability_v2.py.

Router: load-aware placement, prefix affinity, round-robin, spill-over on
`EngineOverloaded` before the caller sees it, shedding. Health: degraded
on supervisor restarts and fault bursts, healed after clean steps, drain /
resume, `max_dead_replicas`. Failover: three replicas, a seeded
`device_lost` kill of one mid-run, and every request (the migrated ones
too) completes with a stream identical to an uninterrupted single port
engine, exactly once across `stream()`, greedy and seeded at decode
horizons 1 and 4; the chaos matrix over kill sites and routing modes;
hedging with an injected clock; the zero-cost guard.

Against the JAX package: greedy streams of the port's cluster under a
kill equal the JAX `ServingCluster`'s under the same kill (seeded streams
do not cross packages: the port's draws are counter-based).

Beyond the reference: a seeded request migrated off a dead replica whose
new owner then restarts resumes at its draw index and keeps the
uninterrupted stream; a `tp_size=2` cluster carves CPU groups and serves
the tp=1 stream, and `devices=` naming CUDA raises on a machine without a
card; a dead replica frees its own KV pools and never the weights its
factory shares;
a cluster's engines run on the card unless the factory asks for the CPU.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import ServingCluster as JServingCluster
from paddle_tpu.serving import ServingEngine as JServingEngine

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import FlightRecorder
from paddle_tpu_torch.observability.flight_recorder import POSTMORTEM_SCHEMA
from paddle_tpu_torch.serving import (
    EngineDead, EngineOverloaded, EngineSupervisor, FaultInjector,
    PrefixCache, RequestJournal, ServingCluster, ServingEngine,
)
from paddle_tpu_torch.weights import load_reference_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


_ENGINE_KW = dict(page_size=4, num_pages=64, max_batch_size=4,
                  max_seq_len=64, decode_horizon=4, retry_backoff_s=0.0)


def _factory(**overrides):
    kw = dict(_ENGINE_KW, **overrides)

    def make(replica=None, fault_injector=None):
        return ServingEngine(_port_llama(), device="cpu",
                             fault_injector=fault_injector, **kw)
    return make


def _jfactory(**overrides):
    kw = dict(_ENGINE_KW, **overrides)

    def make(replica=None, fault_injector=None):
        return JServingEngine(_jax_llama(), fault_injector=fault_injector,
                              **kw)
    return make


def _engine(**overrides):
    return ServingEngine(_port_llama(), device="cpu",
                         **dict(_ENGINE_KW, **overrides))


_PROMPTS = [[7, 3, 9, 1, 4], [2, 8, 6, 5, 1, 9, 3, 7, 2],
            [4, 4, 1, 8, 8, 2, 6, 3, 9, 5, 1, 7, 3]]

# two-page shared system prompt (page_size=4) so affinity/shared-prefix
# configs actually share cached pages
_SHARED = [6, 1, 6, 1, 8, 0, 3, 3]
_SHARED_PROMPTS = [_SHARED + [7, 3, 9], _SHARED + [2, 8, 6, 5, 1],
                   _SHARED + [4, 4, 1, 8, 8, 2, 6]]


def _sampling_kw(i, seeded):
    return (dict(temperature=0.8, top_k=5, seed=100 + i) if seeded
            else dict(seed=7))


def _reference(prompts, seeded=False, max_new_tokens=6, **engine_kw):
    """Fault-free single-engine run of the port: the parity oracle."""
    eng = _engine(**engine_kw)
    rids = [eng.add_request(p, max_new_tokens=max_new_tokens,
                            **_sampling_kw(i, seeded))
            for i, p in enumerate(prompts)]
    out = eng.run()
    return [out[r] for r in rids]


# ------------------------------------------------------------- routing

class TestRouting:
    def test_load_placement_spreads_requests(self):
        cl = ServingCluster(_factory(), num_replicas=2)
        for p in _PROMPTS:
            cl.add_request(p, max_new_tokens=4, seed=7)
        routed = cl.stats()["router"]["routed"]
        assert sum(routed) == 3 and all(n > 0 for n in routed)

    def test_round_robin_rotates(self):
        cl = ServingCluster(_factory(), num_replicas=3,
                            placement="round_robin",
                            prefix_affinity=False)
        for p in _PROMPTS:
            cl.add_request(p, max_new_tokens=4, seed=7)
        assert cl.stats()["router"]["routed"] == [1, 1, 1]

    def test_prefix_affinity_steers_shared_prompts_together(self):
        cl = ServingCluster(_factory(enable_prefix_caching=True),
                            num_replicas=3)
        first = cl.add_request(_SHARED_PROMPTS[0], max_new_tokens=4,
                               seed=7)
        home = cl._records[first].replica
        # prefill so the shared pages actually enter r<home>'s cache
        out = cl.run()
        assert len(out[first]) == len(_SHARED_PROMPTS[0]) + 4
        for p in _SHARED_PROMPTS[1:]:
            rid = cl.add_request(p, max_new_tokens=4, seed=7)
            assert cl._records[rid].replica == home
        assert cl.stats()["router"]["affinity_hits"] >= 2

    def test_affinity_disabled_ignores_prefix(self):
        cl = ServingCluster(_factory(enable_prefix_caching=True),
                            num_replicas=2, prefix_affinity=False)
        for p in _SHARED_PROMPTS:
            cl.add_request(p, max_new_tokens=4, seed=7)
        st = cl.stats()["router"]
        assert st["affinity_hits"] == 0 and st["affinity_misses"] == 0
        assert st["affinity_table"] == 0

    def test_spillover_then_shed(self):
        # each replica holds at most one waiting request; the third
        # admission spills off the full first choice onto the second
        # replica, the fifth finds everyone full and sheds
        cl = ServingCluster(_factory(max_waiting=2, max_batch_size=1),
                            num_replicas=2, prefix_affinity=False)
        for k in range(4):
            cl.add_request(_PROMPTS[k % 3], max_new_tokens=2, seed=7)
        with pytest.raises(EngineOverloaded):
            cl.add_request(_PROMPTS[0], max_new_tokens=2, seed=7)
        st = cl.stats()["router"]
        assert st["routed"] == [2, 2]
        assert st["spillovers"] >= 1 and st["shed"] == 1

    def test_unknown_placement_rejected(self):
        with pytest.raises(ValueError, match="placement"):
            ServingCluster(_factory(), placement="bogus")


# ----------------------------------------------------- single-API parity

class TestClusterParity:
    @pytest.mark.parametrize("seeded", [False, True])
    def test_matches_single_engine(self, seeded):
        want = _reference(_PROMPTS, seeded=seeded)
        cl = ServingCluster(_factory(), num_replicas=2)
        rids = [cl.add_request(p, max_new_tokens=6,
                               **_sampling_kw(i, seeded))
                for i, p in enumerate(_PROMPTS)]
        out = cl.run()
        assert [out[r] for r in rids] == want
        assert all(cl.status(r) == ("finished", None) for r in rids)
        assert cl.check_consistency()

    def test_stream_exactly_once_with_done_flags(self):
        cl = ServingCluster(_factory(), num_replicas=2)
        rids = [cl.add_request(p, max_new_tokens=5, seed=7)
                for p in _PROMPTS]
        seen, done_for = {}, set()
        for rid, tok, done in cl.stream():
            seen.setdefault(rid, []).append(tok)
            if done:
                done_for.add(rid)
        assert done_for == set(rids)
        for rid in rids:
            assert cl.output(rid) == \
                list(cl._records[rid].prompt) + seen[rid]
            assert len(seen[rid]) == 5

    def test_cancel_and_status(self):
        cl = ServingCluster(_factory(), num_replicas=2)
        rid = cl.add_request(_PROMPTS[0], max_new_tokens=8, seed=7)
        assert cl.status(rid)[0] == "waiting"
        assert cl.cancel(rid) is True
        assert cl.cancel(rid) is False
        assert cl.status(rid) == ("cancelled", None)
        cl.run()
        assert cl.status(rid) == ("cancelled", None)
        with pytest.raises(KeyError):
            cl.status(12345)


# ------------------------------------------------------ health lifecycle

class TestHealth:
    def test_drain_resume_routing(self):
        cl = ServingCluster(_factory(), num_replicas=2)
        cl.drain(0)
        assert cl.health() == ["draining", "healthy"]
        for p in _PROMPTS:
            cl.add_request(p, max_new_tokens=2, seed=7)
        assert cl.stats()["router"]["routed"] == [0, 3]
        cl.resume(0)
        assert cl.health() == ["healthy", "healthy"]
        cl.drain(0)
        cl.drain(1)
        with pytest.raises(EngineOverloaded, match="no placeable"):
            cl.add_request(_PROMPTS[0], max_new_tokens=2, seed=7)

    def test_fault_burst_degrades_then_heals(self):
        inj = [FaultInjector().fail_at("dispatch", 1, transient=True),
               FaultInjector()]
        cl = ServingCluster(_factory(), num_replicas=2,
                            fault_injectors=inj,
                            degrade_after_faults=1,
                            degrade_recovery_steps=2)
        # both replicas busy so maintenance keeps running after the fault
        rids = [cl.add_request(p, max_new_tokens=10, seed=7)
                for p in _PROMPTS]
        states = set()
        while cl.has_work():
            cl.step()
            states.add(cl.health()[0])
        assert "degraded" in states        # the burst tripped it
        assert cl.health()[0] == "healthy"  # ...and clean steps healed it
        # the transient fault cost latency, never a token
        out = {r: cl.output(r) for r in rids}
        want = _reference(_PROMPTS, max_new_tokens=10)
        assert [out[r] for r in rids] == want

    def test_restart_marks_degraded(self):
        inj = [FaultInjector().fail_at("device_lost", 1),
               FaultInjector()]
        cl = ServingCluster(_factory(), num_replicas=2,
                            fault_injectors=inj,
                            degrade_recovery_steps=10 ** 6)
        for p in _PROMPTS:
            cl.add_request(p, max_new_tokens=6, seed=7)
        cl.run()
        assert cl.health()[0] == "degraded"
        assert len(cl.replicas[0].supervisor.restarts) == 1

    def test_max_dead_replicas_raises(self):
        inj = [FaultInjector().fail_at("device_lost", 1),
               FaultInjector()]
        cl = ServingCluster(_factory(), num_replicas=2,
                            fault_injectors=inj,
                            supervisor_kw=dict(max_restarts=0),
                            max_dead_replicas=0)
        for p in _PROMPTS:
            cl.add_request(p, max_new_tokens=6, seed=7)
        with pytest.raises(EngineDead, match="max_dead_replicas"):
            cl.run()


# ----------------------------------------------- replica-loss acceptance

class TestReplicaLossParity:
    """Kill one of three replicas mid-run: every request, the ones
    migrated off the corpse included, completes identical to an
    uninterrupted single-engine run, exactly once across the stream, with
    the journal and scheduler audits clean on every survivor."""

    @pytest.mark.parametrize("horizon", [1, 4])
    @pytest.mark.parametrize("seeded", [False, True])
    def test_kill_one_replica_bit_identical(self, horizon, seeded):
        want = _reference(_PROMPTS, seeded=seeded,
                          decode_horizon=horizon)
        inj = [FaultInjector(),
               FaultInjector().fail_at("device_lost", 2),
               FaultInjector()]
        cl = ServingCluster(_factory(decode_horizon=horizon),
                            num_replicas=3, fault_injectors=inj,
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6,
                               **_sampling_kw(i, seeded))
                for i, p in enumerate(_PROMPTS)]
        seen = {}
        for rid, tok, done in cl.stream():
            seen.setdefault(rid, []).append(tok)
        assert cl.health().count("dead") == 1
        out = {r: cl.output(r) for r in rids}
        assert [out[r] for r in rids] == want
        for i, rid in enumerate(rids):      # stream == output, no dup/lost
            assert seen[rid] == out[rid][len(_PROMPTS[i]):]
        assert cl.check_consistency()
        st = cl.stats()
        assert st["replica_deaths"] == 1
        assert st["num_finished"] == len(rids)

    def test_double_death_chained_migration(self):
        """A migrated request's new home dying too re-migrates it from
        the full-history record the first migration registered."""
        want = _reference(_PROMPTS, max_new_tokens=8)
        inj = [FaultInjector().fail_at("device_lost", 1),
               FaultInjector().fail_at("device_lost", 3),
               FaultInjector()]
        cl = ServingCluster(_factory(), num_replicas=3,
                            fault_injectors=inj, prefix_affinity=False,
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=8, seed=7)
                for p in _PROMPTS]
        out = cl.run()
        assert cl.health().count("dead") == 2
        assert [out[r] for r in rids] == want
        assert cl.check_consistency()

    def test_dead_replica_unroutable_and_tagged_in_stats(self):
        inj = [FaultInjector().fail_at("device_lost", 1),
               FaultInjector()]
        cl = ServingCluster(_factory(), num_replicas=2,
                            fault_injectors=inj,
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        cl.run()
        assert cl.health()[0] == "dead"
        rid = cl.add_request(_PROMPTS[0], max_new_tokens=2, seed=7)
        assert cl._records[rid].replica == 1
        with pytest.raises(ValueError, match="dead"):
            cl.drain(0)
        st = cl.stats()
        assert st["dead_replicas"] == 1
        assert st["replicas"][0]["stats"]["dead"] is True
        assert all(cl.status(r)[0] == "finished" for r in rids)

    def test_migrated_seeded_request_survives_its_new_owner_restarting(self):
        """A seeded request migrates off a dead replica, then the replica
        that adopted it restarts: the rebuilt engine restores it at draw
        index key_splits + len(delivered) from the full-history record the
        migration registered, and the stream stays the uninterrupted one."""
        want = _reference(_PROMPTS, seeded=True, max_new_tokens=10)
        inj = [FaultInjector() for _ in range(3)]
        inj[1].fail_at("device_lost", 2)
        cl = ServingCluster(_factory(), num_replicas=3, fault_injectors=inj,
                            prefix_affinity=False, placement="round_robin",
                            supervisor_kw=dict(max_restarts=1))
        rids = [cl.add_request(p, max_new_tokens=10,
                               **_sampling_kw(i, True))
                for i, p in enumerate(_PROMPTS)]
        victim = rids[1]
        assert cl._records[victim].replica == 1
        inj[1].fail_at("device_lost", 3)         # the second kill: dead
        while cl.health()[1] != "dead":
            cl.step()
        rec = cl._records[victim]
        owner = rec.replica
        assert owner != 1 and rec.migrations == 1 and rec.live
        assert 0 < len(rec.delivered) < 10
        # the new owner restarts at its next step
        inj[owner].fail_at("device_lost",
                           inj[owner].counts.get("device_lost", 0))
        out = cl.run()
        sup = cl.replicas[owner].supervisor
        assert [r["reason"] for r in sup.restarts] == ["fatal_fault"]
        assert sup.restarts[0]["readmitted"] >= 1
        assert [out[r] for r in rids] == want
        assert cl.status(victim) == ("finished", None)
        assert cl.check_consistency()

    def test_hedged_seeded_clone_survives_its_owner_restarting(self):
        """A seeded request is hedged onto r1 after two delivered tokens and
        its original dies with r0, so the clone, journaled as a fold that
        carries key_splits = 2, owns the stream; then r1 restarts. Its
        snapshot restores the clone at key_splits + len(delivered), and the
        stream stays the uninterrupted one."""
        want = _reference(_PROMPTS[:1], seeded=True, max_new_tokens=12,
                          decode_horizon=1)[0]
        tick = [0.0]
        inj = [FaultInjector(), FaultInjector()]
        cl = ServingCluster(_factory(decode_horizon=1), num_replicas=2,
                            hedge_after_s=5.0, fault_injectors=inj,
                            supervisor_kw=dict(max_restarts=1),
                            clock=lambda: tick[0])
        cl.replicas[0].supervisor.max_restarts = 0
        cl.drain(1)
        rid = cl.add_request(_PROMPTS[0], max_new_tokens=12,
                             **_sampling_kw(0, True))
        cl.resume(1)
        rec = cl._records[rid]
        while len(rec.delivered) < 2:
            cl.step()
        # r0 turns degraded and stale: the next step hedges onto r1, then
        # r0 dies in the same step, leaving the clone the stream
        cl._set_health(cl.replicas[0], "degraded")
        inj[0].fail_at("device_lost", inj[0].counts.get("device_lost", 0))
        tick[0] += 100.0
        cl.step()
        assert cl.health() == ["dead", "healthy"]
        assert rec.replica == 1 and rec.hedges == 1
        (clone, copy), = rec.copies.items()
        jrec = cl.replicas[1].journal.record(clone)
        assert jrec.key_splits == copy.base > 0
        inj[1].fail_at("device_lost", inj[1].counts.get("device_lost", 0)
                       + 1)
        out = cl.run()
        assert [r["reason"] for r in cl.replicas[1].supervisor.restarts] \
            == ["fatal_fault"]
        assert out[rid] == want
        assert cl.status(rid) == ("finished", None)
        assert cl.check_consistency()

    def test_slo_class_follows_a_migrated_request(self):
        """A request's SLO class rides in its cluster record: the survivor
        adopts the migrated copy under it, so its tokens keep counting as
        that class's goodput."""
        from paddle_tpu_torch.observability import SloClass

        easy = [SloClass("interactive", 600.0, 600.0)]
        inj = [FaultInjector(), FaultInjector().fail_at("device_lost", 2)]
        cl = ServingCluster(_factory(slo_classes=easy), num_replicas=2,
                            fault_injectors=inj, prefix_affinity=False,
                            placement="round_robin",
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7,
                               slo_class="interactive")
                for p in _PROMPTS[:2]]
        out = cl.run()
        assert cl.health() == ["healthy", "dead"]
        moved = cl._records[rids[1]]
        assert moved.migrations == 1 and moved.slo_class == "interactive"
        eng = cl.replicas[0].supervisor.engine
        adopted = [r for r in eng.requests.values()
                   if r.request_id == rids[1]]
        assert adopted and adopted[0].slo_class == "interactive"
        (copy,) = moved.copies.values()
        assert copy.replica == 0 and 0 < copy.base < 6
        # r0 served its own 6 tokens and every token of the migrated
        # request after its fold, all within the generous targets
        row = eng.stats()["slo"]["interactive"]
        assert row["goodput_tokens"] == 6 + (6 - copy.base)
        assert [out[r] for r in rids] == _reference(_PROMPTS[:2])
        with pytest.raises(ValueError, match="SLO class"):
            cl.add_request(_PROMPTS[0], max_new_tokens=2, slo_class="nope")

    def test_dead_replica_frees_its_pools_not_the_shared_weights(self):
        model = _port_llama()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        inj = [FaultInjector(), FaultInjector().fail_at("device_lost", 2)]
        cl = ServingCluster(_factory(), num_replicas=2, fault_injectors=inj,
                            prefix_affinity=False, placement="round_robin",
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        dying = cl.replicas[1].supervisor.engine
        survivor = cl.replicas[0].supervisor.engine
        assert dying.cache.pools and dying.model is survivor.model
        out = cl.run()
        assert cl.health() == ["healthy", "dead"]
        assert dying.cache.pools == []
        assert survivor.cache.pools
        after = model.state_dict()
        assert all(torch.equal(before[k], after[k]) for k in before)
        assert [out[r] for r in rids] == _reference(_PROMPTS)


# ------------------------------------------------------------ chaos matrix

_CHAOS_MODES = [("load", True), ("round_robin", False)]


class TestClusterChaosMatrix:
    """Seeded kills at every interesting site x routing modes: survivors
    identical to a fault-free single-engine run, zero duplicated or lost
    tokens, per-replica invariants clean after every migration."""

    @pytest.mark.parametrize("placement,affinity", _CHAOS_MODES)
    @pytest.mark.parametrize("kill_at", [0, 2])
    def test_kill_anywhere(self, placement, affinity, kill_at):
        # kill_at=0 dies on its very first step (mid-prefill: nothing
        # delivered yet); kill_at=2 mid-decode with horizon partials
        want = _reference(_PROMPTS, max_new_tokens=6)
        injectors = [FaultInjector() for _ in range(3)]
        injectors[1].fail_at("device_lost", kill_at)
        cl = ServingCluster(_factory(), num_replicas=3,
                            placement=placement,
                            prefix_affinity=affinity,
                            fault_injectors=injectors,
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        seen = {}
        for rid, tok, done in cl.stream():
            seen.setdefault(rid, []).append(tok)
        out = {r: cl.output(r) for r in rids}
        assert [out[r] for r in rids] == want
        for i, rid in enumerate(rids):
            assert seen.get(rid, []) == out[rid][len(_PROMPTS[i]):]
        assert cl.check_consistency()

    def test_kill_replica_holding_shared_prefix_pages(self):
        """Affinity packs the shared-prefix requests onto one replica;
        killing exactly that replica migrates all of them at once (folded
        re-prefills on survivors whose caches never saw the prefix),
        still identical."""
        want = _reference(_SHARED_PROMPTS, max_new_tokens=6,
                          enable_prefix_caching=True)
        injectors = [FaultInjector() for _ in range(3)]
        cl = ServingCluster(_factory(enable_prefix_caching=True),
                            num_replicas=3, fault_injectors=injectors,
                            supervisor_kw=dict(max_restarts=0))
        rids = [cl.add_request(_SHARED_PROMPTS[0], max_new_tokens=6,
                               seed=7)]
        victim = cl._records[rids[0]].replica
        cl.run()                          # prefix pages now cached there
        rids += [cl.add_request(p, max_new_tokens=6, seed=7)
                 for p in _SHARED_PROMPTS[1:]]
        # affinity pulled every shared prompt onto the same replica
        assert all(cl._records[r].replica == victim for r in rids)
        injectors[victim].fail_at(
            "device_lost",
            injectors[victim].counts.get("device_lost", 0) + 1)
        out = cl.run()
        assert cl.health()[victim] == "dead"
        assert [out[r] for r in rids] == want
        assert cl.stats()["migrations"] >= 1
        assert cl.check_consistency()

    @pytest.mark.parametrize("chaos_seed", [11, 23])
    def test_seeded_cluster_chaos_deterministic(self, chaos_seed):
        """One integer drives every replica's injector; two clusters
        built from the same seed take identical fault schedules and
        produce identical outputs (and both match the oracle)."""
        want = _reference(_PROMPTS, max_new_tokens=6)

        def run_once():
            cl = ServingCluster(_factory(), num_replicas=3,
                                chaos_seed=chaos_seed,
                                supervisor_kw=dict(max_restarts=1))
            for inj in cl.fault_injectors:
                inj.fail_rate("dispatch", 0.05)
            rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                    for p in _PROMPTS]
            out = cl.run()
            fired = [dict(i.fired) for i in cl.fault_injectors]
            return [out[r] for r in rids], fired

        out_a, fired_a = run_once()
        out_b, fired_b = run_once()
        assert out_a == out_b == want
        assert fired_a == fired_b

    def test_chaos_injectors_match_the_jax_cluster(self):
        """The per-replica seeds derive from the one integer exactly as
        the JAX package derives them."""
        ours = ServingCluster.chaos_injectors(11, 3)
        theirs = JServingCluster.chaos_injectors(11, 3)
        for a, b in zip(ours, theirs):
            a.fail_rate("dispatch", 0.3)
            b.fail_rate("dispatch", 0.3)
            fired = []
            for inj in (a, b):
                hits = []
                for _ in range(64):
                    try:
                        inj.check("dispatch")
                        hits.append(0)
                    except Exception:  # noqa: BLE001 (the injected fault)
                        hits.append(1)
                fired.append(hits)
            assert fired[0] == fired[1] and sum(fired[0]) > 0


# ------------------------------------------------------ against the JAX

class TestAgainstJaxCluster:
    """The same kill on the port's cluster and on the JAX package's: the
    greedy streams are token-identical to each other and to the JAX
    package's uninterrupted single engine."""

    @pytest.mark.parametrize("placement,affinity,kill_at", [
        ("load", True, 2), ("round_robin", False, 0)])
    def test_kill_one_replica_greedy_matches_jax(self, placement, affinity,
                                                 kill_at):
        eng = JServingEngine(_jax_llama(), **_ENGINE_KW)
        jrids = [eng.add_request(p, max_new_tokens=6, seed=7)
                 for p in _PROMPTS]
        jout = eng.run()
        want = [jout[r] for r in jrids]
        outs = []
        for cluster_cls, factory, inj_cls in (
                (ServingCluster, _factory(), FaultInjector),
                (JServingCluster, _jfactory(), JFaultInjector)):
            inj = [inj_cls() for _ in range(3)]
            inj[1].fail_at("device_lost", kill_at)
            cl = cluster_cls(factory, num_replicas=3, placement=placement,
                             prefix_affinity=affinity, fault_injectors=inj,
                             supervisor_kw=dict(max_restarts=0))
            rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                    for p in _PROMPTS]
            out = cl.run()
            assert cl.health().count("dead") == 1
            outs.append(([out[r] for r in rids], cl.stats()))
        (port, pst), (jax_, jst) = outs
        assert port == jax_ == want
        assert pst["router"]["routed"] == jst["router"]["routed"]
        assert pst["migrations"] == jst["migrations"]
        assert pst["migrated_tokens"] == jst["migrated_tokens"]


# -------------------------------------------------------------- hedging

class TestHedging:
    def _stuck_cluster(self, tick):
        """2 replicas, r0 degraded and the fake clock far past
        `hedge_after_s`: the next step MUST hedge r0's request onto r1.
        Winner-agnostic from here on — both copies race."""
        cl = ServingCluster(_factory(), num_replicas=2,
                            hedge_after_s=5.0,
                            clock=lambda: tick[0])
        cl.drain(1)                       # force placement onto r0
        rid = cl.add_request(_PROMPTS[0], max_new_tokens=6, seed=7)
        cl.resume(1)
        cl._set_health(cl.replicas[0], "degraded")
        tick[0] += 100.0                  # way past the hedge deadline
        return cl, rid

    def test_hedge_fires_and_consumer_sees_one_stream(self):
        want = _reference(_PROMPTS[:1], max_new_tokens=6)[0]
        tick = [0.0]
        cl, rid = self._stuck_cluster(tick)
        seen = []
        for r, tok, done in cl.stream():
            assert r == rid               # the clone never leaks its id
            seen.append(tok)
        assert cl.stats()["hedges"] == 1
        assert cl.stats()["hedge_cancels"] == 1
        assert cl.output(rid) == want     # identical, zero dups
        assert seen == want[len(_PROMPTS[0]):]
        assert len(cl._records[rid].copies) <= 1
        assert cl.status(rid) == ("finished", None)
        assert cl.check_consistency()

    def test_hedge_then_owner_death_survivor_owns_stream(self):
        """The original's replica dies after the hedge: the clone is the
        surviving copy and the migration path hands it the stream instead
        of re-admitting anything."""
        want = _reference(_PROMPTS[:1], max_new_tokens=6)[0]
        tick = [0.0]
        cl = ServingCluster(_factory(), num_replicas=2,
                            hedge_after_s=5.0,
                            supervisor_kw=dict(max_restarts=0),
                            clock=lambda: tick[0])
        cl.drain(1)
        rid = cl.add_request(_PROMPTS[0], max_new_tokens=6, seed=7)
        cl.resume(1)
        cl._set_health(cl.replicas[0], "degraded")
        # r0 dies on its NEXT step — the same step whose maintenance
        # phase plants the hedge on r1
        inj = FaultInjector().fail_at("device_lost", 0)
        cl.replicas[0].supervisor.engine._faults = inj
        tick[0] += 100.0
        out = cl.run()
        assert cl.health() == ["dead", "healthy"]
        assert out[rid] == want
        assert cl.stats()["hedges"] == 1
        assert cl.stats()["migrations"] == 0   # survivor, not re-admit
        assert cl.status(rid) == ("finished", None)
        assert cl.check_consistency()

    def test_no_hedge_when_disabled_or_healthy(self):
        tick = [0.0]
        cl = ServingCluster(_factory(), num_replicas=2,
                            hedge_after_s=5.0, clock=lambda: tick[0])
        cl.add_request(_PROMPTS[0], max_new_tokens=4, seed=7)
        tick[0] += 100.0                  # stale but owner is healthy
        cl.run()
        assert cl.stats()["hedges"] == 0


# ------------------------------------------------------ zero-cost guard

class TestZeroCostWhenUnused:
    def test_single_engine_path_executes_no_cluster_code(self,
                                                         monkeypatch):
        """An engine + supervisor serve (journal attached, faults injected
        and recovered) executes no cluster code: every cluster entry
        point, the engine's adopt path, the cache's peek probe and the
        journal's adopt are booby-trapped."""
        def boom(*a, **k):
            raise AssertionError("cluster code on single-engine path")

        import paddle_tpu_torch.serving.cluster as cluster_mod
        for name in ("add_request", "step", "stream", "run", "cancel",
                     "status", "output", "stats", "drain", "resume",
                     "_candidates", "_ingest", "_maintenance", "_hedge",
                     "_on_replica_death", "_migrate_one", "_adopt_on",
                     "_affinity_keys", "_load_score", "chaos_injectors"):
            monkeypatch.setattr(cluster_mod.ServingCluster, name, boom)
        monkeypatch.setattr(ServingEngine, "adopt_request", boom)
        monkeypatch.setattr(PrefixCache, "peek", boom)
        monkeypatch.setattr(RequestJournal, "adopt", boom)

        inj = FaultInjector().fail_at("device_lost", 1)
        sup = EngineSupervisor(
            lambda: _engine(enable_prefix_caching=True,
                            fault_injector=inj),
            journal=RequestJournal())
        rids = [sup.add_request(p, max_new_tokens=4, seed=7)
                for p in _SHARED_PROMPTS]
        out = sup.run()
        assert len(sup.restarts) == 1     # the recovery path DID run
        for i, rid in enumerate(rids):
            assert len(out[rid]) == len(_SHARED_PROMPTS[i]) + 4

    def test_package_import_leaves_cluster_unloaded(self):
        import subprocess

        probe = ("import sys, paddle_tpu_torch.serving as s; "
                 "print('paddle_tpu_torch.serving.cluster' in sys.modules);"
                 " s.RequestJournal; "
                 "print('paddle_tpu_torch.serving.cluster' in sys.modules);"
                 " s.ServingCluster; "
                 "print('paddle_tpu_torch.serving.cluster' in sys.modules)")
        out = subprocess.run([sys.executable, "-c", probe],
                             capture_output=True, text=True, timeout=300,
                             cwd=REPO)
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["False", "False", "True"]


# ------------------------------------------------ what is not ported yet

class TestSurface:
    @pytest.mark.parametrize("kw", [dict(tp_size=2),
                                    dict(devices=["cuda:0", "cuda:1"])])
    def test_tensor_parallel_replicas_raise_naming_s5(self, kw):
        # S5 is ported: a tp_size=2 cluster carves tp-wide CPU groups and
        # serves the tp=1 stream; a CUDA device list raises on a card-less
        # machine, as every CUDA entry point of the port does
        if "devices" in kw:
            if torch.cuda.is_available():
                pytest.skip("a CUDA device exists; the raise needs a "
                            "card-less machine")
            with pytest.raises(RuntimeError, match="cuda"):
                ServingCluster(_factory(), num_replicas=2, **kw)
            return

        def make(replica=None, fault_injector=None, tp_size=1,
                 devices=None):
            return ServingEngine(_port_llama(), device="cpu",
                                 fault_injector=fault_injector,
                                 tp_size=tp_size, devices=devices,
                                 **_ENGINE_KW)

        cl = ServingCluster(make, num_replicas=2, devices=["cpu"] * 4, **kw)
        assert [r.supervisor.engine.tp_size for r in cl.replicas] == [2, 2]
        prompt = [5, 9, 2, 7]
        rid = cl.add_request(prompt, max_new_tokens=4, seed=7)
        eng = _engine()
        ref = eng.add_request(prompt, max_new_tokens=4, seed=7)
        assert cl.run()[rid] == eng.run()[ref]

    def test_factory_engines_run_on_the_card_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingCluster(lambda: ServingEngine(_port_llama(),
                                                 **_ENGINE_KW),
                           num_replicas=2)
        cl = ServingCluster(_factory(), num_replicas=2)
        assert all(r.supervisor.engine.device == torch.device("cpu")
                   for r in cl.replicas)


# ------------------------------------- cluster post-mortem + telemetry

def _load_postmortem_cli():
    mod = sys.modules.get("_postmortem_cli")
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        "_postmortem_cli", os.path.join(REPO, "tools", "postmortem.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_postmortem_cli"] = mod
    spec.loader.exec_module(mod)
    return mod


def _recorded_factory(recorders, **overrides):
    """One FlightRecorder per replica index, shared across engine rebuilds
    (the forensic trail must survive the restart that created it)."""
    kw = dict(_ENGINE_KW, **overrides)

    def make(replica=None, fault_injector=None):
        rec = recorders.setdefault(replica, FlightRecorder(capacity=1024))
        return ServingEngine(_port_llama(), device="cpu",
                             fault_injector=fault_injector,
                             flight_recorder=rec, **kw)
    return make


class TestClusterPostmortem:
    def test_replica_death_bundle_holds_fault_death_and_migration(
            self, tmp_path):
        """Kill one of three replicas mid-run: the cluster leaves ONE
        parseable bundle whose timeline holds the fatal fault, the death
        AND the migration decisions, and tools/postmortem.py renders it."""
        recorders = {}
        inj = [FaultInjector(),
               FaultInjector().fail_at("device_lost", 2),
               FaultInjector()]
        cl = ServingCluster(_recorded_factory(recorders),
                            num_replicas=3, fault_injectors=inj,
                            supervisor_kw=dict(max_restarts=0),
                            postmortem_dir=str(tmp_path))
        rids = [cl.add_request(p, max_new_tokens=6, seed=7)
                for p in _PROMPTS]
        out = cl.run()
        assert cl.health().count("dead") == 1
        assert all(len(out[r]) == len(p) + 6
                   for r, p in zip(rids, _PROMPTS))
        assert len(cl.postmortem_paths) == 1
        [path] = cl.postmortem_paths
        with open(path) as f:
            bundle = json.load(f)
        assert bundle["schema"] == POSTMORTEM_SCHEMA
        kinds = [e["kind"] for e in bundle["events"]]
        assert "fault" in kinds           # the fatal device_lost
        assert "dead" in kinds            # the supervisor's verdict
        assert "migrate" in kinds         # the failover decisions
        fatal = [e for e in bundle["events"]
                 if e["kind"] == "fault" and e.get("fatal")]
        assert fatal and fatal[0]["site"] == "device_lost"
        moves = [e for e in bundle["events"] if e["kind"] == "migrate"]
        assert all(m["src"] == 1 for m in moves)
        assert {m["dst"] for m in moves} <= {0, 2}
        # events stay seq-ordered: fault happens before the migrations
        seqs = [e["seq"] for e in bundle["events"]]
        assert seqs == sorted(seqs)
        assert bundle["info"]["cluster"]["replica"] == 1
        assert bundle["info"]["cluster"]["migrated"] == len(moves)
        # the dead replica's handle points at the bundle
        assert cl.replicas[1].supervisor.postmortem_path == path
        assert cl.telemetry()["postmortems"] == [path]

        cli = _load_postmortem_cli()
        text = cli.render(cli.load_bundle(path))
        assert "post-mortem:" in text
        assert "!!" in text               # the fatal fault line
        assert ">>" in text               # the migration line
        assert "r1->r" in text

    def test_telemetry_merges_replica_registries(self):
        cl = ServingCluster(_recorded_factory({}), num_replicas=2)
        rids = [cl.add_request(p, max_new_tokens=4, seed=7)
                for p in _PROMPTS]
        cl.run()
        tele = cl.telemetry()
        assert [r["index"] for r in tele["replicas"]] == [0, 1]
        assert all(r["alive"] for r in tele["replicas"])
        assert tele["dead_replicas"] == 0
        rows = tele["metrics"]["metrics"]
        tokens = [d for d in rows
                  if d["name"] == "serving_tokens_generated_total"]
        replicas_seen = {d["labels"]["replica"] for d in tokens}
        assert replicas_seen == {"0", "1"}
        assert sum(d["value"] for d in tokens) == 4 * len(rids)
        # cluster-level gauges keep their own replica labels: the fold
        # must setdefault, never overwrite
        health = [d for d in rows
                  if d["name"] == "serving_cluster_replica_health"]
        assert {d["labels"]["replica"] for d in health} == {"0", "1"}
        # and the exposition text is valid enough to grep
        assert 'replica="0"' in tele["prometheus"]
        assert "serving_tokens_generated_total" in tele["prometheus"]
