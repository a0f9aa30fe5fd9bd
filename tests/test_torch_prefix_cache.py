"""paddle_tpu_torch.serving.prefix_cache and the prefix-aware scheduler and
engine against the JAX package, plus the port's own invariants.

- `PrefixCache` and the JAX `PrefixCache`, each over its own allocator,
  driven by the same seeded sequence of match / insert / evict / flush /
  continuation / peek / record: every result, `stats()` and the page
  refcounts agree after each operation;
- the radix-tree unit cases of tests/test_serving.py, on the port;
- greedy streams token-identical to the JAX engine with
  `enable_prefix_caching=True`: shared-prefix hits, a repeated prompt,
  preemption while pages are shared, chunked prefill, the ragged step, and
  int8 pools (a shared page's scale slab shared with it); the prefix-hit
  counts equal the JAX engine's;
- the scheduler's admission charges only the uncached suffix, drops its
  match references before retrying without the cache, and its audit runs
  the tree's.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.kv_cache import BlockAllocator as JBlockAllocator
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (
    BlockAllocator, PrefixCache, Request, SamplingParams, Scheduler,
    ServingEngine, pages_for,
)
from paddle_tpu_torch.weights import load_reference_state

VOCAB = 512


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


def _shared_prefix_prompts(seed, prefix_pages, page_size, tails):
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, VOCAB, (prefix_pages * page_size,)).tolist()
    return [shared + rng.randint(0, VOCAB, (t,)).tolist() for t in tails]


def _both(kw, run):
    """run(engine) on the JAX engine and on the port's, same knobs."""
    jeng = JServingEngine(_jax_llama(), **kw)
    teng = ServingEngine(_port_llama(), device="cpu", **kw)
    return (run(jeng), jeng), (run(teng), teng)


def _run_all(prompts, max_new=5, **req_kw):
    def run(eng):
        rids = [eng.add_request(p, max_new_tokens=max_new, **req_kw)
                for p in prompts]
        outs = eng.run()
        return [list(outs[r]) for r in rids]
    return run


def _staggered(prompts, max_new=8, stagger=6):
    """The first prompt alone for `stagger` steps, then the rest: the
    follower arrives after the leader's last chunk has entered the tree."""
    def run(eng):
        rids = [eng.add_request(prompts[0], max_new_tokens=max_new)]
        for _ in range(stagger):
            eng.step()
        rids += [eng.add_request(p, max_new_tokens=max_new)
                 for p in prompts[1:]]
        outs = eng.run()
        return [list(outs[r]) for r in rids]
    return run


# ------------------------------------------------ host: against the JAX one

def _op_sequence(seed, page_size, steps=60):
    """A seeded op script over a few prompt families sharing prefixes."""
    rng = np.random.RandomState(seed)
    stems = [rng.randint(0, 6, (rng.randint(1, 4) * page_size,)).tolist()
             for _ in range(3)]
    ops = []
    for _ in range(steps):
        stem = stems[rng.randint(len(stems))]
        toks = stem[:rng.randint(0, len(stem) + 1)] + rng.randint(
            0, 6, (rng.randint(0, 2 * page_size),)).tolist()
        kind = rng.choice(["match", "insert", "insert", "evict", "peek",
                           "continuation", "release", "flush"],
                          p=[.25, .15, .15, .1, .1, .15, .07, .03])
        ops.append((str(kind), toks, int(rng.randint(0, 4)),
                    int(rng.randint(1, 3 * page_size))))
    return ops


def _drive(cache, alloc, ops):
    """Apply the op script; returns the trace of results, stats and
    refcounts. `held` are the page lists callers own (from match or from
    allocation before an insert), released by 'release'."""
    trace, held = [], []
    for kind, toks, n, width in ops:
        if kind == "match":
            got = cache.match(toks)
            cache.record(len(toks), len(got) * cache.page_size)
            held.append(got)
            out = got
        elif kind == "insert":
            pages = alloc.alloc_n(pages_for(len(toks), cache.page_size))
            if pages is None:
                cache.evict(pages_for(len(toks), cache.page_size))
                pages = alloc.alloc_n(pages_for(len(toks), cache.page_size))
            out = None if pages is None else cache.insert(toks, pages)
            if pages is not None:
                held.append(pages)
        elif kind == "evict":
            out = cache.evict(n)
        elif kind == "peek":
            out = cache.peek(toks)
        elif kind == "continuation":
            out = cache.continuation(toks, width)
        elif kind == "release":
            out = len(held)
            while held:
                alloc.free_all(held.pop())
        else:
            out = cache.flush()
        assert cache.check_consistency()
        assert alloc.check_consistency()
        trace.append((kind, out, cache.stats(),
                       sorted(alloc._refs.items()), alloc.num_free))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("page_size", [2, 4])
def test_seeded_operation_sequence_matches_reference(seed, page_size):
    ops = _op_sequence(seed, page_size)
    ja, ta = JBlockAllocator(24), BlockAllocator(24)
    ref = _drive(JPrefixCache(ja, page_size), ja, ops)
    got = _drive(PrefixCache(ta, page_size), ta, ops)
    assert got == ref


# ------------------------------------- host: mirrored from test_serving.py

def _cache(num_pages=16, ps=4):
    a = BlockAllocator(num_pages)
    return a, PrefixCache(a, ps)


class TestPrefixCache:
    def test_match_miss_then_insert_then_hit(self):
        a, pc = _cache()
        toks = list(range(11))           # 2 full pages + 3 spare at ps 4
        assert pc.match(toks) == []
        pages = a.alloc_n(3)
        pc.insert(toks, pages)           # registers pages[0:2] only
        assert pc.cached_pages == 2
        got = pc.match(toks)
        assert got == pages[:2]
        assert a.ref_count(pages[0]) == 3    # owner + tree + match
        assert a.ref_count(pages[2]) == 1    # a partial page is not cached

    def test_match_caps_below_full_prompt(self):
        a, pc = _cache(ps=4)
        toks = list(range(8))            # exactly 2 pages
        pages = a.alloc_n(2)
        pc.insert(toks, pages)
        assert pc.cached_pages == 2
        assert pc.match(toks) == pages[:1]   # (8 - 1) // 4 = 1 chunk
        assert pc.peek(toks) == 4

    def test_eviction_frees_only_unreferenced_lru_leaves(self):
        a, pc = _cache(ps=4)
        hot = list(range(8))
        cold = [90, 91, 92, 93, 94]
        hot_pages, cold_pages = a.alloc_n(2), a.alloc_n(2)
        pc.insert(hot, hot_pages)
        pc.insert(cold, cold_pages)          # registers cold_pages[0] only
        held = pc.match(hot)                 # a live sequence pins hot[0]
        assert held == hot_pages[:1]
        a.free_all(hot_pages + cold_pages)   # the original owners finish
        assert pc.evict(10) == 2             # hot leaf and cold leaf only
        assert a.ref_count(cold_pages[0]) == 0
        assert a.ref_count(hot_pages[1]) == 0
        assert a.ref_count(hot_pages[0]) == 2    # pinned by the match
        assert pc.cached_pages == 1
        a.free_all(held)
        assert pc.flush() == 1
        assert pc.cached_pages == 0 and a.num_used == 0

    def test_lru_order(self):
        a, pc = _cache(ps=2)
        p1, p2 = [a.alloc()], [a.alloc()]
        pc.insert([1, 2], p1)
        pc.insert([3, 4], p2)
        a.free(p1[0])
        a.free(p2[0])                    # owners gone: tree-only refs
        a.free_all(pc.match([1, 2, 99]))  # touch the first prefix
        assert pc.evict(1) == 1
        assert a.ref_count(p2[0]) == 0   # the untouched one went first
        assert a.ref_count(p1[0]) == 1

    def test_duplicate_insert_keeps_incumbent(self):
        a, pc = _cache(ps=4)
        toks = list(range(5))
        first, second = a.alloc_n(2), a.alloc_n(2)
        assert pc.insert(toks, first) == 1
        assert pc.insert(toks, second) == 0
        assert pc.match(toks) == first[:1]
        assert a.ref_count(second[0]) == 1

    def test_stats_counters(self):
        a, pc = _cache(ps=4)
        pc.insert(list(range(9)), a.alloc_n(3))
        pc.record(9, 0)
        pc.record(9, 8)
        s = pc.stats()
        assert s["hit_tokens"] == 8 and s["miss_tokens"] == 10
        assert s["lookups"] == 2 and s["cached_pages"] == 2
        assert abs(s["hit_rate"] - 8 / 18) < 1e-9

    def test_continuation_walks_the_smallest_child(self):
        a, pc = _cache(ps=2)
        pc.insert([1, 2, 3, 4, 5, 6], a.alloc_n(3))
        pc.insert([1, 2, 3, 9, 7, 7], a.alloc_n(3))
        assert pc.continuation([1, 2], 3) == [3, 4, 5]  # (3, 4) < (3, 9)
        assert pc.continuation([1, 2, 3], 4) == [4, 5, 6]
        assert pc.continuation([1, 2, 3, 9], 8) == [7, 7]
        assert pc.continuation([2], 4) == []
        assert pc.continuation([1, 2], 0) == []
        before = dict(a._refs)
        pc.continuation([1, 2, 3], 4)
        assert a._refs == before and pc.stats()["lookups"] == 0

    def test_consistency_audit_catches_a_dangling_node(self):
        a, pc = _cache(ps=2)
        pages = a.alloc_n(2)
        pc.insert([1, 2, 3, 4], pages)
        assert pc.check_consistency()
        a.free_all(pages)
        pc.flush()
        assert pc.check_consistency() and a.num_used == 0
        pages = a.alloc_n(1)
        pc.insert([5, 6], pages)
        node = pc._root.children[(5, 6)]
        a.free(pages[0])
        a.free(node.page)             # the tree's reference vanishes
        with pytest.raises(RuntimeError, match="no live reference"):
            pc.check_consistency()

    def test_metrics_land_in_the_given_registry(self):
        from paddle_tpu_torch.observability import MetricsRegistry

        reg = MetricsRegistry()
        a = BlockAllocator(8)
        a.bind_metrics(reg)
        pc = PrefixCache(a, 2, metrics=reg)
        pc.insert([1, 2, 3], a.alloc_n(2))
        pc.record(3, 2)
        assert reg.get("serving_prefix_hit_tokens_total").value == 2
        assert reg.get("serving_prefix_cached_pages").value == 1
        assert reg.get("serving_kv_page_shares_total").value == 1


class TestAcquire:
    def test_acquire_adds_a_reference(self):
        a = BlockAllocator(4)
        p = a.alloc()
        a.acquire(p)
        assert a.ref_count(p) == 2 and a.num_used == 1
        a.free(p)
        assert a.ref_count(p) == 1 and a.num_free == 2
        a.free(p)
        assert a.num_free == 3 and a.check_consistency()

    def test_acquire_of_free_or_null_page_raises(self):
        a = BlockAllocator(4)
        with pytest.raises(ValueError, match="null page"):
            a.acquire(0)
        with pytest.raises(ValueError, match="free/unknown"):
            a.acquire(2)

    def test_partition_check_holds_with_shared_pages(self):
        a = BlockAllocator(6)
        pages = a.alloc_n(3)
        for p in pages:
            a.acquire(p)
        assert a.check_consistency()
        a._free.append(pages[0])         # shared AND free: corrupt
        with pytest.raises(RuntimeError, match="both free"):
            a.check_consistency()

    def test_peak_used_counts_pages_not_references(self):
        a = BlockAllocator(6)
        pages = a.alloc_n(3)
        a.acquire(pages[0])              # a share takes no new page
        assert a.peak_used == 3
        a.free_all(pages[1:])
        a.alloc()
        assert a.peak_used == 3 and a.num_used == 2
        a.reset_peak()
        assert a.peak_used == 2
        a.alloc_n(2)
        assert a.peak_used == 4


# --------------------------------------------------- scheduler accounting

def _req(prompt, max_new=4):
    return Request(prompt=list(prompt), max_new_tokens=max_new,
                   sampling=SamplingParams())


class TestPrefixScheduler:
    def test_admission_charges_the_uncached_suffix_only(self):
        a = BlockAllocator(16)
        pc = PrefixCache(a, 4)
        sched = Scheduler(a, 4, max_batch_size=4, max_pages_per_seq=8,
                          prefix_cache=pc)
        owner = a.alloc_n(3)
        pc.insert(list(range(12)), owner)
        req = _req(list(range(12)) + [50, 51])
        sched.add(req)
        free = a.num_free
        assert sched.schedule().prefill is req
        assert req.cached_tokens == 12 and req.num_computed_tokens == 12
        assert req.pages[:3] == owner
        # 14 prompt tokens + 1: 4 pages, 3 of them cached
        assert free - a.num_free == 1
        assert pc.stats()["hit_tokens"] == 12
        assert sched.check_consistency()

    def test_exhausted_pool_drops_the_match_references(self):
        a = BlockAllocator(9)             # 8 allocatable
        pc = PrefixCache(a, 4)
        sched = Scheduler(a, 4, max_batch_size=4, max_pages_per_seq=8,
                          prefix_cache=pc)
        tree = a.alloc_n(2)
        pc.insert(list(range(8)), tree)
        a.free_all(tree)                  # tree-only references now
        hog = _req(list(range(200, 216)))
        sched.add(hog)
        assert sched.schedule().prefill is hog    # 5 pages: 1 left free
        req = _req(list(range(8)) + list(range(100, 108)))
        sched.add(req)
        # 16 + 1 tokens: 5 pages, 2 of them cached; 1 free is too few
        # with or without the cache, so the request waits
        assert sched.schedule().kind == "decode"
        assert req.status == "waiting" and req.pages == []
        assert pc.stats()["lookups"] == 1        # the hog's admission only
        # the match references were dropped: only the hog and the tree
        # hold pages, the tree's at refcount 1 (or evicted by the retry)
        assert a.num_used == len(hog.pages) + pc.cached_pages
        assert all(a.ref_count(p) <= 1 for p in tree)
        assert sched.check_consistency()

    def test_preempting_a_sharer_drops_only_its_references(self):
        a = BlockAllocator(16)
        pc = PrefixCache(a, 4)
        sched = Scheduler(a, 4, max_batch_size=4, max_pages_per_seq=8,
                          prefix_cache=pc)
        tree = a.alloc_n(2)
        pc.insert(list(range(8)), tree)
        reqs = [_req(list(range(8)) + [60 + i]) for i in range(2)]
        for r in reqs:
            sched.add(r)
            sched.schedule()
        assert [a.ref_count(p) for p in tree] == [4, 4]
        sched._preempt(reqs[1])
        assert [a.ref_count(p) for p in tree] == [3, 3]
        assert reqs[1].cached_tokens == 0 and reqs[1].pages == []
        assert sched.check_consistency()

    def test_audit_runs_the_trees_check(self):
        a = BlockAllocator(8)
        pc = PrefixCache(a, 2)
        sched = Scheduler(a, 2, max_batch_size=2, max_pages_per_seq=4,
                          prefix_cache=pc)
        pc.insert([1, 2], a.alloc_n(1))
        pc._num_pages += 1
        with pytest.raises(RuntimeError, match="prefix cache corrupt"):
            sched.check_consistency()


# ------------------------------------------- engine: against the JAX one

_SMALL = dict(page_size=8, max_batch_size=4, max_seq_len=32,
              prefill_buckets=(16, 32))


class TestEngineParity:
    def test_shared_prefix_hits_token_identical_to_jax(self):
        prompts = _shared_prefix_prompts(21, 2, 8, [4, 6])
        (ref, jeng), (got, eng) = _both(
            dict(_SMALL, enable_prefix_caching=True), _run_all(prompts))
        assert got == ref
        off = ServingEngine(_port_llama(), device="cpu", **_SMALL)
        assert _run_all(prompts)(off) == got
        pcs = eng.stats()["prefix_cache"]
        assert pcs == jeng.stats()["prefix_cache"]
        assert pcs["hit_tokens"] >= 16 and 0.0 < pcs["hit_rate"] < 1.0
        assert eng.prefix_cache.flush() == pcs["cached_pages"]
        assert eng.cache.allocator.num_used == 0

    def test_repeated_prompt_hits_and_matches_cold(self):
        prompt = np.random.RandomState(22).randint(0, VOCAB, (19,)).tolist()

        def run(eng):
            cold = eng.add_request(prompt, max_new_tokens=6)
            eng.run()
            hit = eng.add_request(prompt, max_new_tokens=6)
            outs = eng.run()
            return [list(outs[cold]), list(outs[hit])]

        (ref, jeng), (got, eng) = _both(
            dict(_SMALL, max_batch_size=2, enable_prefix_caching=True), run)
        assert got == ref and got[0] == got[1]
        assert eng.stats()["prefix_cache"]["hit_tokens"] == 16
        assert eng.stats()["prefix_cache"] == jeng.stats()["prefix_cache"]

    def test_preemption_while_shared_keeps_survivor_intact(self):
        prompts = _shared_prefix_prompts(23, 2, 8, [2, 3, 5])
        kw = dict(_SMALL, max_batch_size=3, num_pages=8,
                  enable_prefix_caching=True, decode_horizon=1)
        (ref, _), (got, eng) = _both(kw, _run_all(prompts, max_new=8))
        assert got == ref
        assert eng.stats()["preemptions"] >= 1
        assert eng.scheduler.check_consistency()
        eng.prefix_cache.flush()
        assert eng.cache.allocator.num_used == 0

    @pytest.mark.parametrize("ragged", [True, False])
    def test_chunked_suffix_after_a_hit(self, ragged):
        shared = np.random.RandomState(29).randint(0, VOCAB, (24,)).tolist()
        prompts = [shared + t for t in ([1, 2, 3], [4, 5, 6, 7])]
        kw = dict(page_size=8, max_batch_size=4, max_seq_len=64,
                  enable_chunked_prefill=True, prefill_chunk_tokens=8,
                  enable_ragged_step=ragged, enable_prefix_caching=True)
        (ref, jeng), (got, eng) = _both(kw, _staggered(prompts))
        assert got == ref
        pc = eng.stats()["prefix_cache"]
        assert pc["hit_tokens"] == 24 and pc == jeng.stats()["prefix_cache"]
        # only the tree's cached-prefix pages stay resident
        assert eng.cache.allocator.num_used == pages_for(24, 8)
        unchunked = ServingEngine(_port_llama(), device="cpu", page_size=8,
                                  max_batch_size=4, max_seq_len=64,
                                  enable_prefix_caching=True)
        assert _staggered(prompts)(unchunked) == got

    def test_int8_pools_share_data_and_scale_slabs(self):
        shared = list(range(2, 18))             # two full 8-token pages
        follower = shared + [1, 2, 3]
        kw = dict(page_size=8, max_batch_size=4, max_seq_len=64,
                  kv_dtype="int8")
        base = ServingEngine(_port_llama(), device="cpu", **kw)
        rid = base.add_request(follower, max_new_tokens=6)
        base_out = list(base.run()[rid])

        def run(eng):
            eng.add_request(shared + [9], max_new_tokens=2)
            eng.run()                           # cold fill of the tree
            rid = eng.add_request(follower, max_new_tokens=6)
            eng.step()                          # the follower's prefill
            shared_refs = max(eng.cache.allocator._refs.values())
            return list(eng.run()[rid]), shared_refs

        (ref, jeng), (got, eng) = _both(
            dict(kw, enable_prefix_caching=True), run)
        assert got == ref
        assert got[0] == base_out and got[1] >= 2
        pc = eng.stats()["prefix_cache"]
        assert pc["hit_tokens"] == 16 and pc == jeng.stats()["prefix_cache"]

    def test_int8_chunked_prefix_stream_matches_cache_off(self):
        prompts = _shared_prefix_prompts(31, 3, 8, [5, 9, 2])
        kw = dict(page_size=8, max_batch_size=4, max_seq_len=64,
                  kv_dtype="int8", enable_chunked_prefill=True,
                  prefill_chunk_tokens=16)
        off = ServingEngine(_port_llama(), device="cpu", **kw)
        ref = _staggered(prompts, stagger=4)(off)
        (jref, _), (got, eng) = _both(dict(kw, enable_prefix_caching=True),
                                      _staggered(prompts, stagger=4))
        assert got == ref == jref
        assert eng.stats()["prefix_cache"]["hit_tokens"] > 0


class TestEngineSurface:
    def test_stats_section_only_with_the_cache(self):
        eng = ServingEngine(_port_llama(), device="cpu", **_SMALL)
        eng.add_request([1, 2, 3], max_new_tokens=2)
        eng.run()
        assert "prefix_cache" not in eng.stats()
        eng = ServingEngine(_port_llama(), device="cpu",
                            enable_prefix_caching=True,
                            enable_metrics=False, **_SMALL)
        eng.add_request(list(range(20)), max_new_tokens=2)
        eng.run()
        st = eng.stats()["prefix_cache"]
        assert set(st) == {"lookups", "hit_tokens", "miss_tokens",
                           "evictions", "hit_rate", "cached_pages"}
        assert st["lookups"] == 1 and st["cached_pages"] == 2

    def test_default_device_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device exists; the raise needs a card-less "
                        "machine")
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(_port_llama(), enable_prefix_caching=True)
