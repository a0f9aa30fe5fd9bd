"""paddle_tpu_torch.observability and paddle_tpu_torch.profiler, mirrored
from tests/test_observability.py and tests/test_observability_v2.py, and
the serving engine's observability hooks.

Model-free: counters, gauges, the registry, log-bucket histogram
percentiles on known distributions, the Prometheus exposition (parsed,
not eyeballed), the JSON snapshot round trip, `LifecycleTracker`,
`HistogramWindow`, `SloClass` / `SloTracker`, `FlightRecorder` and the
post-mortem bundles, and the profiler's windows.

Against the JAX package:
- the same observations give byte-identical `to_prometheus` text and
  JSON snapshots in both packages, and a port snapshot round-trips
  through the reference's `registry_from_snapshot` and back;
- `HistogramWindow` and `SloTracker` summaries are equal for the same
  timestamps;
- one scripted `FaultInjector` gives the same sequence of flight-recorder
  kinds, sites, families and decisions on the JAX engine (its paged
  attention in interpret mode) and on the port's;
- both engines' lifecycle stages agree, and their post-mortem bundles
  carry the same schema and keys;
- `tools/postmortem.py` and `tools/trace_summary.py` render the port's
  bundle and chrome trace.

Engine layer (the tiny LLaMA, fp32): per-class goodput and attainment,
`stats()["slo"]` and `["step_breakdown"]`, quarantine auto-dumps, the
supervisor's death bundle and restart record, the restart span, a device
trace holding the engine's `RecordEvent` spans, and the zero-cost pins: a
metrics-off (or recorder-less) engine runs no SLO or recorder code, and a
disarmed `RecordEvent` touches no `torch.profiler` code.

All on the CPU, where every kernel wrapper runs its plain version.
"""
import functools
import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
from paddle_tpu.jit.functional import extract_state
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlama
from paddle_tpu.serving import FaultInjector as JFaultInjector
from paddle_tpu.serving import RequestJournal as JRequestJournal
from paddle_tpu.serving import ServingEngine as JServingEngine

from paddle_tpu_torch import profiler as P
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import (
    Counter, FlightRecorder, Gauge, Histogram, HistogramWindow,
    LifecycleTracker, MetricsRegistry, SloClass, SloTracker,
    build_postmortem, dump_postmortem, global_registry,
    registry_from_snapshot, to_prometheus,
)
from paddle_tpu_torch.observability.flight_recorder import POSTMORTEM_SCHEMA
from paddle_tpu_torch.serving import (
    BlockAllocator, EngineDead, EngineSupervisor, FaultInjector,
    RequestJournal, SamplingParams, Scheduler, ServingEngine, ServingObs,
    describe_fault,
)
from paddle_tpu_torch.serving.scheduler import Request
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


def _tool(name):
    mod = sys.modules.get(f"_tool_{name}")
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f"_tool_{name}"] = mod
    spec.loader.exec_module(mod)
    return mod


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


def _engine(**kw):
    return ServingEngine(_port_llama(), device="cpu",
                         **dict(_ENGINE_KW, **kw))


def _jengine(**kw):
    return JServingEngine(_jax_llama(), **dict(_ENGINE_KW, **kw))


_PROMPTS = [[7, 3, 9, 1, 4], [2, 8, 6, 5, 1, 9, 3, 7, 2],
            [4, 4, 1, 8, 8, 2, 6, 3, 9, 5, 1, 7, 3]]

# generous targets every CPU-run observation meets / impossible ones
# nothing meets: the two ends that make goodput arithmetic exact
_EASY = SloClass("interactive", ttft_target_s=600.0, tpot_target_s=600.0)
_HARD = SloClass("tight", ttft_target_s=1e-12, tpot_target_s=1e-12)


# ------------------------------------------------------ counters / gauges

class TestCountersAndGauges:
    def test_counter_monotonic(self):
        c = Counter("tokens_total")
        c.inc()
        c.inc(5)
        assert c.value == 6 and isinstance(c.value, int)
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)

    def test_counter_float_accumulation(self):
        c = Counter("seconds_total")
        c.inc(0.25)
        c.inc(0.5)
        assert abs(c.value - 0.75) < 1e-12

    def test_gauge_set_inc_dec(self):
        g = Gauge("queue_depth")
        g.set(4)
        g.inc()
        g.dec(2)
        assert g.value == 3


class TestRegistry:
    def test_get_or_create_returns_same_object(self):
        r = MetricsRegistry()
        a = r.counter("x_total", "help")
        b = r.counter("x_total")
        assert a is b and len(r) == 1

    def test_labels_create_distinct_series(self):
        r = MetricsRegistry()
        a = r.gauge("depth", labels={"state": "waiting"})
        b = r.gauge("depth", labels={"state": "running"})
        assert a is not b and len(r) == 2
        assert r.get("depth", {"state": "waiting"}) is a
        assert r.get("depth") is None        # unlabelled series not created

    def test_kind_conflict_raises(self):
        r = MetricsRegistry()
        r.counter("x_total")
        with pytest.raises(TypeError, match="already registered"):
            r.gauge("x_total")

    def test_name_validation(self):
        r = MetricsRegistry()
        with pytest.raises(ValueError, match="invalid metric name"):
            r.counter("bad-name")
        with pytest.raises(ValueError, match="invalid label name"):
            r.counter("ok_total", labels={"bad-label": "v"})

    def test_global_registry_is_a_singleton(self):
        assert global_registry() is global_registry()
        assert global_registry() is not jobs.global_registry()

    def test_collect_is_sorted_by_name_and_labels(self):
        r = MetricsRegistry()
        r.gauge("b", labels={"x": "2"})
        r.counter("a_total")
        r.gauge("b", labels={"x": "1"})
        assert [(m.name, dict(m.labels)) for m in r.collect()] == [
            ("a_total", {}), ("b", {"x": "1"}), ("b", {"x": "2"})]


class TestHistogram:
    def test_bucket_edges_and_overflow(self):
        h = Histogram("lat", lo=1.0, hi=16.0, growth=2.0)   # 4 buckets
        assert h.num_buckets == 4
        for v in (0.0, -3.0, 0.5):       # underflow incl. zero/negative
            h.observe(v)
        h.observe(1.0)                   # first real bucket [1, 2)
        h.observe(15.9)                  # last real bucket [8, 16)
        h.observe(16.0)                  # overflow
        h.observe(1e9)
        assert h._counts[0] == 3
        assert h._counts[1] == 1
        assert h._counts[h.num_buckets] == 1
        assert h._counts[-1] == 2
        assert h.count == 7

    def test_nan_dropped(self):
        h = Histogram("lat")
        h.observe(float("nan"))
        assert h.count == 0

    def test_empty_percentiles_and_summary(self):
        h = Histogram("lat")
        assert h.percentile(50) == 0.0
        assert h.summary() == Histogram.empty_summary()
        assert h.summary()["p99"] == 0.0

    def test_point_mass_reports_exactly(self):
        h = Histogram("lat")
        for _ in range(100):
            h.observe(0.125)
        for q in (1, 50, 99, 100):
            assert h.percentile(q) == 0.125
        s = h.summary()
        assert s["count"] == 100 and abs(s["mean"] - 0.125) < 1e-12

    def test_log_uniform_percentiles_within_bucket_error(self):
        rng = np.random.default_rng(7)
        vals = np.exp(rng.uniform(np.log(1e-3), np.log(10.0), 4000))
        h = Histogram("lat", lo=1e-5, hi=600.0)
        for v in vals:
            h.observe(float(v))
        for q in (50, 95, 99):
            est, exact = h.percentile(q), float(np.percentile(vals, q))
            assert abs(est - exact) / exact < h.growth - 1.0 + 0.02, \
                f"p{q}: {est} vs exact {exact}"

    def test_percentile_accuracy_on_known_distributions(self):
        """Exponential and lognormal at 200k samples: relative error
        bounded by one bucket ratio at the default growth, and by ~9%
        with a finer growth=2**0.125 histogram."""
        rng = np.random.default_rng(123)
        dists = {
            "exponential": rng.exponential(0.05, 200_000),
            "lognormal": rng.lognormal(-3.0, 1.0, 200_000),
        }
        for growth, tol in ((2 ** 0.25, 0.20), (2 ** 0.125, 0.095)):
            for name, vals in dists.items():
                h = Histogram("lat", lo=1e-6, hi=600.0, growth=growth)
                for v in vals.tolist():
                    h.observe(v)
                for q in (50, 95, 99):
                    est = h.percentile(q)
                    exact = float(np.percentile(vals, q))
                    rel = abs(est - exact) / exact
                    assert rel < tol, \
                        f"{name} p{q} growth={growth}: rel err {rel:.3f}"

    def test_bounded_memory(self):
        h = Histogram("lat")
        n_buckets = len(h._counts)
        for v in np.linspace(1e-6, 700, 10_000):
            h.observe(float(v))
        assert len(h._counts) == n_buckets


# -------------------------------------------------------------- exporters

def _fill(r):
    """The same observations into registry `r` of either package."""
    r.counter("serving_tokens_generated_total", "tokens").inc(42)
    r.counter("serving_jit_compile_misses_total", "misses",
              labels={"family": "prefill"}).inc(2)
    r.gauge("serving_queue_depth", "depth",
            labels={"state": "waiting"}).set(3)
    r.gauge("serving_kv_page_utilization", "util").set(0.375)
    r.counter("serving_prefill_seconds_total", "wall").inc(0.1)
    r.counter("serving_prefill_seconds_total", "wall").inc(0.2)
    h = r.histogram("serving_ttft_seconds", "ttft")
    for v in (0.001, 0.002, 0.004, 0.1, 2.0, 1e-9, 1e9):
        h.observe(v)
    r.histogram("serving_empty_seconds", "never observed")
    r.counter("c_total", 'tokens "in flight" per\nshard \\ chip',
              labels={"path": 'a\\n"b\nc'}).inc()
    return r


def _sample_registry():
    return _fill(MetricsRegistry())


# one sample line: name{labels}? value  (value may be +Inf/-Inf/float/int);
# label values follow the text format's escapes (\\, \n, \")
_PROM_VALUE = r'(?:[^"\\\n]|\\.)*'
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="' + _PROM_VALUE +
    r'"(,[a-zA-Z_][a-zA-Z0-9_]*="' + _PROM_VALUE + r'")*\})?'
    r' (\+Inf|-Inf|-?[0-9.]+(e[+-]?[0-9]+)?)$')


class TestPrometheusExport:
    def test_text_parses_line_by_line(self):
        text = to_prometheus(_sample_registry())
        assert text.endswith("\n")
        types = {}
        for line in text.strip().split("\n"):
            if line.startswith("# TYPE"):
                _, _, name, kind = line.split(" ")
                types[name] = kind
            elif not line.startswith("#"):
                assert _PROM_LINE.match(line), f"unparseable: {line!r}"
        assert types["serving_tokens_generated_total"] == "counter"
        assert types["serving_queue_depth"] == "gauge"
        assert types["serving_ttft_seconds"] == "histogram"

    def test_histogram_exposition_is_cumulative_and_consistent(self):
        r = MetricsRegistry()
        h = r.histogram("serving_ttft_seconds", "ttft")
        for v in (0.001, 0.002, 0.004, 0.1, 2.0):
            h.observe(v)
        text = to_prometheus(r)
        buckets = [int(line.rsplit(" ", 1)[1]) for line in text.split("\n")
                   if line.startswith("serving_ttft_seconds_bucket")]
        assert buckets == sorted(buckets)            # cumulative
        assert buckets[-1] == 5                      # +Inf == count
        assert "serving_ttft_seconds_count 5" in text
        m = re.search(r"serving_ttft_seconds_sum ([0-9.e+-]+)", text)
        assert m and abs(float(m.group(1)) - 2.107) < 1e-9
        assert 'le="+Inf"' in text

    def test_one_type_line_per_name_across_label_series(self):
        r = MetricsRegistry()
        r.gauge("depth", labels={"state": "waiting"}).set(1)
        r.gauge("depth", labels={"state": "running"}).set(2)
        text = to_prometheus(r)
        assert text.count("# TYPE depth gauge") == 1
        assert 'depth{state="running"} 2' in text
        assert 'depth{state="waiting"} 1' in text

    def test_label_escaping_order_and_newline(self):
        r = MetricsRegistry()
        r.counter("c_total", labels={"path": 'a\\n"b\nc'}).inc()
        text = to_prometheus(r)
        assert 'path="a\\\\n\\"b\\nc"' in text
        for line in text.strip().split("\n"):
            if not line.startswith("#"):
                assert _PROM_LINE.match(line), f"unparseable: {line!r}"

    def test_help_escaping_is_backslash_and_newline_only(self):
        r = MetricsRegistry()
        r.counter("c_total", 'tokens "in flight" per\nshard \\ chip').inc()
        text = to_prometheus(r)
        assert ('# HELP c_total tokens "in flight" per\\nshard \\\\ chip'
                in text)
        assert r'\"' not in text.split("\n")[0]

    def test_registry_method_is_the_exporter(self):
        r = _sample_registry()
        assert r.to_prometheus() == to_prometheus(r)

    def test_byte_identical_to_the_jax_package(self):
        ours, theirs = _sample_registry(), _fill(jobs.MetricsRegistry())
        assert to_prometheus(ours) == jobs.to_prometheus(theirs)
        assert json.dumps(ours.snapshot(), sort_keys=True) == \
            json.dumps(theirs.snapshot(), sort_keys=True)


class TestJsonSnapshot:
    def test_snapshot_roundtrips_through_json(self):
        reg = _sample_registry()
        snap = reg.snapshot()
        wire = json.dumps(snap)                      # must be JSON-able
        rebuilt = registry_from_snapshot(json.loads(wire))
        assert rebuilt.snapshot() == snap
        h = rebuilt.get("serving_ttft_seconds")
        orig = reg.get("serving_ttft_seconds")
        assert h.count == 7
        assert h.percentile(50) == orig.percentile(50)
        assert rebuilt.get("serving_tokens_generated_total").value == 42

    def test_empty_registry_roundtrip(self):
        snap = MetricsRegistry().snapshot()
        assert snap == {"metrics": []}
        assert registry_from_snapshot(snap).snapshot() == snap

    def test_snapshot_crosses_packages_and_back(self):
        """A port snapshot through the reference's registry_from_snapshot
        and back through the port's is the same snapshot, and both
        rebuilt registries expose the same bytes."""
        snap = json.loads(json.dumps(_sample_registry().snapshot()))
        theirs = jobs.registry_from_snapshot(snap)
        assert theirs.snapshot() == snap
        back = registry_from_snapshot(
            json.loads(json.dumps(theirs.snapshot())))
        assert back.snapshot() == snap
        assert to_prometheus(back) == jobs.to_prometheus(theirs)

    def test_engine_registry_roundtrips(self):
        eng = _engine(slo_classes=[_EASY])
        eng.add_request(_PROMPTS[0], max_new_tokens=4, slo_class="interactive")
        eng.run()
        snap = eng.metrics.snapshot()
        rebuilt = registry_from_snapshot(json.loads(json.dumps(snap)))
        assert rebuilt.snapshot() == snap
        assert rebuilt.get("serving_ttft_seconds").percentile(50) > 0
        assert jobs.registry_from_snapshot(snap).snapshot() == snap


# ------------------------------------------------------ lifecycle tracker

class TestLifecycleTracker:
    def test_retention_order_and_stages(self):
        lt = LifecycleTracker()
        lt.point(3, "enqueued", t=1.0)
        lt.point(3, "admitted", t=2.0)
        lt.span(3, "prefill", 2.0, 2.5)
        lt.span(3, "decode_block", 2.5, 3.0, retain=False)
        lt.point(3, "finished", t=3.0)
        assert lt.stages(3) == ["enqueued", "admitted", "prefill",
                                "finished"]
        assert lt.events(3)[2] == ("prefill", 2.0, 2.5)
        assert lt.request_ids() == [3]
        assert "prefill" in lt.timeline(3)

    def test_retention_is_bounded(self):
        lt = LifecycleTracker(max_events_per_request=4)
        for i in range(10):
            lt.point(1, f"s{i}", t=float(i))
        assert len(lt.events(1)) == 4
        assert lt.dropped == 6

    def test_spans_fold_into_profiler_chrome_trace(self, tmp_path):
        lt = LifecycleTracker(tag="tp=2")
        prof = P.Profiler(timer_only=True,
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path)))
        prof.start()
        lt.point(7, "enqueued")
        lt.span(7, "prefill", 10.0, 10.5)
        prof.stop()
        files = list(tmp_path.glob("*.pt.trace.json"))
        assert files
        events = P.load_profiler_result(str(files[0]))["traceEvents"]
        names = [e["name"] for e in events]
        assert "serving.request[7].enqueued@tp=2" in names
        assert "serving.request[7].prefill@tp=2" in names
        span = next(e for e in events if "prefill" in e["name"])
        assert span["ph"] == "X" and span["ts"] == 10.0 * 1e6
        assert span["dur"] == pytest.approx(0.5 * 1e6)
        assert lt.stages(7) == ["enqueued", "prefill"]   # untagged

    def test_unarmed_spans_stay_out_of_profiler_but_are_retained(self):
        before = len(P._HOST_TRACER.events)
        lt = LifecycleTracker()
        lt.point(9, "enqueued")
        assert len(P._HOST_TRACER.events) == before    # no armed window
        assert lt.stages(9) == ["enqueued"]


# ---------------------------------------------------------------- profiler

class TestProfiler:
    def test_scheduler_windows_match_the_reference(self):
        from paddle_tpu import profiler as jprof

        ours = P.make_scheduler(closed=1, ready=1, record=2, repeat=2,
                                skip_first=1)
        theirs = jprof.make_scheduler(closed=1, ready=1, record=2,
                                      repeat=2, skip_first=1)
        assert [ours(i).name for i in range(12)] == \
            [theirs(i).name for i in range(12)]

    def test_windows_export_once_each(self, tmp_path):
        prof = P.Profiler(scheduler=P.make_scheduler(closed=1, ready=0,
                                                     record=2, repeat=2),
                          timer_only=True,
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path), "w"))
        with prof:
            for i in range(7):
                with P.RecordEvent(f"step{i}"):
                    pass
                prof.step()
        files = sorted(p.name for p in tmp_path.glob("*.pt.trace.json"))
        assert len(files) == 2
        names = [[e["name"] for e in P.load_profiler_result(
            str(tmp_path / f))["traceEvents"]] for f in files]
        assert sorted(names[0] + names[1]) == ["step1", "step2", "step4",
                                               "step5"]
        assert "step1" in prof.summary()

    def test_device_trace_holds_the_engine_spans(self, tmp_path):
        """A window with the device target runs torch.profiler: on the CPU
        its trace holds the engine's RecordEvent spans as user
        annotations, beside the host tracer's own export."""
        eng = _engine()
        eng.add_request(_PROMPTS[0], max_new_tokens=6)
        eng.step()
        prof = P.Profiler(profile_dir=str(tmp_path / "dev"),
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path / "host")))
        with prof:
            eng.run()
        assert prof.device_trace_path is not None
        dev = P.load_profiler_result(prof.device_trace_path)
        names = {e.get("name") for e in dev["traceEvents"]}
        assert "serving.decode_block" in names
        assert "serving.host_drain" in names
        host = P.load_profiler_result(prof._last_export)
        hnames = {e["name"] for e in host["traceEvents"]}
        assert "serving.decode_block" in hnames
        assert any(n.startswith("serving.request[") for n in hnames)

    def test_device_trace_failure_warns_and_keeps_host_spans(
            self, monkeypatch, tmp_path):
        import torch.profiler as tp

        def broken(*a, **k):
            raise RuntimeError("no tracer here")

        monkeypatch.setattr(tp, "profile", broken)
        prof = P.Profiler(on_trace_ready=P.export_chrome_tracing(
            str(tmp_path)))
        with pytest.warns(RuntimeWarning, match="device trace unavailable"):
            prof.start()
        with P.RecordEvent("host_only"):
            pass
        prof.stop()
        assert prof.device_trace_path is None
        events = P.load_profiler_result(prof._last_export)["traceEvents"]
        assert [e["name"] for e in events] == ["host_only"]


# ----------------------------------------------------- histogram window

class TestHistogramWindow:
    def test_percentiles_match_exact_rank_recomputation(self):
        rng = np.random.default_rng(7)
        h = Histogram("w_test_seconds")
        win = HistogramWindow(h)
        for v in rng.lognormal(mean=2.0, sigma=0.5, size=200):
            h.observe(float(v))
        win.anchor()
        post = [float(v) for v in
                rng.lognormal(mean=-4.0, sigma=1.0, size=500)]
        for v in post:
            h.observe(v)
        post.sort()
        n = len(post)
        assert win.count == n
        assert abs(win.sum - sum(post)) < 1e-9
        for q in (10.0, 50.0, 90.0, 95.0, 99.0):
            exact = post[max(1, math.ceil(q / 100.0 * n)) - 1]
            est = win.percentile(q)
            ratio = est / exact
            assert 1.0 / h.growth * 0.999 <= ratio <= h.growth * 1.001, \
                (q, est, exact)

    def test_window_excludes_pre_anchor_observations(self):
        h = Histogram("w_iso_seconds")
        win = HistogramWindow(h)
        for _ in range(50):
            h.observe(100.0)
        win.anchor()
        for _ in range(10):
            h.observe(0.001)
        assert win.count == 10
        assert win.percentile(99.0) < 0.01
        assert h.percentile(50.0) > 1.0

    def test_fraction_within_exact_on_point_masses(self):
        h = Histogram("w_frac_seconds")
        win = HistogramWindow(h)
        win.anchor()
        for _ in range(5):
            h.observe(0.001)
        for _ in range(5):
            h.observe(100.0)
        assert win.fraction_within(1.0) == pytest.approx(0.5)
        assert win.fraction_within(500.0) == pytest.approx(1.0)
        assert win.fraction_within(1e-5) == pytest.approx(0.0)

    def test_empty_window_is_vacuously_attained(self):
        h = Histogram("w_empty_seconds")
        h.observe(3.0)
        win = HistogramWindow(h)
        win.anchor()
        assert win.count == 0
        assert win.percentile(50.0) == 0.0
        assert win.fraction_within(1e-9) == 1.0
        assert win.summary() == Histogram.empty_summary()

    def test_re_anchor_slides_forward(self):
        h = Histogram("w_slide_seconds")
        win = HistogramWindow(h)
        win.anchor()
        h.observe(100.0)
        assert win.fraction_within(1.0) == pytest.approx(0.0)
        win.anchor()
        h.observe(0.001)
        assert win.count == 1
        assert win.fraction_within(1.0) == pytest.approx(1.0)

    def test_percentile_range_validation(self):
        win = HistogramWindow(Histogram("w_val_seconds"))
        with pytest.raises(ValueError, match="percentile"):
            win.percentile(101.0)

    def test_summaries_equal_the_jax_package(self):
        rng = np.random.default_rng(11)
        pre = rng.lognormal(0.0, 1.0, 100).tolist()
        post = rng.lognormal(-3.0, 1.5, 300).tolist()
        out = []
        for hist_cls, win_cls in ((Histogram, HistogramWindow),
                                  (jobs.Histogram, jobs.HistogramWindow)):
            h = hist_cls("w_cross_seconds")
            win = win_cls(h)
            for v in pre:
                h.observe(v)
            win.anchor()
            for v in post:
                h.observe(v)
            out.append((win.summary(), [win.fraction_within(x)
                                        for x in (1e-4, 0.01, 0.1, 10.0)]))
        assert out[0] == out[1]


# --------------------------------------------------------- SLO tracker

class TestSloClassValidation:
    def test_bad_targets_raise(self):
        with pytest.raises(ValueError, match="positive"):
            SloClass("x", ttft_target_s=0.0, tpot_target_s=1.0)
        with pytest.raises(ValueError, match="positive"):
            SloClass("x", ttft_target_s=1.0, tpot_target_s=-2.0)
        with pytest.raises(ValueError, match="name"):
            SloClass("", ttft_target_s=1.0, tpot_target_s=1.0)

    def test_tracker_validation(self):
        r = MetricsRegistry()
        with pytest.raises(ValueError, match="at least one"):
            SloTracker(r, [])
        with pytest.raises(ValueError, match="duplicate"):
            SloTracker(r, [_EASY, _EASY])
        with pytest.raises(ValueError, match="refresh_every"):
            SloTracker(r, [_EASY], refresh_every=0)


class TestSloTracker:
    def test_goodput_counts_only_within_target(self):
        r = MetricsRegistry()
        tr = SloTracker(r, [SloClass("a", 1.0, 0.1)])
        tr.first_token("a", 0.5)
        tr.first_token("a", 2.0)
        tr.decode_tokens("a", 0.05, 4)
        tr.decode_tokens("a", 0.5, 4)
        st = tr.summary()["a"]
        assert st["goodput_tokens"] == 5
        assert tr.goodput_tokens == 5
        assert st["lifetime"]["ttft"]["count"] == 2
        assert st["lifetime"]["tpot"]["count"] == 8

    def test_unknown_class_is_ignored(self):
        tr = SloTracker(MetricsRegistry(), [_EASY])
        tr.first_token(None, 0.1)
        tr.first_token("nope", 0.1)
        tr.decode_tokens("nope", 0.1, 3)
        assert tr.goodput_tokens == 0
        assert not tr.has_class("nope") and tr.has_class("interactive")

    def test_attainment_gauges_from_window_fractions(self):
        r = MetricsRegistry()
        tr = SloTracker(r, [SloClass("a", 1.0, 1.0)])
        for ttft in (0.001, 0.002, 0.003, 100.0):
            tr.first_token("a", ttft)
        tr.refresh(advance=False)
        st = tr.summary()["a"]
        assert st["attainment"]["ttft"] == pytest.approx(0.75)
        assert st["attainment"]["tpot"] == 1.0
        g = r.get("serving_slo_attainment", {"slo_class": "a",
                                             "slo": "ttft"})
        assert g.value == pytest.approx(0.75)

    def test_step_tick_refreshes_and_advances_every_n(self):
        r = MetricsRegistry()
        tr = SloTracker(r, [SloClass("a", 1.0, 1.0)], refresh_every=2)
        tr.first_token("a", 100.0)
        tr.step_tick()
        g = r.get("serving_slo_attainment", {"slo_class": "a",
                                             "slo": "ttft"})
        assert g.value == 1.0
        tr.step_tick()
        assert g.value == pytest.approx(0.0)
        tr.first_token("a", 0.001)
        tr.step_tick()
        tr.step_tick()
        assert g.value == pytest.approx(1.0)

    def test_summary_shape(self):
        tr = SloTracker(MetricsRegistry(), [_EASY, _HARD])
        s = tr.summary()
        assert set(s) == {"interactive", "tight"}
        for row in s.values():
            assert set(row) == {"targets", "window", "lifetime",
                                "attainment", "goodput_tokens"}
            assert set(row["window"]) == {"ttft", "tpot"}

    def test_summaries_equal_the_jax_package(self):
        """The same (class, seconds) script through both trackers, ticks
        and refreshes included: equal summaries, goodput and exposition."""
        rng = np.random.default_rng(5)
        script = [(str(c), float(t), int(k)) for c, t, k in zip(
            rng.choice(["a", "b", "none"], 200),
            rng.lognormal(-3.0, 1.5, 200), rng.integers(1, 9, 200))]
        out = []
        for reg_cls, cls_cls, tr_cls, prom in (
                (MetricsRegistry, SloClass, SloTracker, to_prometheus),
                (jobs.MetricsRegistry, jobs.SloClass, jobs.SloTracker,
                 jobs.to_prometheus)):
            reg = reg_cls()
            tr = tr_cls(reg, [cls_cls("a", 0.05, 0.02),
                              cls_cls("b", 0.5, 0.1)], refresh_every=7)
            for i, (c, t, k) in enumerate(script):
                if i % 3:
                    tr.decode_tokens(c, t, k)
                else:
                    tr.first_token(c, t)
                tr.step_tick()
            out.append((tr.summary(), tr.goodput_tokens, prom(reg)))
        assert out[0] == out[1]


# ----------------------------------------------------- flight recorder

class TestFlightRecorder:
    def test_capacity_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            FlightRecorder(capacity=0)

    def test_ring_evicts_oldest_seq_survives(self):
        rec = FlightRecorder(capacity=4)
        for i in range(10):
            rec.record("dispatch", i=i)
        assert len(rec) == 4
        assert rec.total_recorded == 10
        evs = rec.events()
        assert [e["seq"] for e in evs] == [7, 8, 9, 10]
        assert [e["i"] for e in evs] == [6, 7, 8, 9]
        assert evs[0]["kind"] == "dispatch"
        ts = [e["t"] for e in evs]
        assert ts == sorted(ts)

    def test_clear(self):
        rec = FlightRecorder(capacity=8)
        rec.record("fault", site="dispatch")
        rec.clear()
        assert len(rec) == 0 and rec.total_recorded == 1

    def test_describe_fault_taxonomy(self):
        from paddle_tpu_torch.serving.resilience import InjectedFault
        d = describe_fault(InjectedFault("dispatch", 0, transient=True))
        assert d == {"exc": "InjectedFault", "transient": True,
                     "fatal": False}
        d = describe_fault(ValueError("boom"))
        assert d["exc"] == "ValueError" and not d["fatal"]


class TestPostmortemBundle:
    def test_build_without_sources_is_self_describing(self):
        b = build_postmortem("unit-test")
        assert b["schema"] == POSTMORTEM_SCHEMA == "paddle_tpu.postmortem/v1"
        assert b["reason"] == "unit-test"
        assert b["events"] == [] and b["events_total"] == 0
        assert b["metrics"] is None and b["requests"] == []
        json.dumps(b)

    def test_journal_tail_carries_counts_never_tokens(self):
        j = RequestJournal()
        j.submit(request_id=1, prompt=[1, 2, 3], max_new_tokens=4,
                 temperature=0.0, top_k=0, top_p=1.0, seed=7,
                 eos_token_id=None, deadline_wall=None)
        j.tokens(1, [5, 6, 7])
        b = build_postmortem("unit-test", journal=j)
        [row] = b["journal_tail"]
        assert row["delivered_tokens"] == 3
        text = json.dumps(b)
        assert "[5, 6, 7]" not in text and '"tokens": [5' not in text

    def test_dump_collision_safe_and_parseable(self, tmp_path):
        rec = FlightRecorder()
        rec.record("dead", reason="x")
        b = build_postmortem("dead: weird/reason !", recorder=rec)
        p1 = dump_postmortem(b, str(tmp_path))
        p2 = dump_postmortem(b, str(tmp_path))
        assert p1 != p2 and os.path.exists(p1) and os.path.exists(p2)
        assert "/" not in os.path.basename(p1).replace(".json", "") \
            .replace("postmortem-", "").replace("-", "")
        with open(p1) as f:
            again = json.load(f)
        assert again["schema"] == POSTMORTEM_SCHEMA
        assert again["events"][0]["kind"] == "dead"


# ----------------------------------------------------- engine SLO layer

class TestEngineSlo:
    def test_slo_classes_require_metrics(self):
        with pytest.raises(ValueError, match="enable_metrics"):
            _engine(slo_classes=[_EASY], enable_metrics=False)

    def test_unknown_class_rejected_at_add_request(self):
        eng = _engine(slo_classes=[_EASY])
        with pytest.raises(ValueError, match="SLO class"):
            eng.add_request([1, 2, 3], max_new_tokens=2,
                            slo_class="nope")
        eng2 = _engine()
        with pytest.raises(ValueError, match="SLO class"):
            eng2.add_request([1, 2, 3], max_new_tokens=2,
                             slo_class="interactive")
        assert not eng.requests and not eng2.requests

    def test_goodput_equals_tokens_under_generous_targets(self):
        eng = _engine(slo_classes=[_EASY, _HARD])
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6,
                              slo_class="interactive")
        plain = eng.add_request(_PROMPTS[1], max_new_tokens=6)
        out = eng.run()
        assert len(out[rid]) == len(_PROMPTS[0]) + 6
        st = eng.stats()
        slo = st["slo"]["interactive"]
        assert slo["goodput_tokens"] == 6
        assert st["goodput_tokens"] == 6
        assert slo["attainment"]["ttft"] == 1.0
        assert slo["attainment"]["tpot"] == 1.0
        assert slo["lifetime"]["ttft"]["count"] == 1
        assert slo["lifetime"]["tpot"]["count"] == 5
        assert st["slo"]["tight"]["goodput_tokens"] == 0
        rows = st["requests"]
        assert rows[rid]["slo_class"] == "interactive"
        assert rows[plain]["slo_class"] is None

    def test_impossible_targets_zero_goodput_zero_attainment(self):
        eng = _engine(slo_classes=[_HARD])
        eng.add_request(_PROMPTS[0], max_new_tokens=6, slo_class="tight")
        eng.run()
        st = eng.stats()["slo"]["tight"]
        assert st["goodput_tokens"] == 0
        assert st["attainment"]["ttft"] == pytest.approx(0.0)
        assert st["attainment"]["tpot"] == pytest.approx(0.0)
        assert eng.stats()["tokens_generated"] == 6

    @pytest.mark.parametrize("chunked", [False, True])
    def test_goodput_matches_the_jax_engine(self, chunked):
        """The same script on both engines under generous targets: equal
        per-class goodput, TTFT / TPOT sample counts and total goodput."""
        kw = (dict(enable_chunked_prefill=True, prefill_chunk_tokens=8)
              if chunked else {})
        out = []
        for make, cls in ((_engine, SloClass), (_jengine, jobs.SloClass)):
            eng = make(slo_classes=[cls("interactive", 600.0, 600.0),
                                    cls("batch", 600.0, 600.0)], **kw)
            for i, p in enumerate(_PROMPTS):
                eng.add_request(p, max_new_tokens=7, temperature=0.0,
                                slo_class=("interactive", "batch",
                                           None)[i])
            eng.run()
            st = eng.stats()
            out.append((st["goodput_tokens"], {
                name: (row["goodput_tokens"],
                       row["lifetime"]["ttft"]["count"],
                       row["lifetime"]["tpot"]["count"])
                for name, row in st["slo"].items()}))
        assert out[0] == out[1]
        assert out[0][0] == 14

    def test_step_breakdown_shape_and_population(self):
        eng = _engine()
        eng.add_request(_PROMPTS[0], max_new_tokens=6)
        eng.run()
        bd = eng.stats()["step_breakdown"]
        assert set(bd) == {"schedule", "assemble", "dispatch", "drain",
                           "device_residency"}
        for phase in ("schedule", "assemble", "dispatch", "drain"):
            assert bd[phase]["count"] > 0, phase
            assert bd[phase]["sum"] >= 0.0
        assert bd["device_residency"]["count"] > 0
        eng2 = _engine(enable_metrics=False)
        bd2 = eng2.stats()["step_breakdown"]
        assert set(bd2) == set(bd)
        assert all(v["count"] == 0 for v in bd2.values())

    def test_slo_refresh_every_validation(self):
        with pytest.raises(ValueError, match="refresh_every"):
            _engine(slo_classes=[_EASY], slo_refresh_every=0)

    def test_adopt_request_takes_a_registered_class_only(self):
        eng = _engine(slo_classes=[_EASY])
        with pytest.raises(ValueError, match="SLO class"):
            eng.adopt_request(prompt=_PROMPTS[0], delivered=[1],
                              max_new_tokens=4, seed=7, slo_class="nope")
        rid = eng.adopt_request(prompt=_PROMPTS[0], delivered=[1],
                                max_new_tokens=4, seed=7,
                                slo_class="interactive")
        eng.run()
        assert eng.stats()["slo"]["interactive"]["goodput_tokens"] == 3
        assert "adopted" in eng._obs.lifecycle.stages(rid)


# ------------------------------------------------------ engine lifecycle

class TestEngineLifecycle:
    def test_scheduler_lifecycle_ordering_under_preemption(self):
        obs = ServingObs(MetricsRegistry())
        alloc = BlockAllocator(6)                    # 5 usable pages
        sched = Scheduler(alloc, page_size=4, max_batch_size=2,
                          max_pages_per_seq=8, obs=obs)
        a = Request(prompt=[1] * 8, max_new_tokens=8,
                    sampling=SamplingParams())
        b = Request(prompt=[2] * 4, max_new_tokens=8,
                    sampling=SamplingParams())
        sched.add(a)
        sched.add(b)
        assert sched.schedule().prefill is a
        assert sched.schedule().prefill is b
        a.generated = [0] * 5
        b.generated = [0] * 2
        d = sched.schedule()
        assert d.kind == "decode" and d.decode == [a]
        assert b.status == "waiting" and b.preemptions == 1
        assert obs.preemptions.value == 1
        assert obs.lifecycle.stages(b.request_id) == [
            "enqueued", "admitted", "preempted", "requeued"]
        sched.finish(a)
        assert sched.schedule().prefill is b
        assert obs.lifecycle.stages(b.request_id) == [
            "enqueued", "admitted", "preempted", "requeued", "admitted"]
        assert obs.lifecycle.stages(a.request_id)[-1] == "finished"
        times = [t0 for _, t0, _ in obs.lifecycle.events(b.request_id)]
        assert times == sorted(times)

    @pytest.mark.parametrize("kw", [
        {}, dict(num_pages=8, max_batch_size=3, decode_horizon=1),
        dict(enable_chunked_prefill=True, prefill_chunk_tokens=8)])
    def test_stages_match_the_jax_engine(self, kw):
        """Retained lifecycle stages, request by request, equal the JAX
        engine's: plain, under preemption, and chunked with the ragged
        step."""
        stages = []
        for make in (_engine, _jengine):
            eng = make(**kw)
            rids = [eng.add_request(p, max_new_tokens=8, temperature=0.0)
                    for p in _PROMPTS]
            eng.run()
            stages.append([eng._obs.lifecycle.stages(r) for r in rids])
        assert stages[0] == stages[1]
        assert all(s[0] == "enqueued" and s[-1] == "finished"
                   for s in stages[0])

    def test_chrome_trace_renders_through_trace_summary(self, tmp_path,
                                                        capsys):
        eng = _engine()
        prof = P.Profiler(timer_only=True,
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path)))
        prof.start()
        rid = eng.add_request([1, 2, 3, 4], max_new_tokens=4)
        eng.run()
        prof.stop()
        with open(prof._last_export) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        for stage in ("enqueued", "admitted", "prefill", "first_token",
                      "decode_block", "finished"):
            assert f"serving.request[{rid}].{stage}" in names, stage
        assert "serving.prefill" in names
        assert "serving.host_drain" in names
        ts = _tool("trace_summary")
        assert ts.main([prof._last_export, "--requests"]) == 0
        out = capsys.readouterr().out
        assert "serving.decode_block" in out
        assert f"request {rid}" in out and "first_token" in out

    def test_prefix_cache_lookup_span(self, tmp_path):
        eng = _engine(enable_prefix_caching=True)
        prof = P.Profiler(timer_only=True,
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path)))
        with prof:
            eng.add_request(_PROMPTS[2], max_new_tokens=2)
            eng.run()
        with open(prof._last_export) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        assert "serving.prefix_cache.lookup" in names


# ------------------------------------------------ engine recorder layer

def _recorder_script(events, rids):
    """(kind, where) per recorded event, request ids replaced by their
    submission index (the packages count ids apart)."""
    index = {r: i for i, r in enumerate(rids)}
    out = []
    for e in events:
        where = (e.get("site") or e.get("family") or e.get("decision")
                 or e.get("status"))
        rid = e.get("rid", e.get("prefill"))
        out.append((e["kind"], where, index.get(rid)))
    return out


class TestEngineRecorder:
    def test_recorder_sees_the_step_lifecycle(self):
        rec = FlightRecorder(capacity=1024)
        eng = _engine(flight_recorder=rec)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        eng.run()
        kinds = [e["kind"] for e in rec.events()]
        for k in ("schedule", "dispatch", "drain", "terminal"):
            assert k in kinds, (k, kinds)
        term = [e for e in rec.events() if e["kind"] == "terminal"]
        assert term[-1]["rid"] == rid
        assert term[-1]["status"] == "finished"

    def test_same_fault_script_same_records_as_the_jax_engine(
            self, monkeypatch):
        """One scripted injector (a transient dispatch fault retried, a
        persistent one quarantining its request, a transient drain fault)
        on both engines, the JAX engine's paged attention in interpret
        mode: the same sequence of recorder kinds, sites / families /
        decisions / statuses and requests, and the same survivors."""
        import paddle_tpu.serving.attention as jatt

        monkeypatch.setattr(jatt, "KERNEL_MODE", "interpret")
        interpreted = jobs.global_registry().counter(
            "serving_attention_dispatch_total",
            labels={"path": "decode_pallas_interpret"})
        before = interpreted.value
        out = []
        for make, inj_cls in ((_engine, FaultInjector),
                              (_jengine, JFaultInjector)):
            fi = (inj_cls().fail_at("dispatch", 1, transient=True)
                  .fail_at("dispatch", 3, transient=False)
                  .fail_at("drain", 1, transient=True))
            rec = (FlightRecorder if make is _engine
                   else jobs.FlightRecorder)(capacity=4096)
            # page_size 8: the JAX Pallas decode kernel's shape gate, and
            # a page geometry no other JAX engine in this file compiles
            eng = make(fault_injector=fi, flight_recorder=rec, page_size=8,
                       num_pages=32)
            rids = [eng.add_request(p, max_new_tokens=6, temperature=0.0)
                    for p in _PROMPTS]
            res = eng.run()
            out.append((_recorder_script(rec.events(), rids),
                        [eng.status(r)[0] for r in rids],
                        [res[r] for r in rids]))
        assert out[0][0] == out[1][0]
        assert out[0][1] == out[1][1]
        assert "failed" in out[0][1] and "finished" in out[0][1]
        assert out[0][2] == out[1][2]
        assert interpreted.value > before    # the JAX decode interpreted
        kinds = {k for k, _, _ in out[0][0]}
        assert {"schedule", "dispatch", "drain", "fault", "quarantine",
                "terminal"} <= kinds

    def test_quarantine_auto_dumps_bundle(self, tmp_path):
        fi = FaultInjector().fail_at("dispatch", 0, transient=False)
        rec = FlightRecorder(capacity=256)
        eng = _engine(fault_injector=fi, flight_recorder=rec,
                      postmortem_dir=str(tmp_path))
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=6)
        eng.run()
        assert eng.status(rid)[0] == "failed"
        assert eng.last_postmortem_path is not None
        with open(eng.last_postmortem_path) as f:
            bundle = json.load(f)
        assert bundle["schema"] == POSTMORTEM_SCHEMA
        assert bundle["reason"].startswith("quarantine-")
        kinds = [e["kind"] for e in bundle["events"]]
        assert "fault" in kinds and "quarantine" in kinds
        q = next(e for e in bundle["events"] if e["kind"] == "quarantine")
        assert rid in q["rids"]
        [row] = [r for r in bundle["requests"]
                 if r["request_id"] == rid]
        assert row["status"] == "failed"

    def test_dump_without_directory_raises(self):
        eng = _engine(flight_recorder=FlightRecorder())
        with pytest.raises(ValueError, match="directory"):
            eng.dump_postmortem("manual")

    def test_manual_bundle_from_healthy_engine(self, tmp_path):
        eng = _engine(flight_recorder=FlightRecorder(),
                      journal=RequestJournal())
        eng.add_request(_PROMPTS[0], max_new_tokens=4)
        eng.run()
        path = eng.dump_postmortem("manual", directory=str(tmp_path))
        with open(path) as f:
            b = json.load(f)
        assert b["reason"] == "manual"
        assert b["journal_tail"][0]["delivered_tokens"] == 4
        assert b["metrics"] is not None
        pm = _tool("postmortem")
        text = pm.render(pm.load_bundle(path))
        assert "post-mortem:" in text and "manual" in text
        assert pm.main([path]) == 0

    def test_bundles_carry_the_jax_engines_schema_and_keys(self):
        bundles = []
        for make, rec_cls, j_cls in (
                (_engine, FlightRecorder, RequestJournal),
                (_jengine, jobs.FlightRecorder, JRequestJournal)):
            eng = make(flight_recorder=rec_cls(), journal=j_cls())
            eng.add_request(_PROMPTS[0], max_new_tokens=4,
                            temperature=0.0)
            eng.run()
            bundles.append(json.loads(json.dumps(
                eng.build_postmortem("manual", info={"k": 1}))))
        ours, theirs = bundles
        assert ours["schema"] == theirs["schema"] == POSTMORTEM_SCHEMA
        assert set(ours) == set(theirs)
        for key in ("requests", "journal_tail", "events"):
            assert [set(r) for r in ours[key]] == \
                [set(r) for r in theirs[key]], key
        assert set(ours["metrics"]) == set(theirs["metrics"])


# ------------------------------------------------------ zero-cost guards

class TestZeroCostWhenDisabled:
    def _poison(self, monkeypatch):
        import paddle_tpu_torch.observability.flight_recorder as fr
        import paddle_tpu_torch.observability.slo as slo

        def boom(*a, **kw):
            raise AssertionError(
                "SLO/recorder work on a disabled hot path")

        for cls, meth in [(slo.SloTracker, "first_token"),
                          (slo.SloTracker, "decode_tokens"),
                          (slo.SloTracker, "step_tick"),
                          (slo.SloTracker, "refresh"),
                          (slo.HistogramWindow, "anchor"),
                          (slo.HistogramWindow, "fraction_within"),
                          (fr.FlightRecorder, "record")]:
            monkeypatch.setattr(cls, meth, boom)
        monkeypatch.setattr(fr, "build_postmortem", boom)

    def test_metrics_disabled_engine_never_touches_slo_or_recorder(
            self, monkeypatch):
        eng = _engine(enable_metrics=False)
        assert eng._slo is None and eng._recorder is None
        eng.add_request([9, 8, 7], max_new_tokens=3)
        eng.run()
        self._poison(monkeypatch)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=4)
        out = eng.run()
        assert len(out[rid]) == len(_PROMPTS[0]) + 4
        st = eng.stats()
        assert st["slo"] == {} and st["goodput_tokens"] == 0

    def test_metrics_on_but_no_slo_no_recorder_is_also_clean(
            self, monkeypatch):
        eng = _engine()
        assert eng._slo is None and eng._recorder is None
        eng.add_request([9, 8, 7], max_new_tokens=3)
        eng.run()
        self._poison(monkeypatch)
        rid = eng.add_request(_PROMPTS[0], max_new_tokens=4)
        out = eng.run()
        assert len(out[rid]) == len(_PROMPTS[0]) + 4
        st = eng.stats()
        assert st["slo"] == {} and st["goodput_tokens"] == 0

    def test_disarmed_record_event_touches_no_torch_profiler(
            self, monkeypatch, tmp_path):
        """Every torch.profiler entry the port could reach counts its
        calls: an engine serving with no window armed makes none, and the
        same engine inside an armed window makes some (the pin is live)."""
        import torch.autograd.profiler as tap
        import torch.profiler as tp

        calls = []
        real = tp.record_function

        def counted(*a, **kw):
            calls.append(a)
            return real(*a, **kw)

        for mod in (tp, tap):
            monkeypatch.setattr(mod, "record_function", counted)
        eng = _engine(enable_prefix_caching=True,
                      flight_recorder=FlightRecorder(),
                      slo_classes=[_EASY])
        for p in _PROMPTS:
            eng.add_request(p, max_new_tokens=5, slo_class="interactive")
        eng.run()
        assert calls == []
        prof = P.Profiler(timer_only=True)
        with prof:
            eng.add_request(_PROMPTS[0], max_new_tokens=5)
            eng.run()
        assert ("serving.decode_block",) in calls


# ------------------------------------------------- supervisor forensics

class TestSupervisorDeathBundle:
    def test_engine_dead_leaves_a_bundle(self, tmp_path):
        rec = FlightRecorder(capacity=512)
        fi = FaultInjector().fail_at("device_lost", 1)

        def factory():
            return _engine(fault_injector=fi, flight_recorder=rec,
                           postmortem_dir=str(tmp_path))

        sup = EngineSupervisor(factory, journal=RequestJournal(),
                               max_restarts=0)
        sup.add_request(_PROMPTS[0], max_new_tokens=6)
        engine = sup.engine
        with pytest.raises(EngineDead):
            sup.run()
        assert sup.postmortem is not None
        assert sup.postmortem["reason"].startswith("dead-")
        kinds = [e["kind"] for e in sup.postmortem["events"]]
        assert "fault" in kinds and "dead" in kinds
        dead = next(e for e in sup.postmortem["events"]
                    if e["kind"] == "dead")
        assert dead["restarts"] == 0
        assert sup.postmortem_path and os.path.exists(sup.postmortem_path)
        with open(sup.postmortem_path) as f:
            assert json.load(f)["schema"] == POSTMORTEM_SCHEMA
        assert sup._dead_recorder is rec
        assert engine.cache.pools == []          # the pools went with it
        pm = _tool("postmortem")
        assert "!!" in pm.render(pm.load_bundle(sup.postmortem_path))

    def test_restart_recorded_when_supervisor_recovers(self, tmp_path,
                                                        capsys):
        rec = FlightRecorder(capacity=512)
        fi = FaultInjector().fail_at("device_lost", 1)

        def factory():
            return _engine(fault_injector=fi, flight_recorder=rec)

        sup = EngineSupervisor(factory, journal=RequestJournal())
        prof = P.Profiler(timer_only=True,
                          on_trace_ready=P.export_chrome_tracing(
                              str(tmp_path)))
        with prof:
            rid = sup.add_request(_PROMPTS[0], max_new_tokens=6)
            out = sup.run()
        assert len(out[rid]) == len(_PROMPTS[0]) + 6
        restarts = [e for e in rec.events() if e["kind"] == "restart"]
        assert len(restarts) == 1
        assert restarts[0]["readmitted"] == 1
        with open(prof._last_export) as f:
            events = json.load(f)["traceEvents"]
        span = [e for e in events
                if e["name"] == "serving.recovery[1].fatal_fault"]
        assert len(span) == 1 and span[0]["cat"] == "Recovery"
        ts = _tool("trace_summary")
        assert ts.main([prof._last_export, "--requests"]) == 0
        assert "restart #1" in capsys.readouterr().out
