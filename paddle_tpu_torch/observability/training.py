"""The training observability plane (counterpart of
paddle_tpu/observability/training.py): the ZeRO trainer's telemetry,
divergence sentinel and post-mortem bundles.

Two rules, as in the reference:

- **nothing when off**: `ZeroTrainStep` imports this module lazily, and
  only when a telemetry knob is set;
- **one device-to-host copy a step when on**: every health number of a
  step (loss, global gradient norm, parameter norm, update norm, the
  non-finite counts, and under bf16 the loss scale and the skipped flag)
  is computed on the device (`pack_health`) into one fp32 vector, read in
  one copy (`TrainingTelemetry._host_read`). The telemetry-on step's
  parameters and state are the telemetry-off step's: the health numbers
  only read values the update produced.

Pieces:

- the device helpers `sumsq`, `nonfinite_count`, `combine_leaf_stats`,
  `grad_leaf_stats` and `pack_health`; the cross-rank sums use the same
  rank-order `mesh.ordered_psum` as the update, so every rank holds the
  same vector;
- `TrainingTelemetry`: the `training_step_phase_seconds{phase=}`
  histograms (batch_build / dispatch / host_drain), tokens/s and
  tokens/s/rank gauges, health gauges and step / token / host-sync
  counters, labelled with the {dp, tp, stage} geometry; a ring of recent
  step scalars; flight-recorder events a step;
- `DivergenceSentinel`: a sliding-window monitor (`HistogramWindow`
  bucket-delta means as the reference) over loss and gradient norm that
  flags nan / loss_spike / grad_spike / plateau; a tripped condition
  writes one `paddle_tpu.postmortem/v1` training bundle through
  `flight_recorder` (readable by tools/postmortem.py) and raises
  `TrainingDiverged`;
- `probe_best_of`, the straggler probe's minimum.

A bundle carries scalars only (the step ring, the metrics snapshot, the
sentinel's verdict and the geometry): never parameter, gradient or state
values, never batch contents.
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from .flight_recorder import FlightRecorder, build_postmortem, \
    dump_postmortem
from .metrics import MetricsRegistry
from .slo import HistogramWindow

__all__ = [
    "HEALTH_FIELDS", "SCALER_FIELDS", "TRAINING_SNAPSHOT_SCHEMA",
    "SentinelConfig", "DivergenceSentinel", "TrainingDiverged",
    "TrainingTelemetry", "probe_best_of",
    "sumsq", "nonfinite_count", "combine_leaf_stats", "grad_leaf_stats",
    "pack_health",
]

# the packed health vector, index-aligned with `pack_health`
HEALTH_FIELDS = ("loss", "grad_norm", "param_norm", "update_norm",
                 "nonfinite_grads", "nonfinite_params")

# appended after the six under bf16 dynamic loss scaling
SCALER_FIELDS = ("loss_scale", "skipped_step")

TRAINING_SNAPSHOT_SCHEMA = "paddle_tpu.training_telemetry/v1"

# host wall split of one call: slice the batch, run the step, drain the
# health vector
PHASES = ("batch_build", "dispatch", "host_drain")


def probe_best_of(trials):
    """The straggler probe's estimator: the minimum of the trials (never
    rises as trials are added)."""
    return min(trials)


# ------------------------------------------------------------ device
# These run inside the step on device tensors and never read the host.

def sumsq(x: torch.Tensor) -> torch.Tensor:
    """fp32 sum of squares of one tensor."""
    return torch.sum(torch.square(x.float().reshape(-1)))


def nonfinite_count(x: torch.Tensor) -> torch.Tensor:
    """fp32 count of NaN / inf elements of one tensor."""
    return (~torch.isfinite(x)).sum().float()


def combine_leaf_stats(vec: torch.Tensor, group, dp_reduce: bool
                       ) -> torch.Tensor:
    """Per-leaf stat rows (nleaves, k) summed over the ranks of `group` in
    rank order when `dp_reduce` (the sharded path's slices partition each
    leaf over the ranks); replicated rows pass as they are (summing them
    would multiply them by dp)."""
    from ..parallel.mesh import ordered_psum

    return ordered_psum(vec, group) if dp_reduce else vec


def grad_leaf_stats(ctx, per_leaf, dp_reduce: bool):
    """(grad sum of squares, non-finite count) over the leaves `per_leaf`
    (the mean gradients on the replicated path, this rank's slices on the
    sharded path: the zero padding adds 0 to both)."""
    names = list(per_leaf)
    rows = torch.stack([torch.stack([sumsq(per_leaf[k]),
                                     nonfinite_count(per_leaf[k])])
                        for k in names])
    vec = combine_leaf_stats(rows, ctx.group, dp_reduce)
    return vec[:, 0].sum(), vec[:, 1].sum()


def pack_health(ctx, loss, old_params, new_params, grad_aux, extras=None):
    """The HEALTH_FIELDS scalars (and, under bf16, the SCALER_FIELDS
    pair) in one fp32 vector on the device: the step's one extra output,
    drained by `TrainingTelemetry._host_read` in one copy."""
    names = list(new_params)
    rows = torch.stack([torch.stack([
        sumsq(new_params[k]),
        sumsq(new_params[k].float() - old_params[k].float()),
        nonfinite_count(new_params[k]),
    ]) for k in names])
    gsq, nfg = grad_aux
    fields = [loss.float().reshape(()), torch.sqrt(gsq),
              torch.sqrt(rows[:, 0].sum()), torch.sqrt(rows[:, 1].sum()),
              nfg.reshape(()), rows[:, 2].sum()]
    if extras is not None:
        fields.extend(e.float().reshape(()) for e in extras)
    return torch.stack(fields)


# ------------------------------------------------------------- sentinel
@dataclass(frozen=True)
class SentinelConfig:
    """Divergence sentinel thresholds. The window references are
    HistogramWindow bucket-delta means re-anchored every `window`
    steps; spike verdicts compare the current value against the LAST
    COMPLETED window's mean, so a single noisy step inside a window
    never moves its own reference."""

    window: int = 32            # steps per reference window
    warmup_steps: int = 8       # no spike/plateau verdicts before this
    loss_spike_factor: float = 3.0
    grad_spike_factor: float = 10.0
    plateau_steps: int = 200    # steps without best-loss improvement
    plateau_rtol: float = 1e-3  # relative improvement that resets it
    # conditions that RAISE TrainingDiverged (others only flag + count;
    # plateau defaults to flag-only — a stalled run is a tuning
    # problem, not a crash)
    trip_on: Tuple[str, ...] = ("nan", "loss_spike", "grad_spike")
    max_bundles: int = 1        # postmortem bundles per sentinel life

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1 (got {self.window})")
        if self.loss_spike_factor <= 1.0 or self.grad_spike_factor <= 1.0:
            raise ValueError("spike factors must be > 1")
        unknown = set(self.trip_on) - {"nan", "loss_spike",
                                       "grad_spike", "plateau"}
        if unknown:
            raise ValueError(f"unknown trip conditions: {sorted(unknown)}")


class TrainingDiverged(RuntimeError):
    """Typed divergence signal: the sentinel tripped. Carries the
    verdict dict, the dumped bundle path (None if no postmortem_dir)
    and the bundle itself for in-process handling."""

    def __init__(self, message: str, *, verdict: Dict[str, Any],
                 bundle_path: Optional[str] = None,
                 bundle: Optional[Dict[str, Any]] = None):
        super().__init__(message)
        self.verdict = verdict
        self.bundle_path = bundle_path
        self.bundle = bundle


class DivergenceSentinel:
    """Sliding-window loss/grad-norm monitor.

    Observations land in two wide log-bucket histograms
    (`training_loss_observations` / `training_grad_norm_observations`);
    `HistogramWindow`s over them supply the per-window mean that
    becomes the spike reference — no second accumulator, the windows
    are pure bucket-delta views (slo.py discipline). `check` is the
    hot path: a handful of float compares per step.
    """

    CONDITIONS = ("nan", "loss_spike", "grad_spike", "plateau")

    def __init__(self, registry: MetricsRegistry,
                 config: Optional[SentinelConfig] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.config = config or SentinelConfig()
        lab = dict(labels or {})
        # wide range: losses/grad norms are not latency-shaped
        self._loss_hist = registry.histogram(
            "training_loss_observations",
            "per-step training loss (sentinel window source)",
            labels=lab or None, lo=1e-9, hi=1e9, growth=2.0 ** 0.5)
        self._grad_hist = registry.histogram(
            "training_grad_norm_observations",
            "per-step global grad norm (sentinel window source)",
            labels=lab or None, lo=1e-9, hi=1e9, growth=2.0 ** 0.5)
        self._loss_win = HistogramWindow(self._loss_hist)
        self._grad_win = HistogramWindow(self._grad_hist)
        self._flag_counters = {
            c: registry.counter(
                "training_sentinel_flags_total",
                "sentinel conditions flagged (tripped or not)",
                labels={**lab, "condition": c})
            for c in self.CONDITIONS
        }
        self._loss_ref: Optional[float] = None
        self._grad_ref: Optional[float] = None
        self._in_window = 0
        self._seen = 0
        self._best_loss = math.inf
        self._best_step = 0
        self._last_verdict: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------ hot path
    def check(self, *, step: int, loss: float, grad_norm: float,
              nonfinite: float) -> Optional[Dict[str, Any]]:
        """Feed one step's scalars; returns a verdict dict when a
        condition fires (caller decides whether `tripped` escalates),
        else None."""
        self._seen += 1
        cfg = self.config
        if nonfinite > 0 or loss != loss or grad_norm != grad_norm \
                or math.isinf(loss) or math.isinf(grad_norm):
            return self._verdict(
                "nan", step, loss, grad_norm,
                detail=f"nonfinite={nonfinite:g}")
        self._loss_hist.observe(loss)
        self._grad_hist.observe(grad_norm)
        warm = self._seen > cfg.warmup_steps
        if warm and self._loss_ref is not None and \
                loss > cfg.loss_spike_factor * max(self._loss_ref, 1e-12):
            return self._verdict(
                "loss_spike", step, loss, grad_norm,
                detail=f"ref={self._loss_ref:g} "
                       f"factor={cfg.loss_spike_factor:g}")
        if warm and self._grad_ref is not None and \
                grad_norm > cfg.grad_spike_factor * max(self._grad_ref,
                                                        1e-12):
            return self._verdict(
                "grad_spike", step, loss, grad_norm,
                detail=f"ref={self._grad_ref:g} "
                       f"factor={cfg.grad_spike_factor:g}")
        if loss < self._best_loss * (1.0 - cfg.plateau_rtol):
            self._best_loss = loss
            self._best_step = step
        elif warm and step - self._best_step >= cfg.plateau_steps:
            self._best_step = step  # re-arm: one flag per plateau span
            return self._verdict(
                "plateau", step, loss, grad_norm,
                detail=f"best={self._best_loss:g} over last "
                       f"{cfg.plateau_steps} steps")
        self._in_window += 1
        if self._in_window >= cfg.window:
            self._roll_window()
        return None

    def _roll_window(self) -> None:
        """Close the current window: its mean becomes the next spike
        reference, and both windows re-anchor."""
        if self._loss_win.count:
            self._loss_ref = self._loss_win.sum / self._loss_win.count
        if self._grad_win.count:
            self._grad_ref = self._grad_win.sum / self._grad_win.count
        self._loss_win.anchor()
        self._grad_win.anchor()
        self._in_window = 0

    def _verdict(self, condition: str, step: int, loss: float,
                 grad_norm: float, detail: str) -> Dict[str, Any]:
        self._flag_counters[condition].inc()
        v = {
            "condition": condition,
            "step": step,
            "loss": loss,
            "grad_norm": grad_norm,
            "detail": detail,
            "tripped": condition in self.config.trip_on,
            "message": f"sentinel: {condition} at step {step} "
                       f"(loss={loss:g} grad_norm={grad_norm:g}; "
                       f"{detail})",
        }
        self._last_verdict = v
        return v

    # ----------------------------------------------------------- cold path
    def state(self) -> Dict[str, Any]:
        """JSON-able sentinel state for snapshots and bundles."""
        return {
            "seen": self._seen,
            "loss_ref": self._loss_ref,
            "grad_ref": self._grad_ref,
            "best_loss": (None if math.isinf(self._best_loss)
                          else self._best_loss),
            "best_step": self._best_step,
            "flags": {c: self._flag_counters[c].value
                      for c in self.CONDITIONS},
            "last_verdict": self._last_verdict,
            "config": asdict(self.config),
        }


# ------------------------------------------------------------ telemetry
class TrainingTelemetry:
    """The per-trainer telemetry plane. Construct (optionally with your
    own registry/recorder/sentinel config), pass as
    `ZeroTrainStep(..., telemetry=...)` — or let
    `enable_telemetry=True` build this default. The trainer calls
    `bind()` once with its geometry (resolve-handles-once, metrics.py
    discipline) and `record_step()` once per step."""

    PHASES = PHASES

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 sentinel: Optional[SentinelConfig] = None,
                 enable_sentinel: bool = True,
                 recorder: Optional[FlightRecorder] = None,
                 enable_recorder: bool = True,
                 postmortem_dir: Optional[str] = None,
                 tokens_per_step: Optional[int] = None,
                 history: int = 128,
                 clock=time.perf_counter):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.recorder = recorder if recorder is not None else (
            FlightRecorder(256, clock=clock) if enable_recorder else None)
        self.postmortem_dir = postmortem_dir
        self.tokens_per_step = tokens_per_step
        self.clock = clock
        self._sentinel_cfg = sentinel if enable_sentinel else None
        if enable_sentinel and sentinel is None:
            self._sentinel_cfg = SentinelConfig()
        self.sentinel: Optional[DivergenceSentinel] = None
        self._ring: deque = deque(maxlen=max(int(history), 1))
        self._bundles_dumped = 0
        self.geometry: Dict[str, Any] = {}
        self._bound = False

    # ---------------------------------------------------------------- bind
    def bind(self, *, dp: int, tp: int, stage: int,
             device_ids: List[int]) -> None:
        """Resolve every metric handle once for this trainer's bounded
        {dp, tp, stage} label set. Idempotent for identical geometry;
        a second bind with different geometry is a bug (one telemetry
        plane per trainer)."""
        geometry = {"dp": int(dp), "tp": int(tp), "stage": int(stage),
                    "devices": [int(d) for d in device_ids]}
        if self._bound:
            if geometry != self.geometry:
                raise ValueError(
                    f"telemetry already bound to {self.geometry}; "
                    f"rebinding to {geometry} would mix series — build "
                    "one TrainingTelemetry per trainer")
            return
        self.geometry = geometry
        lab = {"dp": str(geometry["dp"]), "tp": str(geometry["tp"]),
               "stage": str(geometry["stage"])}
        self._labels = lab
        self._n_chips = max(len(geometry["devices"]), 1)
        reg = self.registry
        self._phase = {
            ph: reg.histogram(
                "training_step_phase_seconds",
                "host wall split of one train step by phase",
                labels={**lab, "phase": ph})
            for ph in PHASES
        }
        self._step_wall = reg.histogram(
            "training_step_seconds",
            "end-to-end host wall of one train step", labels=lab)
        self._steps = reg.counter(
            "training_steps_total", "train steps completed", labels=lab)
        self._tokens = reg.counter(
            "training_tokens_total", "tokens consumed", labels=lab)
        self._host_syncs = reg.counter(
            "training_host_syncs_total",
            "device->host drains (exactly one per step)", labels=lab)
        self._nonfinite_total = reg.counter(
            "training_nonfinite_total",
            "nonfinite grad/param elements seen", labels=lab)
        self._tps = reg.gauge(
            "training_tokens_per_sec",
            "tokens/sec over the last step's wall", labels=lab)
        self._tps_chip = reg.gauge(
            "training_tokens_per_sec_per_chip",
            "tokens/sec/chip over the last step's wall", labels=lab)
        self._health_gauges = {
            name: reg.gauge(f"training_{name}",
                            f"last step's {name}", labels=lab)
            for name in ("loss", "grad_norm", "param_norm", "update_norm")
        }
        # comms visibility and the mixed-precision scaler.
        # All label sets bounded (2 collectives, 2 scale events), so
        # resolve-once at bind keeps the hot path allocation-free.
        self._comm = {
            c: reg.histogram(
                "training_comm_seconds",
                "warmed best-of-N ZeRO collective probe "
                "(reduce-scatter / all-gather wall seconds)",
                labels={**lab, "collective": c})
            for c in ("reduce_scatter", "all_gather")
        }
        self._overlap_gauge = reg.gauge(
            "training_overlap_fraction",
            "measured fraction of bucket-collective wall hidden by the "
            "ring pipeline", labels=lab)
        self._loss_scale_gauge = reg.gauge(
            "training_loss_scale",
            "current dynamic loss scale (bf16 mixed precision)",
            labels=lab)
        self._scale_events = {
            ev: reg.counter(
                "training_loss_scale_events_total",
                "dynamic loss-scale transitions",
                labels={**lab, "event": ev})
            for ev in ("backoff", "growth")
        }
        self._skipped_steps = reg.counter(
            "training_skipped_steps_total",
            "optimizer steps skipped on nonfinite grads "
            "(dynamic loss scaling)", labels=lab)
        self._last_scale: Optional[float] = None
        self._overlap_fraction: Optional[float] = None
        if self._sentinel_cfg is not None:
            self.sentinel = DivergenceSentinel(
                reg, self._sentinel_cfg, labels=lab)
        self._bound = True

    # ------------------------------------------------------------ hot path
    def _host_read(self, health) -> List[float]:
        """THE one device->host copy of a telemetry-on step: the packed
        health vector. Everything record_step consumes is a plain host
        float after this."""
        return [float(v) for v in health.detach().to("cpu").tolist()]

    def record_step(self, health, *, step: int, tokens: int,
                    batch_build_s: float, dispatch_s: float) -> float:
        """Record one completed step: drains `health` (the step body's
        packed vector) in the one host sync, observes the three phase
        histograms, refreshes throughput + health gauges, appends to
        the step ring, records a flight-recorder event and runs the
        sentinel. Returns the host loss (the trainer hands it back to
        the caller so the caller's own loss read is NOT a second
        sync). Raises TrainingDiverged when the sentinel trips."""
        t0 = self.clock()
        vals = self._host_read(health)
        drain_s = self.clock() - t0
        loss, grad_norm, param_norm, update_norm, nfg, nfp = vals[:6]
        # bf16 mode appends the SCALER_FIELDS pair (same drain)
        loss_scale: Optional[float] = None
        skipped = False
        if len(vals) > 6:
            loss_scale = vals[6]
            skipped = vals[7] > 0.0
            prev = self._last_scale
            self._loss_scale_gauge.set(loss_scale)
            if prev is not None and loss_scale != prev:
                ev = "backoff" if loss_scale < prev else "growth"
                self._scale_events[ev].inc()
                if self.recorder is not None:
                    self.recorder.record(
                        "loss_scale", step=int(step), event=ev,
                        scale=loss_scale)
            self._last_scale = loss_scale
            if skipped:
                self._skipped_steps.inc()
        self._host_syncs.inc()
        self._steps.inc()
        self._tokens.inc(int(tokens))
        self._phase["batch_build"].observe(batch_build_s)
        self._phase["dispatch"].observe(dispatch_s)
        self._phase["host_drain"].observe(drain_s)
        wall = batch_build_s + dispatch_s + drain_s
        self._step_wall.observe(wall)
        tps = tokens / wall if wall > 0 else 0.0
        self._tps.set(tps)
        self._tps_chip.set(tps / self._n_chips)
        self._health_gauges["loss"].set(loss)
        self._health_gauges["grad_norm"].set(grad_norm)
        self._health_gauges["param_norm"].set(param_norm)
        self._health_gauges["update_norm"].set(update_norm)
        nonfinite = nfg + nfp
        if nonfinite > 0:
            self._nonfinite_total.inc(int(nonfinite))
        entry = {
            "step": int(step), "loss": loss, "grad_norm": grad_norm,
            "param_norm": param_norm, "update_norm": update_norm,
            "nonfinite": nonfinite, "tokens": int(tokens),
            "wall_s": wall,
        }
        if loss_scale is not None:
            entry["loss_scale"] = loss_scale
            entry["skipped"] = bool(skipped)
        self._ring.append(entry)
        if self.recorder is not None:
            self.recorder.record(
                "train_step", step=int(step), loss=loss,
                grad_norm=grad_norm, tokens=int(tokens), wall_s=wall)
        # a skipped step bypasses the sentinel entirely: its loss/grads
        # MAY be nonfinite, but the scaler already handled it (params
        # reverted, scale backed off) — a divergence trip would turn
        # the designed recovery path into a crash
        if self.sentinel is not None and not skipped:
            verdict = self.sentinel.check(
                step=int(step), loss=loss, grad_norm=grad_norm,
                nonfinite=nonfinite)
            if verdict is not None:
                if self.recorder is not None:
                    self.recorder.record(
                        "diverged", step=int(step),
                        condition=verdict["condition"],
                        tripped=verdict["tripped"])
                if verdict["tripped"]:
                    self._trip(verdict)
        return loss

    # ----------------------------------------------------------- cold path
    def _trip(self, verdict: Dict[str, Any]) -> None:
        """Tripped-sentinel path: build + (maybe) dump the training
        postmortem bundle, then raise. Deliberately NOT on the happy
        path — only a tripped verdict reaches here."""
        bundle = self.build_bundle(
            reason=f"diverged-{verdict['condition']}", verdict=verdict)
        path = None
        cfg = self.sentinel.config if self.sentinel is not None else None
        max_bundles = cfg.max_bundles if cfg is not None else 1
        if self.postmortem_dir and self._bundles_dumped < max_bundles:
            path = dump_postmortem(bundle, self.postmortem_dir,
                                   prefix="training-postmortem")
            self._bundles_dumped += 1
        raise TrainingDiverged(verdict["message"], verdict=verdict,
                               bundle_path=path, bundle=bundle)

    def build_bundle(self, reason: str,
                     verdict: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
        """A `paddle_tpu.postmortem/v1` bundle with the training
        section (`bundle["training"]`): recent step ring, sentinel
        state + verdict, geometry. Scalars only — never parameter,
        gradient or optimizer-state values (module docstring
        contract)."""
        bundle = build_postmortem(
            reason, recorder=self.recorder, registry=self.registry,
            info={"variant": "training", **self.geometry})
        bundle["training"] = {
            "schema": TRAINING_SNAPSHOT_SCHEMA,
            "geometry": dict(self.geometry),
            "steps": list(self._ring),
            "sentinel": (self.sentinel.state()
                         if self.sentinel is not None else None),
            "verdict": verdict,
        }
        return bundle

    def observe_comm(self, collective: str, seconds: float) -> None:
        """Publish one collective-probe measurement
        (`training_comm_seconds{collective=reduce_scatter|all_gather}`
        — resolve-once handles from bind)."""
        self._comm[collective].observe(seconds)

    def set_overlap_fraction(self, fraction: float) -> None:
        """Record the measured overlap fraction (see
        `ZeroTrainStep.measure_overlap_fraction`) — gauge + summary."""
        self._overlap_fraction = float(fraction)
        self._overlap_gauge.set(float(fraction))

    def observe_shard_step(self, shard: str, seconds: float) -> None:
        """Publish one straggler-probe measurement for a dp shard
        (bounded label: one series per dp row)."""
        self.registry.histogram(
            "training_shard_step_seconds",
            "warmed best-of-N per-dp-shard step-time probe",
            labels={**self._labels, "shard": str(shard)}).observe(seconds)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able telemetry snapshot (`tools/training_report.py`
        renders it): geometry, full metrics snapshot, step ring,
        sentinel state and the compact summary."""
        return {
            "schema": TRAINING_SNAPSHOT_SCHEMA,
            "geometry": dict(self.geometry),
            "metrics": self.registry.snapshot(),
            "steps": list(self._ring),
            "sentinel": (self.sentinel.state()
                         if self.sentinel is not None else None),
            "summary": self.summary(),
        }

    def summary(self) -> Dict[str, Any]:
        """Compact `describe()["telemetry"]` view."""
        if not self._bound:
            return {"bound": False}
        return {
            "bound": True,
            "geometry": dict(self.geometry),
            "steps": self._steps.value,
            "tokens": self._tokens.value,
            "host_syncs": self._host_syncs.value,
            "tokens_per_sec": self._tps.value,
            "tokens_per_sec_per_chip": self._tps_chip.value,
            "last": (dict(self._ring[-1]) if self._ring else None),
            "phases": {ph: h.summary() for ph, h in self._phase.items()},
            "comm": {c: h.summary() for c, h in self._comm.items()},
            "overlap_fraction": self._overlap_fraction,
            "loss_scale": self._last_scale,
            "skipped_steps": self._skipped_steps.value,
            "loss_scale_events": {
                ev: c.value for ev, c in self._scale_events.items()},
            "sentinel": (self.sentinel.state()
                         if self.sentinel is not None else None),
        }
