"""Distributed-configuration auto tuner (counterpart of
paddle_tpu/distributed/auto_tuner/__init__.py:1-168, copied: it is
host-only).

Paddle's auto_tuner searches the hybrid-parallel space (dp / mp / pp /
sharding degrees, micro batch, recompute) and keeps the fastest: the
same search / prune / record design, each candidate measured in-process
by the caller's cost function (for instance, the step time of a
`ZeroTrainStep` or a fleet model under that candidate). A failing trial
(out of memory, a shape the candidate cannot take) is recorded at
infinite cost, and the history is written as JSON for post-mortems.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["TuningConfig", "AutoTuner", "default_candidates"]


class TuningConfig:
    """One hybrid-parallel candidate."""

    __slots__ = ("dp_degree", "mp_degree", "pp_degree", "sharding_degree",
                 "micro_batch_size", "use_recompute")

    def __init__(self, dp_degree=1, mp_degree=1, pp_degree=1,
                 sharding_degree=1, micro_batch_size=1,
                 use_recompute=False):
        self.dp_degree = dp_degree
        self.mp_degree = mp_degree
        self.pp_degree = pp_degree
        self.sharding_degree = sharding_degree
        self.micro_batch_size = micro_batch_size
        self.use_recompute = use_recompute

    def to_dict(self) -> Dict:
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return ("TuningConfig(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in self.__slots__) + ")")

    def __eq__(self, other):
        return isinstance(other, TuningConfig) and \
            self.to_dict() == other.to_dict()

    def __hash__(self):
        return hash(tuple(sorted(self.to_dict().items())))


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def default_candidates(world_size: int, global_batch_size: int,
                       num_layers: Optional[int] = None,
                       num_attention_heads: Optional[int] = None,
                       vocab_size: Optional[int] = None,
                       tuning_space: Optional[Dict] = None
                       ) -> List[TuningConfig]:
    """Enumerate + prune the candidate space (the prune.py rule set):

    - dp * mp * pp * sharding must equal world_size;
    - mp must divide num_attention_heads (and vocab, if given);
    - pp must divide num_layers;
    - global batch must split evenly into dp * sharding replicas of an
      integral number of micro batches.
    """
    space = tuning_space or {}
    dims = _divisors(world_size)
    dp_c = space.get("dp_degree", dims)
    mp_c = space.get("mp_degree", dims)
    pp_c = space.get("pp_degree", dims)
    sh_c = space.get("sharding_degree", dims)
    mb_c = space.get("micro_batch_size", _divisors(global_batch_size))
    rc_c = space.get("use_recompute", [False, True])

    out: List[TuningConfig] = []
    seen = set()
    for dp, mp, pp, sh, mb, rc in itertools.product(
            dp_c, mp_c, pp_c, sh_c, mb_c, rc_c):
        if dp * mp * pp * sh != world_size:
            continue
        if num_attention_heads and num_attention_heads % mp != 0:
            continue
        if vocab_size and vocab_size % mp != 0:
            continue
        if num_layers and num_layers % pp != 0:
            continue
        replicas = dp * sh
        if global_batch_size % (replicas * mb) != 0:
            continue
        cfg = TuningConfig(dp, mp, pp, sh, mb, rc)
        if cfg in seen:
            continue
        seen.add(cfg)
        out.append(cfg)
    # search order heuristic (paddle's): plain dp first, then mp, then pp,
    # recompute variants last — cheap/likely-good configs run early so a
    # budgeted tune still covers them
    out.sort(key=lambda c: (c.use_recompute, c.pp_degree, c.mp_degree,
                            c.sharding_degree, -c.micro_batch_size))
    return out


class AutoTuner:
    """Measure candidates with a cost function and keep the argmin.

    `cost_fn(cfg) -> float` should build + run one (or a few) steps under
    the candidate and return a step cost (seconds). Exceptions mark the
    candidate infeasible (recorded, cost=inf) — the OOM-trial semantics of
    the upstream tuner.
    """

    def __init__(self, candidates: Sequence[TuningConfig],
                 log_dir: Optional[str] = None,
                 max_trials: Optional[int] = None,
                 time_budget_s: Optional[float] = None):
        self.candidates = list(candidates)
        self.log_dir = log_dir
        self.max_trials = max_trials
        self.time_budget_s = time_budget_s
        self.history: List[Dict] = []
        self.best: Optional[TuningConfig] = None
        self.best_cost = math.inf

    def tune(self, cost_fn: Callable[[TuningConfig], float]
             ) -> Optional[TuningConfig]:
        start = time.perf_counter()
        for i, cfg in enumerate(self.candidates):
            if self.max_trials is not None and i >= self.max_trials:
                break
            if self.time_budget_s is not None and \
                    time.perf_counter() - start > self.time_budget_s:
                break
            t0 = time.perf_counter()
            try:
                cost = float(cost_fn(cfg))
                error = None
            except Exception as e:  # infeasible trial (OOM/compile/shape)
                cost = math.inf
                error = f"{type(e).__name__}: {e}"
            rec = {"trial": i, "config": cfg.to_dict(), "cost": cost,
                   "wall_s": round(time.perf_counter() - t0, 3)}
            if error:
                rec["error"] = error[-500:]
            self.history.append(rec)
            if cost < self.best_cost:
                self.best, self.best_cost = cfg, cost
        self._write_log()
        return self.best

    def _write_log(self):
        if not self.log_dir:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "auto_tuner_history.json")
        with open(path, "w") as f:
            json.dump({
                "best": self.best.to_dict() if self.best else None,
                "best_cost": None if math.isinf(self.best_cost)
                else self.best_cost,
                "history": self.history,
            }, f, indent=2)
