"""The optimizer wrapper of hybrid-parallel training (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/hybrid_parallel_optimizer.py:
29-154).

`HybridParallelClipGrad` is the global-norm clip over the hybrid
topology's ranks: the squared norms of the mp-split parameters
(`is_distributed`) are summed over the mp group, those of replicated
parameters counted once, and the total summed over the pp and sharding
groups (each sum in rank order), so every rank scales by the one global
norm. `HybridParallelOptimizer` swaps it in for a plain
`ClipGradByGlobalNorm`, as the reference's does, delegates the rest of the
optimizer and builds the ZeRO step at the topology's degrees
(`zero_train_step`).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ....nn.clip import ClipGradByGlobalNorm, _factor
from ....parallel.mesh import ordered_psum

__all__ = ["HybridParallelOptimizer", "HybridParallelClipGrad",
           "is_mp_split"]


def is_mp_split(p) -> bool:
    """Whether parameter `p` is split over mp (fleet's layers set
    `is_distributed = True`; a plain tensor's `is_distributed` is a
    method, not a flag)."""
    return getattr(p, "is_distributed", False) is True


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    def __init__(self, clip: ClipGradByGlobalNorm, hcg=None):
        super().__init__(clip.clip_norm, clip.group_name)
        self._clip = clip
        self._hcg = hcg
        # one flag a gradient, in the order the optimizer passes them
        self._dist_flags: Optional[List[bool]] = None

    def _groups(self, axes):
        if self._hcg is None:
            return []
        get = {"mp": self._hcg.get_model_parallel_group,
               "pp": self._hcg.get_pipe_parallel_group,
               "sharding": self._hcg.get_sharding_parallel_group}
        return [g for g in (get[a]() for a in axes)
                if g.nranks > 1 and g.pg is not None]

    def hybrid_global_norm(self, grads: List[torch.Tensor],
                           dist_flags: List[bool]) -> torch.Tensor:
        """The global norm of gradients spread over the topology."""
        dev = grads[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def sq(gs):
            return sum((torch.sum(g.float() ** 2) for g in gs), zero)

        dist = sq([g for g, d in zip(grads, dist_flags) if d])
        repl = sq([g for g, d in zip(grads, dist_flags) if not d])
        for g in self._groups(("mp",)):
            dist = ordered_psum(dist.reshape(1), g)[0]
        total = dist + repl
        for g in self._groups(("pp", "sharding")):
            total = ordered_psum(total.reshape(1), g)[0]
        return torch.sqrt(total)

    def _clip_fn(self):
        def fn(grads):
            if not grads:
                return grads
            flags = self._dist_flags or [False] * len(grads)
            factor = _factor(self.clip_norm,
                             self.hybrid_global_norm(list(grads), flags))
            return [(g * factor).to(g.dtype) for g in grads]

        return fn

    def __call__(self, params_grads):
        keep = [(p, g) for p, g in params_grads
                if g is not None and getattr(p, "need_clip", True)]
        self._dist_flags = [is_mp_split(p) for p, _ in keep]
        return super().__call__(params_grads)


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        inner_clip = getattr(optimizer, "_grad_clip", None)
        if isinstance(inner_clip, ClipGradByGlobalNorm) and not isinstance(
                inner_clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(inner_clip, hcg)

    @property
    def inner_opt(self):
        return self._inner_opt

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _mark(self) -> None:
        clip = getattr(self._inner_opt, "_grad_clip", None)
        if isinstance(clip, HybridParallelClipGrad):
            clip._dist_flags = [is_mp_split(p)
                                for p in self._inner_opt._parameter_list]

    def step(self):
        self._mark()
        return self._inner_opt.step()

    def clear_grad(self, *a, **k):
        return self._inner_opt.clear_grad(*a, **k)

    def minimize(self, loss, *a, **k):
        self._mark()
        return self._inner_opt.minimize(loss, *a, **k)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def functional_state(self, params):
        return self._inner_opt.functional_state(params)

    def functional_step(self, *a, **k):
        return self._inner_opt.functional_step(*a, **k)

    def zero_train_step(self, model, loss_fn=None, *, stage=None, **kwargs):
        """The ZeRO step at the topology's degrees: dp over the sharding
        group (or, without one, the data-parallel group), tp over the mp
        group. `stage` defaults to 1 when the sharding degree is above 1,
        else 0."""
        from ....parallel.zero import ZeroTrainStep

        hcg = self._hcg
        if hcg is None:
            return ZeroTrainStep(model, self._inner_opt, loss_fn,
                                 stage=1 if stage is None else int(stage),
                                 **kwargs)
        sharding = hcg.get_sharding_parallel_world_size()
        group = (hcg.get_sharding_parallel_group() if sharding > 1
                 else hcg.get_data_parallel_group())
        if stage is None:
            stage = 1 if sharding > 1 else 0
        mp = hcg.get_model_parallel_world_size()
        if mp > 1:
            kwargs.setdefault("tp", mp)
            kwargs.setdefault("tp_group", hcg.get_model_parallel_group())
        return ZeroTrainStep(model, self._inner_opt, loss_fn,
                             stage=int(stage), group=group, **kwargs)
