"""Gradient clipping under paddle's names (counterpart of
paddle_tpu/nn/clip.py).

A clip object is given to an optimizer (`grad_clip=`), which applies its
`_clip_fn()` to the list of gradients inside the update, after the coupled
weight decay; called on a list of (param, grad) pairs it returns the
clipped pairs. Everything stays on the device: the norms are tensors, the
factors multiply as tensors, and nothing is read on the host. The global
norm is one `torch._foreach_norm` reduction over all gradients (each
gradient's norm in fp32), then the norm of those norms.

A parameter with `need_clip = False` keeps its gradient in the pair form.
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]

_TINY = 1e-12


def _norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's L2 norm as an fp32 scalar tensor."""
    return list(torch._foreach_norm(grads, 2, dtype=torch.float32))


def _factor(clip_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """min(clip_norm / max(norm, 1e-12), 1), on the device."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=_TINY), max=1.0)


class ClipGradBase:
    def _clip_fn(self):
        """(list of gradients) -> list of clipped gradients."""
        raise NotImplementedError

    def __call__(self, params_grads):
        keep = [i for i, (p, g) in enumerate(params_grads)
                if g is not None and getattr(p, "need_clip", True)]
        out = list(params_grads)
        if not keep:
            return out
        clipped = self._clip_fn()([params_grads[i][1] for i in keep])
        for i, g in zip(keep, clipped):
            out[i] = (params_grads[i][0], g)
        return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip_fn(self):
        def fn(grads):
            return [torch.clamp(g, self.min, self.max) for g in grads]

        return fn


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to at most `clip_norm` in its own L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip_fn(self):
        def fn(grads):
            return [(g * _factor(self.clip_norm, n)).to(g.dtype)
                    for g, n in zip(grads, _norms(grads))]

        return fn


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by min(clip_norm / global norm, 1), the global
    norm over every gradient of the list."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @staticmethod
    def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
        return torch.linalg.vector_norm(torch.stack(_norms(grads)))

    def _clip_fn(self):
        def fn(grads):
            if not grads:
                return grads
            factor = _factor(self.clip_norm, self.global_norm(grads))
            return [(g * factor).to(g.dtype) for g in grads]

        return fn


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the parameters' gradients in place so that their total
    `norm_type` norm is at most `max_norm`; returns the total norm (a
    device tensor)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    grads = [p.grad for p in params]
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in grads]).max()
    else:
        total = torch.linalg.vector_norm(torch.stack(list(
            torch._foreach_norm(grads, norm_type, dtype=torch.float32))),
            norm_type)
    factor = _factor(float(max_norm), total)
    for p in params:
        p.grad.copy_((p.grad * factor).to(p.grad.dtype))
    return total
