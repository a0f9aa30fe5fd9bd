"""Adam under paddle's names (counterpart of
paddle_tpu/optimizer/__init__.py:328-367).

One update is the reference's `Adam._apply_update`, applied to every
parameter with one global step count t as its `functional_step`
(:233-248) does:

    m1 = beta1 * m1 + (1 - beta1) * g
    m2 = beta2 * m2 + (1 - beta2) * g * g
    p -= lr * (m1 / (1 - beta1^t)) / (sqrt(m2 / (1 - beta2^t)) + epsilon)

with fp32 parameters and moments. A parameter whose gradient is None (a
head the loss does not reach) takes a zero gradient, as the reference's
jax.grad gives it. Parameters and moments are updated in place with
PyTorch's multi-tensor (`_foreach`) ops, a handful of launches for the
whole model. Low-precision parameters with fp32 master weights
(`multi_precision`) are not ported yet.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch

__all__ = ["Adam"]


class Adam(torch.optim.Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters: Iterable[torch.nn.Parameter] = None):
        if parameters is None:
            raise ValueError("Adam needs `parameters`")
        parameters = list(parameters)
        if any(p.dtype != torch.float32 for p in parameters):
            raise NotImplementedError(
                "Adam takes fp32 parameters; low-precision parameters with "
                "fp32 masters (multi_precision) are not ported yet (ROADMAP "
                "T5)")
        super().__init__(parameters,
                         dict(lr=float(learning_rate), beta1=float(beta1),
                              beta2=float(beta2), epsilon=float(epsilon)))
        self.step_count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.step_count += 1
        t = self.step_count
        for group in self.param_groups:
            b1, b2 = group["beta1"], group["beta2"]
            params, grads, m1s, m2s = [], [], [], []
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["moment1"] = torch.zeros_like(p)
                    st["moment2"] = torch.zeros_like(p)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                params.append(p)
                grads.append(g)
                m1s.append(st["moment1"])
                m2s.append(st["moment2"])
            torch._foreach_mul_(m1s, b1)
            torch._foreach_add_(m1s, grads, alpha=1.0 - b1)
            torch._foreach_mul_(m2s, b2)
            torch._foreach_addcmul_(m2s, grads, grads, value=1.0 - b2)
            # sqrt(m2 / bc2) + eps, and the step lr / bc1
            denom = torch._foreach_sqrt(m2s)
            torch._foreach_div_(denom, math.sqrt(1.0 - b2 ** t))
            torch._foreach_add_(denom, group["epsilon"])
            torch._foreach_addcdiv_(params, m1s, denom,
                                    value=-group["lr"] / (1.0 - b1 ** t))
        return None
