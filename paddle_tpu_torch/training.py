"""The pretraining step (counterpart of `make_train_step`, bench.py:830-869).

`make_train_step(model, opt)` returns `step(ids, labels, generator) ->
loss`: the forward under `amp.auto_cast` O1 bf16 with `masked_lm_labels`
(the fused MLM loss when the config asks for it), `loss.backward()`, one
optimizer update, and the gradients dropped. Hidden and attention dropout
draw from `generator` (on the model's device). The step makes no host
sync: the loss comes back as a device tensor, and reading it is the
caller's choice.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import amp

__all__ = ["make_train_step"]


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer
                    ) -> Callable[[torch.Tensor, torch.Tensor,
                                   torch.Generator], torch.Tensor]:
    def step(ids: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        model.train()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss, _ = model(ids, masked_lm_labels=labels,
                            generator=generator)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step
