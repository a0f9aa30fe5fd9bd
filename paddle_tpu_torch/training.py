"""The pretraining steps (counterpart of `make_train_step`, bench.py:830-869,
and of the seq2seq loop of tests/test_t5.py:48-66).

`make_train_step(model, opt)` returns `step(ids, labels, generator) ->
loss`: the forward under `amp.auto_cast` O1 bf16 with `masked_lm_labels`
(the fused MLM loss when the config asks for it), `loss.backward()`, one
optimizer update, and the gradients dropped. `make_seq2seq_train_step(model,
opt)` returns `step(input_ids, labels, generator) -> loss` for an
encoder-decoder (T5): `model.shift_right(labels)` as the decoder inputs,
the forward and `model.loss` under the same O1 bf16, then the same
backward and update. Hidden and attention dropout draw from `generator`
(on the model's device). `make_moe_train_step(layer, opt)` returns
`step(x, target) -> loss` for an `MoELayer`: `mse_loss(layer(x), target)
+ 0.01 * layer.aux_loss` under the same O1 bf16 (0.01 is the Switch
Transformer's load-balancing coefficient alpha), the composition the
reference's MoE tests make by hand, then the same backward and update;
with `group`, the layer runs expert-parallel over its ranks
(`MoELayer.expert_parallel_forward`), each rank on its share of the
tokens of x and of target. The steps make no host sync: the loss comes
back as a device tensor, and reading it is the caller's choice.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import amp
from .nn import functional as F

__all__ = ["make_train_step", "make_seq2seq_train_step",
           "make_moe_train_step"]


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


def make_seq2seq_train_step(model: torch.nn.Module,
                            opt: torch.optim.Optimizer
                            ) -> Callable[[torch.Tensor, torch.Tensor,
                                           torch.Generator], torch.Tensor]:
    def step(input_ids: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        model.train()
        decoder_input_ids = model.shift_right(labels)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(input_ids, decoder_input_ids, generator=generator)
            loss = model.loss(logits, labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step


def make_moe_train_step(layer: torch.nn.Module, opt: torch.optim.Optimizer,
                        group=None) -> Callable[[torch.Tensor, torch.Tensor],
                                                torch.Tensor]:
    def step(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        layer.train()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            if group is None:
                y = layer(x)
            else:
                y = layer.expert_parallel_forward(x, group)
                rows = target.reshape(-1, target.shape[-1])
                per = rows.shape[0] // group.nranks
                target = rows[group.rank * per:(group.rank + 1) * per]
            loss = F.mse_loss(y, target) + 0.01 * layer.aux_loss
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step
