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
(on the model's device). `make_causal_lm_train_step(model, opt)` returns
`step(ids, labels, generator) -> loss` for a decoder (GPT, LLaMA):
`model(ids, labels=labels)`, the shifted causal LM loss (through the
fused head when the config's `fused_lm_loss` asks for it), under the same
O1 bf16, then the same backward and update; the generator reaches the
forward only when the model's forward takes one (LLaMA has no dropout).
`make_moe_train_step(layer, opt)` returns
`step(x, target) -> loss` for an `MoELayer`: `mse_loss(layer(x), target)
+ 0.01 * layer.aux_loss` under the same O1 bf16 (0.01 is the Switch
Transformer's load-balancing coefficient alpha), the composition the
reference's MoE tests make by hand, then the same backward and update;
with `group`, the layer runs expert-parallel over its ranks
(`MoELayer.expert_parallel_forward`), each rank on its share of the
tokens of x and of target. The steps make no host sync: the loss comes
back as a device tensor, and reading it is the caller's choice.

Each step takes an amp `level` ("O1" by default; "O2" after
`amp.decorate`, which makes the parameters bf16 and gives the optimizer
fp32 master weights) and an optional `scaler` (`amp.GradScaler`): the loss
is scaled before the backward, `scaler.step` unscales the gradients, reads
the found-inf flag (the step's one host read) and skips the update on
inf / NaN, and `scaler.update` moves the scale. The gradient clip and the
learning-rate schedule belong to the optimizer (`grad_clip=`, an
`LRScheduler` as its `learning_rate`, which the caller steps), as in the
reference.
"""
from __future__ import annotations

import inspect
from typing import Callable

import torch

from . import amp
from .nn import torch_functional as F

__all__ = ["make_train_step", "make_seq2seq_train_step",
           "make_causal_lm_train_step", "make_moe_train_step"]


def _update(loss: torch.Tensor, opt: torch.optim.Optimizer, scaler) -> None:
    """Backward and one optimizer update (through the scaler when there is
    one: scale, backward, `scaler.step`, `scaler.update`), then the
    gradients dropped."""
    if scaler is None:
        loss.backward()
        opt.step()
    else:
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
    opt.zero_grad(set_to_none=True)


def make_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                    scaler=None, level: str = "O1"
                    ) -> Callable[[torch.Tensor, torch.Tensor,
                                   torch.Generator], torch.Tensor]:
    def step(ids: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        model.train()
        with amp.auto_cast(level=level, dtype="bfloat16"):
            loss, _ = model(ids, masked_lm_labels=labels,
                            generator=generator)
        _update(loss, opt, scaler)
        return loss.detach()

    return step


def make_seq2seq_train_step(model: torch.nn.Module,
                            opt: torch.optim.Optimizer, scaler=None,
                            level: str = "O1"
                            ) -> Callable[[torch.Tensor, torch.Tensor,
                                           torch.Generator], torch.Tensor]:
    def step(input_ids: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        model.train()
        decoder_input_ids = model.shift_right(labels)
        with amp.auto_cast(level=level, dtype="bfloat16"):
            logits = model(input_ids, decoder_input_ids, generator=generator)
            loss = model.loss(logits, labels)
        _update(loss, opt, scaler)
        return loss.detach()

    return step


def make_causal_lm_train_step(model: torch.nn.Module,
                              opt: torch.optim.Optimizer, scaler=None,
                              level: str = "O1"
                              ) -> Callable[[torch.Tensor, torch.Tensor,
                                             torch.Generator], torch.Tensor]:
    takes_generator = "generator" in inspect.signature(
        model.forward).parameters

    def step(ids: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        model.train()
        kw = {"generator": generator} if takes_generator else {}
        with amp.auto_cast(level=level, dtype="bfloat16"):
            loss = model(ids, labels=labels, **kw)
        _update(loss, opt, scaler)
        return loss.detach()

    return step


def make_moe_train_step(layer: torch.nn.Module, opt: torch.optim.Optimizer,
                        group=None, scaler=None, level: str = "O1"
                        ) -> Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]:
    def step(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        layer.train()
        with amp.auto_cast(level=level, dtype="bfloat16"):
            if group is None:
                y = layer(x)
            else:
                y = layer.expert_parallel_forward(x, group)
                rows = target.reshape(-1, target.shape[-1])
                per = rows.shape[0] // group.nranks
                target = rows[group.rank * per:(group.rank + 1) * per]
            loss = F.mse_loss(y, target) + 0.01 * layer.aux_loss
        _update(loss, opt, scaler)
        return loss.detach()

    return step
