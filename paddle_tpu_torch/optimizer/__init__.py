"""Optimizers under paddle's names (counterpart of
paddle_tpu/optimizer/__init__.py).

Each rule is written once, elementwise, over lists of tensors with
PyTorch's multi-tensor (`_foreach`) ops: `step()` applies it to the
parameters in place, and `functional_step(params, grads, state, lr, t)`
applies it to copies of any dict of named tensors, which is how the ZeRO
trainer (parallel/zero.py) updates its flat 1/dp slices. Updating a slice
and concatenating gives the same bits as updating the whole tensor,
because every operation is elementwise. (Lamb's trust ratio is a
whole-tensor norm; ZeRO refuses it.)

One update, `_update_tree`, keeps the reference's order (:127-150):

1. coupled L2 decay adds `coeff * p` to the gradient (only `L2Decay`, or
   a float `weight_decay`: an `L1Decay` is accepted and does nothing, as
   in the reference, :168-169, :240-241);
2. the gradient clip (`grad_clip`, nn/clip.py) over all gradients;
3. the decoupled decay (AdamW) multiplies the (master) weight by
   `1 - lr * coeff`;
4. the rule, on the fp32 master weight (`multi_precision` with a
   low-precision parameter: the `master_weight` slot) or on the
   parameter, then the parameter takes the master's value in its own
   type.

`learning_rate` is a float or an `LRScheduler` (`optimizer.lr`), read on
the host at each step; a parameter's `optimize_attr["learning_rate"]`
scales it. The step count `t` is a host int. No step reads the device.

A parameter whose gradient is None (a head the loss does not reach) takes
a zero gradient, as the reference's jitted steps get from `jax.grad`.

`Adam`'s update keeps the port's earlier form, so today's train cells
give the same bits:

    m1 = beta1 * m1 + (1 - beta1) * g
    m2 = beta2 * m2 + (1 - beta2) * g * g
    p -= lr / (1 - beta1^t) * m1 / (sqrt(m2) / sqrt(1 - beta2^t) + eps)

which is the reference's `lr * m1_hat / (sqrt(m2_hat) + eps)` up to
rounding. LBFGS is not ported (ROADMAP queue 1 item 6d).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import lr as lr_mod
from .lr import LRScheduler

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW", "Adamax",
    "AdamWDL", "RMSProp", "Adadelta", "Lamb", "LRScheduler", "lr",
    "Rprop", "ASGD", "NAdam", "RAdam", "L1Decay", "L2Decay",
]

lr = lr_mod

# the attributes that place a tensor among the ranks (fleet's mp layers,
# distributed.shard_tensor); distributed/checkpoint.py reads them
_PLACEMENT = ("is_distributed", "split_axis", "mp_rank", "mp_size",
              "interleave_heads", "process_mesh", "placements",
              "global_shape")

MASTER = "master_weight"


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _torch_param(p):
    """A paddle Parameter's torch tensor; a torch tensor or a group dict
    as it is."""
    return getattr(p, "_t", p)


def _low_precision(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.dtype != torch.float32


class Optimizer(torch.optim.Optimizer):
    """The base of every rule: parameter groups, weight decay, the clip,
    master weights, the learning rate and its scheduler, the state dict
    and the functional form. A subclass defines `_create_accumulators(p)`
    (its slots, fp32 unless it says otherwise) and `_rule(ps, gs, accs,
    lr, t)`, which updates the lists `ps` (fp32 working weights) and the
    slot dicts `accs` in place."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters is required in dygraph mode "
                             "(pass model.parameters())")
        # paddle Parameters (core.tensor) take part as their torch tensors
        parameters = [_torch_param(p) for p in parameters]
        if parameters and isinstance(parameters[0], dict):
            groups = [dict(g, params=[_torch_param(p) for p in g["params"]])
                      for g in parameters]
        else:
            groups = [{"params": parameters}]
        super().__init__(groups, {})
        self._learning_rate = learning_rate
        self.regularization = None
        if isinstance(weight_decay, (int, float)) and not isinstance(
                weight_decay, bool):
            self.regularization = L2Decay(weight_decay)
        elif weight_decay is not None:
            self.regularization = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._name = name
        self._step_count = 0
        self._names: Dict[int, str] = {}

    @property
    def _parameter_list(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    # ------------------------------------------------------------ hooks
    def _create_accumulators(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _rule(self, ps, gs, accs, lr_val: float, t: int) -> None:
        raise NotImplementedError

    def _decoupled_decay(self) -> float:
        """AdamW's decoupled weight decay coefficient (0: coupled)."""
        return 0.0

    def _coupled_decay(self) -> float:
        return (self.regularization.coeff
                if isinstance(self.regularization, L2Decay) else 0.0)

    # ------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.last_lr
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ------------------------------------------------------- the update
    def _new_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        acc = self._create_accumulators(p)
        if self._multi_precision and _low_precision(p):
            acc[MASTER] = p.detach().float()
        return acc

    def _update_tree(self, ps, gs, accs, lr_val: float, t: int,
                     lr_scales) -> None:
        """The reference's `_update_tree`, in place: `ps` are the
        parameters (any float type), `gs` their gradients, `accs` their
        slot dicts (a `master_weight` slot makes the rule run on it)."""
        coupled = self._coupled_decay()
        if coupled:
            gs = torch._foreach_add(
                gs, [p.to(g.dtype) for p, g in zip(ps, gs)], alpha=coupled)
        if self._grad_clip is not None:
            gs = self._grad_clip._clip_fn()(gs)
        decoupled = self._decoupled_decay()
        by_scale: Dict[float, List[int]] = {}
        for i, s in enumerate(lr_scales):
            by_scale.setdefault(float(s), []).append(i)
        for s, idx in by_scale.items():
            work, grads, slots, back = [], [], [], []
            for i in idx:
                p, g, acc = ps[i], gs[i], accs[i]
                if MASTER in acc:
                    w, g = acc[MASTER], g.float()
                elif _low_precision(p):
                    # no master: the rule runs on an fp32 copy, rounded
                    # back into p, as the reference's `(p.astype(f32) -
                    # upd).astype(p.dtype)`
                    w, g = p.detach().float(), g.float()
                    back.append((p, w))
                else:
                    w = p
                work.append(w)
                grads.append(g)
                slots.append({k: v for k, v in acc.items() if k != MASTER})
            if decoupled:
                torch._foreach_mul_(work, 1.0 - lr_val * decoupled)
            self._rule(work, grads, slots, lr_val * s, t)
            for i, w in zip(idx, work):
                if MASTER in accs[i]:
                    ps[i].copy_(w)
            for p, w in back:
                p.copy_(w)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__}.step takes no closure")
        params = self._parameter_list
        if not params:
            return None
        self._step_count += 1
        gs, accs = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st.update(self._new_slots(p))
            gs.append(p.grad if p.grad is not None else torch.zeros_like(p))
            accs.append(st)
        scales = [getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
                  for p in params]
        self._update_tree(params, gs, accs, self.get_lr(),
                          self._step_count, scales)
        return None

    def clear_grad(self, set_to_zero=True):
        self.zero_grad(set_to_none=not set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    # ---------------------------------------------------- functional form
    def functional_state(self, params_dict) -> Dict[str, Dict]:
        """The initial state of a functional step: {name: {slot: tensor}}
        (a `master_weight` fp32 slot for low-precision parameters under
        `multi_precision`)."""
        return {name: self._new_slots(data)
                for name, data in params_dict.items()}

    @torch.no_grad()
    def functional_step(self, params_dict, grads_dict, state, lr_val, t):
        """The same update as `step()` on copies: returns (new params,
        new state), leaving the inputs as they were. `lr_val` a float,
        `t` the 1-based step count (an int)."""
        names = list(params_dict)
        ps = [params_dict[n].detach().clone() for n in names]
        gs = [grads_dict[n] for n in names]
        accs = [{k: v.clone() for k, v in state[n].items()} for n in names]
        self._update_tree(ps, gs, accs, float(lr_val), int(t),
                          (1.0,) * len(names))
        return dict(zip(names, ps)), dict(zip(names, accs))

    # ------------------------------------------------------ state dict
    def _param_name(self, p: torch.Tensor) -> str:
        key = id(p)
        if key not in self._names:
            name = (getattr(p, "paddle_name", None)
                    or getattr(p, "name", None)
                    or f"param_{len(self._names)}")
            if name in self._names.values():
                name = f"{name}_{len(self._names)}"
            self._names[key] = name
        return self._names[key]

    def state_dict(self):
        """`{param}.{slot}` tensors, `@step_count` and, with a scheduler,
        `LR_Scheduler` (the reference's keys). A slot of its parameter's
        shape carries the parameter's placement (an mp split, a
        `shard_tensor` block), so a distributed checkpoint writes each
        rank's part of it."""
        out = {}
        for p in self._parameter_list:
            for slot, v in self.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    for attr in _PLACEMENT:
                        if hasattr(p, attr):
                            setattr(v, attr, getattr(p, attr))
                out[f"{self._param_name(p)}.{slot}"] = v
        out["@step_count"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict):
        self._step_count = int(state_dict.get("@step_count", 0))
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        by_name = {self._param_name(p): p for p in self._parameter_list}
        for key, val in state_dict.items():
            if key in ("@step_count", "LR_Scheduler"):
                continue
            pname, slot = key.rsplit(".", 1)
            p = by_name[pname]
            val = getattr(val, "_t", val)       # a Paddle Tensor's tensor
            self.state[p][slot] = torch.as_tensor(val).to(p.device).clone()

    load_state_dict = set_state_dict


def _zeros32(p):
    return torch.zeros_like(p, dtype=torch.float32)


class SGD(Optimizer):
    def _rule(self, ps, gs, accs, lr_val, t):
        torch._foreach_add_(ps, gs, alpha=-lr_val)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, p):
        return {"velocity": torch.zeros_like(
            p, dtype=torch.float32 if self._multi_precision else p.dtype)}

    def _rule(self, ps, gs, accs, lr_val, t):
        vs = [a["velocity"] for a in accs]
        torch._foreach_mul_(vs, self._momentum)
        torch._foreach_add_(vs, gs)
        if self._use_nesterov:
            step = torch._foreach_add(gs, vs, alpha=self._momentum)
            torch._foreach_add_(ps, step, alpha=-lr_val)
        else:
            torch._foreach_add_(ps, vs, alpha=-lr_val)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _rule(self, ps, gs, accs, lr_val, t):
        ms = [a["moment"] for a in accs]
        torch._foreach_addcmul_(ms, gs, gs)
        denom = torch._foreach_sqrt(ms)
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(ps, gs, denom, value=-lr_val)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._amsgrad = amsgrad

    def _create_accumulators(self, p):
        acc = {"moment1": _zeros32(p), "moment2": _zeros32(p)}
        if self._amsgrad:
            acc["moment2_max"] = _zeros32(p)
        return acc

    def _rule(self, ps, gs, accs, lr_val, t):
        b1, b2 = self._beta1, self._beta2
        m1s = [a["moment1"] for a in accs]
        m2s = [a["moment2"] for a in accs]
        torch._foreach_mul_(m1s, b1)
        torch._foreach_add_(m1s, gs, alpha=1.0 - b1)
        torch._foreach_mul_(m2s, b2)
        torch._foreach_addcmul_(m2s, gs, gs, value=1.0 - b2)
        if self._amsgrad:
            mx = [a["moment2_max"] for a in accs]
            torch._foreach_maximum_(mx, m2s)
            m2s = mx
        # sqrt(m2 / bc2) + eps, and the step lr / bc1
        denom = torch._foreach_sqrt(m2s)
        torch._foreach_div_(denom, math.sqrt(1.0 - b2 ** t))
        torch._foreach_add_(denom, self._epsilon)
        torch._foreach_addcdiv_(ps, m1s, denom,
                                value=-lr_val / (1.0 - b1 ** t))


class AdamW(Adam):
    """Adam with decoupled weight decay (reference :370-385): the (master)
    weight is multiplied by `1 - lr * weight_decay` before the Adam rule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name)
        self._wd_coeff = float(weight_decay) if isinstance(
            weight_decay, (int, float)) else weight_decay.coeff
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_decay(self):
        return self._wd_coeff


AdamWDL = AdamW  # the incubate alias


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        return {"moment": _zeros32(p), "inf_norm": _zeros32(p)}

    def _rule(self, ps, gs, accs, lr_val, t):
        ms = [a["moment"] for a in accs]
        us = [a["inf_norm"] for a in accs]
        torch._foreach_mul_(ms, self._beta1)
        torch._foreach_add_(ms, gs, alpha=1.0 - self._beta1)
        torch._foreach_mul_(us, self._beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        denom = torch._foreach_add(us, self._epsilon)
        torch._foreach_addcdiv_(ps, ms, denom,
                                value=-lr_val / (1.0 - self._beta1 ** t))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, p):
        acc = {"mean_square": _zeros32(p), "momentum": _zeros32(p)}
        if self._centered:
            acc["mean_grad"] = _zeros32(p)
        return acc

    def _rule(self, ps, gs, accs, lr_val, t):
        rho = self._rho
        ms = [a["mean_square"] for a in accs]
        torch._foreach_mul_(ms, rho)
        torch._foreach_addcmul_(ms, gs, gs, value=1.0 - rho)
        if self._centered:
            mg = [a["mean_grad"] for a in accs]
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, gs, alpha=1.0 - rho)
            inner = torch._foreach_addcmul(ms, mg, mg, value=-1.0)
        else:
            inner = [m.clone() for m in ms]
        torch._foreach_add_(inner, self._epsilon)
        denom = torch._foreach_sqrt(inner)
        moms = [a["momentum"] for a in accs]
        torch._foreach_mul_(moms, self._momentum)
        torch._foreach_add_(moms, torch._foreach_div(
            torch._foreach_mul(gs, lr_val), denom))
        torch._foreach_sub_(ps, moms)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, p):
        return {"avg_squared_grad": _zeros32(p),
                "avg_squared_update": _zeros32(p)}

    def _rule(self, ps, gs, accs, lr_val, t):
        rho, eps = self._rho, self._epsilon
        asg = [a["avg_squared_grad"] for a in accs]
        asu = [a["avg_squared_update"] for a in accs]
        torch._foreach_mul_(asg, rho)
        torch._foreach_addcmul_(asg, gs, gs, value=1.0 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(asu, eps))
        den = torch._foreach_sqrt(torch._foreach_add(asg, eps))
        upd = torch._foreach_div(torch._foreach_mul(gs, num), den)
        torch._foreach_mul_(asu, rho)
        torch._foreach_addcmul_(asu, upd, upd, value=1.0 - rho)
        torch._foreach_add_(ps, upd, alpha=-lr_val)


class Lamb(Optimizer):
    """Adam's direction plus decay, scaled by the layer-wise trust ratio
    |p| / |r| (a whole-tensor norm: ZeRO refuses this rule)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay

    def _create_accumulators(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p)}

    def _rule(self, ps, gs, accs, lr_val, t):
        b1, b2 = self._beta1, self._beta2
        for p, g, a in zip(ps, gs, accs):
            m1, m2 = a["moment1"], a["moment2"]
            m1.mul_(b1).add_(g, alpha=1.0 - b1)
            m2.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            r = (m1 / (1.0 - b1 ** t)) / (
                torch.sqrt(m2 / (1.0 - b2 ** t)) + self._epsilon)
            r = r + self._lamb_wd * p
            w_norm, r_norm = torch.linalg.vector_norm(p), \
                torch.linalg.vector_norm(r)
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, torch.ones_like(w_norm))
            p.sub_(lr_val * trust * r)


class Rprop(Optimizer):
    """Resilient backprop: per-element step sizes grown or shrunk by the
    agreement of the gradient's sign with the last one."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         multi_precision, name)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _create_accumulators(self, p):
        return {"prev_grad": _zeros32(p),
                "step_size": torch.full_like(p, float(self.get_lr()),
                                             dtype=torch.float32)}

    def _rule(self, ps, gs, accs, lr_val, t):
        for p, g, a in zip(ps, gs, accs):
            sign = torch.sign(g * a["prev_grad"])
            factor = torch.where(sign > 0, self._eta_pos,
                                 torch.where(sign < 0, self._eta_neg, 1.0))
            step = torch.clamp(a["step_size"] * factor, self._lr_min,
                               self._lr_max)
            # on a sign flip the step is retracted (the gradient counts 0)
            g_eff = torch.where(sign < 0, 0.0, g)
            p.sub_(torch.sign(g_eff) * step)
            a["prev_grad"].copy_(g_eff)
            a["step_size"].copy_(step)


class ASGD(Optimizer):
    """Averaged SGD: the step follows the mean of the last `batch_num`
    gradients (a (batch_num, *shape) ring of them in slot `ys`)."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._batch_num = batch_num

    def _create_accumulators(self, p):
        return {"d": _zeros32(p),
                "ys": torch.zeros((self._batch_num,) + tuple(p.shape),
                                  dtype=torch.float32, device=p.device)}

    def _rule(self, ps, gs, accs, lr_val, t):
        idx = (t - 1) % self._batch_num
        m = float(min(t, self._batch_num))
        for p, g, a in zip(ps, gs, accs):
            a["d"].add_(g - a["ys"][idx])
            a["ys"][idx].copy_(g)
            p.sub_(lr_val / m * a["d"])


class NAdam(Optimizer):
    """Nesterov-accelerated Adam (Dozat 2016); the product of the momentum
    schedule rides as a scalar slot."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, momentum_decay=0.004, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._momentum_decay = momentum_decay

    def _create_accumulators(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p),
                "mu_product": torch.ones((), dtype=torch.float32,
                                         device=p.device)}

    def _rule(self, ps, gs, accs, lr_val, t):
        b1, b2, psi = self._beta1, self._beta2, 0.96
        mu_t = b1 * (1.0 - 0.5 * psi ** (t * self._momentum_decay))
        mu_next = b1 * (1.0 - 0.5 * psi ** ((t + 1) * self._momentum_decay))
        bc2 = 1.0 - b2 ** t
        for p, g, a in zip(ps, gs, accs):
            a["mu_product"].mul_(mu_t)
            mu_prod = a["mu_product"]
            m, v = a["moment1"], a["moment2"]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            m_hat = (mu_next * m / (1.0 - mu_prod * mu_next)
                     + (1.0 - mu_t) * g / (1.0 - mu_prod))
            p.sub_(lr_val * m_hat / (torch.sqrt(v / bc2) + self._epsilon))


class RAdam(Optimizer):
    """Rectified Adam (Liu et al. 2020): plain momentum while the second
    moment's estimate is too short (rho_t <= 4), rectified Adam after."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         False, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, p):
        return {"moment1": _zeros32(p), "moment2": _zeros32(p)}

    def _rule(self, ps, gs, accs, lr_val, t):
        b1, b2 = self._beta1, self._beta2
        ms = [a["moment1"] for a in accs]
        vs = [a["moment2"] for a in accs]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1.0 - b2)
        bc1 = 1.0 - b1 ** t
        rho_inf = 2.0 / (1.0 - b2) - 1.0
        beta2_t = b2 ** t
        rho_t = rho_inf - 2.0 * t * beta2_t / (1.0 - beta2_t)
        if rho_t > 4.0:
            r_t = math.sqrt(max((rho_t - 4.0) * (rho_t - 2.0) * rho_inf, 0.0)
                            / ((rho_inf - 4.0) * (rho_inf - 2.0)
                               * max(rho_t, 5.0)))
            denom = torch._foreach_sqrt(
                torch._foreach_div(vs, 1.0 - beta2_t))
            torch._foreach_add_(denom, self._epsilon)
            torch._foreach_addcdiv_(ps, ms, denom,
                                    value=-lr_val * r_t / bc1)
        else:
            torch._foreach_add_(ps, ms, alpha=-lr_val / bc1)
