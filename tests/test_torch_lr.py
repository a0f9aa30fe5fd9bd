"""The port's learning-rate schedulers (paddle_tpu_torch.optimizer.lr)
against the JAX package's (paddle_tpu/optimizer/lr.py): each scheduler's
`last_lr` over 30 steps, exactly equal (both are host arithmetic in
Python floats), and the state-dict round trip."""
import pytest

import paddle_tpu.optimizer.lr as jlr
from paddle_tpu_torch.optimizer import lr as plr

STEPS = 30

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=0.5),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=10,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=8,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup into cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20, eta_min=0.001),
        warmup_steps=5, start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [4, 9, 17], 0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=6, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.9),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=12, eta_min=0.002),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=4, T_mult=2, eta_min=0.001),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "OneCycleLR linear": lambda m: m.OneCycleLR(
        0.1, total_steps=25, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6),
    "CyclicLR triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode="triangular2"),
    "CyclicLR exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode="exp_range", exp_gamma=0.95),
}


def _sequence(sched):
    out = []
    for _ in range(STEPS):
        out.append(sched.last_lr)
        sched.step()
    return out


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_sequence_equals_reference(name):
    make = SCHEDULERS[name]
    assert _sequence(make(plr)) == _sequence(make(jlr))


def test_reduce_on_plateau_equals_reference():
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84,
               0.85] * 3

    def run(m):
        s = m.ReduceOnPlateau(0.1, patience=2, factor=0.5, cooldown=1)
        out = []
        for v in metrics:
            s.step(v)
            out.append(s.last_lr)
        return out

    assert run(plr) == run(jlr)


def test_state_dict_round_trip():
    a = SCHEDULERS["CosineAnnealingDecay"](plr)
    for _ in range(7):
        a.step()
    b = SCHEDULERS["CosineAnnealingDecay"](plr)
    b.set_state_dict(a.state_dict())
    assert _sequence(a) == _sequence(b)


def test_every_scheduler_of_the_reference_is_ported():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert names == set(plr.__all__)
