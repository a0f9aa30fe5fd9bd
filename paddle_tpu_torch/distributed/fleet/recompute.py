"""Activation recompute under paddle's names (counterpart of
paddle_tpu/distributed/fleet/recompute.py): `recompute(function, *args)`
runs `function` without keeping its activations and runs it again in the
backward to get them back, through `torch.utils.checkpoint`
(non-reentrant, whatever `use_reentrant` says: the reentrant form loses
gradients of inputs that do not require grad and of keyword inputs).

Randomness is explicit in the port: dropout masks, K1's in-kernel dropout
seed among them, are drawn from the `torch.Generator` a forward is given.
`torch.utils.checkpoint(preserve_rng_state=True)` saves and restores only
the global CPU and CUDA generators, so a replay would draw other masks
and give wrong gradients without any error. `recompute` therefore finds
every `torch.Generator` among the arguments, takes its state before the
forward, sets that state back for the replay and, after the replay, puts
back the state the generator had reached, so that the draws of later
layers do not move. The same holds for the port's amp policy
(`amp.auto_cast`, a module state, not torch.autocast's): the replay runs
in the backward, outside the forward's `auto_cast` block, so `recompute`
takes the policy in force at the forward and sets it for the replay.
Recompute on gives the same loss and gradients as recompute off, bit for
bit, wherever the step's library ops are run-to-run deterministic (on
CUDA with `torch.use_deterministic_algorithms(True)`: the default
embedding backward is not).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ... import amp

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in the
    backward (see the module docstring)."""
    gens = [a for a in list(args) + list(kwargs.values())
            if isinstance(a, torch.Generator)]
    at_forward = [g.get_state() for g in gens]
    policy = dict(amp._STATE)
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kw)
        reached = [g.get_state() for g in gens]
        outside = dict(amp._STATE)
        for g, s in zip(gens, at_forward):
            g.set_state(s)
        amp._STATE.update(policy)
        try:
            return function(*a, **kw)
        finally:
            for g, s in zip(gens, reached):
                g.set_state(s)
            amp._STATE.update(outside)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Recompute a sequence of layers in `ctx["segments"]` chunks
    (paddle.incubate.distributed.fleet.recompute_sequential); each chunk
    takes the previous chunk's output as its one argument."""
    segments = (ctx or {}).get("segments", 1)
    layers = list(functions)
    if segments <= 1:
        seglists = [layers]
    else:
        size = max(1, len(layers) // segments)
        seglists = [layers[i:i + size] for i in range(0, len(layers), size)]

    def chain(seg):
        def run(x):
            for layer in seg:
                x = layer(x)
            return x
        return run

    out = args[0] if len(args) == 1 else args
    for seg in seglists:
        out = recompute(chain(seg), out, **kwargs)
    return out
