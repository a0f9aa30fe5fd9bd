"""Random state under paddle's names (counterpart of the `Generator`
surface of paddle_tpu/core/rng.py:34-128).

The reference keeps one threefry key and splits it at every draw. The
port keeps one `torch.Generator` per device, all seeded from the same
seed: `paddle.seed(s)` reseeds every one of them, and every random op of
the Paddle surface (creation, `uniform_` / `normal_`, the initializers,
`nn.Dropout`, attention dropout) draws from the generator of the device
it writes to, never from PyTorch's global generators. The streams are
PyTorch's, so the port's draws do not match the reference's bit for bit;
the same seed gives the same draws run to run on one device.
(`RNGStatesTracker`, fleet's named streams, is in
distributed/fleet/meta_parallel/parallel_layers.py.)
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "generator_for"]


class Generator:
    """A seed and one torch.Generator per device, created at first use."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._gens: Dict[str, torch.Generator] = {}

    def manual_seed(self, seed: int):
        self._seed = int(seed)
        for g in self._gens.values():
            g.manual_seed(self._seed)
        return self

    def initial_seed(self) -> int:
        return self._seed

    def generator(self, device) -> torch.Generator:
        """The torch.Generator that draws on `device`."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        g = self._gens.get(key)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(self._seed)
            self._gens[key] = g
        return g

    def get_state(self):
        """{device: state} of every generator made so far."""
        return {k: g.get_state() for k, g in self._gens.items()}

    def set_state(self, state):
        for key, st in state.items():
            self.generator(key).set_state(st)


_DEFAULT_GENERATOR = Generator(0)


def default_generator() -> Generator:
    return _DEFAULT_GENERATOR


def generator_for(device) -> torch.Generator:
    """The default generator's torch.Generator on `device`."""
    return _DEFAULT_GENERATOR.generator(device)


def seed(s: int) -> Generator:
    """paddle.seed"""
    return _DEFAULT_GENERATOR.manual_seed(s)


def get_rng_state():
    return _DEFAULT_GENERATOR.get_state()


def set_rng_state(state):
    _DEFAULT_GENERATOR.set_state(state)
