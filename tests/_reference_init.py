"""Host-side weights for the JAX package's layers in the port's tests.

The JAX initializers draw each parameter with `jax.random` op by op, and
eager JAX compiles each op for each new shape: building the ~90 layers of
tests/test_torch_nn.py that way takes ~20 s of compiles. The tests carry
the weights across to the port (`weights.load_reference_layer`), so only
their shapes and scale matter. `numpy_init()` makes the reference's
initializers draw from a seeded numpy generator instead, with the same
distribution family and scale (Constant keeps its value); nothing the
tests compare runs through them.
"""
import contextlib

import jax.numpy as jnp
import numpy as np

from paddle_tpu.nn import initializer as I


def _std(init, shape, fan):
    fi, fo = init._compute_fans(shape)
    return {"xavier": (2.0 / (fi + fo)) ** 0.5, "kaiming": (2.0 / fi) ** 0.5,
            }[fan]


@contextlib.contextmanager
def numpy_init(seed=0):
    rng = np.random.RandomState(seed)

    def draw(fn):
        def call(self, shape, dtype):
            return jnp.asarray(np.asarray(fn(self, tuple(shape)), np.float32))
        return call

    table = {
        I.Constant: lambda s, sh: np.full(sh, s.value),
        I.Normal: lambda s, sh: s.mean + s.std * rng.standard_normal(sh),
        I.TruncatedNormal: lambda s, sh: s.mean + s.std * np.clip(
            rng.standard_normal(sh), s.a, s.b),
        I.Uniform: lambda s, sh: rng.uniform(s.low, s.high, sh),
        I.XavierNormal: lambda s, sh: rng.standard_normal(sh) * _std(
            s, sh, "xavier"),
        I.XavierUniform: lambda s, sh: rng.uniform(-1, 1, sh) * _std(
            s, sh, "xavier") * 3 ** 0.5,
        I.KaimingNormal: lambda s, sh: rng.standard_normal(sh) * _std(
            s, sh, "kaiming"),
        I.KaimingUniform: lambda s, sh: rng.uniform(-1, 1, sh) * _std(
            s, sh, "kaiming") * 3 ** 0.5,
    }
    saved = {cls: cls.__call__ for cls in table}
    try:
        for cls, fn in table.items():
            cls.__call__ = draw(fn)
        yield
    finally:
        for cls, fn in saved.items():
            cls.__call__ = fn
