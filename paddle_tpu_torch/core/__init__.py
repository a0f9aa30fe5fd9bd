"""The Paddle dygraph core of the port (counterpart of paddle_tpu/core/):
dtypes, places, flags, the error layer, random state, the Tensor and
Parameter over torch tensors, the op dispatch and autograd over torch
autograd, and the few top-level helpers the reference defines beside
them (paddle_tpu/__init__.py:63-118)."""
from .dtype import (bfloat16, bool_, complex64, complex128, convert_dtype,
                    finfo, float16, float32, float64, get_default_dtype,
                    iinfo, int8, int16, int32, int64, set_default_dtype,
                    uint8)
from .enforce import EnforceNotMet, enforce
from .flags import get_flags, set_flags
from .place import CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, device_count
from .rng import Generator, get_rng_state, seed, set_rng_state
from .tape import (enable_grad, grad, is_grad_enabled, no_grad,
                   set_grad_enabled)
from .tensor import Parameter, Tensor

__all__ = ["bfloat16", "bool_", "complex64", "complex128", "convert_dtype",
           "finfo", "float16", "float32", "float64", "get_default_dtype",
           "iinfo", "int8", "int16", "int32", "int64", "set_default_dtype",
           "uint8", "EnforceNotMet", "enforce", "get_flags", "set_flags",
           "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "Place",
           "device_count", "Generator", "get_rng_state", "seed",
           "set_rng_state", "enable_grad", "grad", "is_grad_enabled",
           "no_grad", "set_grad_enabled", "Parameter", "Tensor",
           "create_parameter", "get_cuda_rng_state", "set_cuda_rng_state",
           "LazyGuard", "disable_signal_handler"]


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """paddle.create_parameter: a free-standing trainable Parameter on the
    default device (Layer.create_parameter's implementation)."""
    from ..nn.layer.layers import make_parameter

    return make_parameter(shape, attr=attr, dtype=dtype, is_bias=is_bias,
                          default_initializer=default_initializer,
                          name=name)


def get_cuda_rng_state():
    """The default generator's state on every device (one generator
    family, as in the reference)."""
    return get_rng_state()


def set_cuda_rng_state(state):
    return set_rng_state(state)


class LazyGuard:
    """paddle.LazyGuard: parameters are created eagerly here; the guard is
    a no-op context kept for the API, as in the reference."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def disable_signal_handler():
    """No-op: the port installs no signal handlers."""
