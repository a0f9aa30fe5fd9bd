"""Weight initializers under paddle's names (counterpart of
paddle_tpu/nn/initializer/__init__.py).

An initializer is called as `init(shape, dtype, device=None)` and returns
a torch tensor on `device` (default: the port's default device), drawn
from the default generator's stream on that device (`core.rng`); called
on a Tensor or Parameter it fills it in place. The fan rules, gains and
formulas are the reference's, so the draws agree in distribution with
the reference's, not bit for bit (the streams are PyTorch's).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.place import torch_device
from ...core.rng import generator_for

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal",
           "Uniform", "XavierNormal", "XavierUniform", "KaimingNormal",
           "KaimingUniform", "Assign", "Orthogonal", "Dirac",
           "set_global_initializer", "global_weight_init",
           "global_bias_init", "calculate_gain"]


class Initializer:
    def __call__(self, shape, dtype=None, device=None):
        from ...core.tensor import Tensor

        if isinstance(shape, Tensor):
            target = shape
            return target.set_value(self._draw(
                target.shape, target.dtype, target._t.device))
        return self._draw([int(s) for s in shape],
                          convert_dtype(dtype) or get_default_dtype(),
                          torch_device(device))

    def _draw(self, shape, dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def _compute_fans(self, shape):
        shape = tuple(shape)
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]      # paddle's (in, out)
        receptive = int(np.prod(shape[2:]))  # conv: (out, in, *kernel)
        return shape[1] * receptive, shape[0] * receptive


def _f32(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _draw(self, shape, dtype, device):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _draw(self, shape, dtype, device):
        z = _f32(shape, device).normal_(generator=generator_for(device))
        return (self.mean + self.std * z).to(dtype)


class TruncatedNormal(Initializer):
    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _draw(self, shape, dtype, device):
        raw = torch.nn.init.trunc_normal_(_f32(shape, device), 0.0, 1.0,
                                          self.a, self.b,
                                          generator=generator_for(device))
        return (self.mean + self.std * raw).to(dtype)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _draw(self, shape, dtype, device):
        return _f32(shape, device).uniform_(
            self.low, self.high, generator=generator_for(device)).to(dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device):
        fi, fo = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)._draw(shape, dtype, device)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _draw(self, shape, dtype, device):
        fi, fo = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._draw(shape, dtype, device)


def _kaiming_gain(nonlinearity, negative_slope):
    return math.sqrt(2.0 / (1 + negative_slope ** 2)) \
        if nonlinearity in ("relu", "leaky_relu") else 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, device):
        fi, _ = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        return Normal(0.0, std)._draw(shape, dtype, device)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _draw(self, shape, dtype, device):
        fi, _ = self._compute_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._draw(shape, dtype, device)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def _draw(self, shape, dtype, device):
        from ...core.tensor import to_torch

        return to_torch(self.value, dtype, device).reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def _draw(self, shape, dtype, device):
        shape = tuple(shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _f32((max(rows, cols), min(rows, cols)), device).normal_(
            generator=generator_for(device))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols].reshape(shape)).to(dtype)


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def _draw(self, shape, dtype, device):
        out = torch.zeros(tuple(shape), dtype=dtype, device=device)
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(shape[0], shape[1])):
            out[(i, i) + centers] = 1.0
        return out


_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


def global_weight_init():
    return _GLOBAL_INIT["weight"]


def global_bias_init():
    return _GLOBAL_INIT["bias"]


def calculate_gain(nonlinearity, param=None):
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4.0
    raise ValueError(f"unknown nonlinearity {nonlinearity}")
