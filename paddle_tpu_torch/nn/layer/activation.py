"""Activation layers over the op table's activations (counterparts of
paddle_tpu/nn/layer/activation.py); Softplus, PReLU, RReLU and Maxout
over the nn ops (`ops.nn_ops`)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU", "ReLU6", "GELU", "SiLU", "Silu", "Swish", "LeakyReLU",
           "ELU", "SELU", "CELU", "Sigmoid", "LogSigmoid", "Tanh",
           "Tanhshrink", "Hardswish", "Hardsigmoid", "Hardtanh",
           "Hardshrink", "Softshrink", "Mish", "Softsign", "Softmax",
           "LogSoftmax", "GLU", "Softmax2D", "ThresholdedReLU", "Softplus",
           "PReLU", "RReLU", "Maxout"]


def _simple(name, fn):
    def forward(self, x):
        return fn(x)

    return type(name, (Layer,), {"forward": forward,
                                 "__doc__": f"paddle.nn.{name}"})


ReLU = _simple("ReLU", F.relu)
ReLU6 = _simple("ReLU6", F.relu6)
SiLU = _simple("SiLU", F.silu)
Silu = SiLU
Swish = _simple("Swish", F.swish)
SELU = _simple("SELU", F.selu)
Sigmoid = _simple("Sigmoid", F.sigmoid)
LogSigmoid = _simple("LogSigmoid", F.log_sigmoid)
Tanh = _simple("Tanh", F.tanh)
Tanhshrink = _simple("Tanhshrink", F.tanhshrink)
Hardswish = _simple("Hardswish", F.hardswish)
Hardsigmoid = _simple("Hardsigmoid", F.hardsigmoid)
Mish = _simple("Mish", F.mish)
Softsign = _simple("Softsign", F.softsign)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)


class Softmax2D(Layer):
    """Softmax over the channel axis of (N, C, H, W) or (C, H, W)."""

    def forward(self, x):
        if x.ndim not in (3, 4):
            raise ValueError("Softmax2D expects (N, C, H, W) or (C, H, W)")
        return F.softmax(x, axis=-3)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        from .. import initializer as I

        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight)


class RReLU(Layer):
    """The mean slope (lower + upper) / 2 on negatives, in training too,
    as the reference's op."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)
