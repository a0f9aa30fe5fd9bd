"""Elementwise math, special functions, comparison, logical and bitwise
ops, activations and the two elementwise losses of the op table
(counterparts of paddle_tpu/ops/math.py, comparison.py and the inline
math entries of ops.yaml). Each body is torch code over torch tensors;
the name, `amp` list and Tensor-method binding are the reference's.

Python scalars meet tensors as PyTorch's 0-d "wrapped numbers", which
keep the tensor's type as jax's weak types do (`bf16 * 2.0` stays bf16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from .registry import register_op as op


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """`v` as a tensor on `like`'s device (a Python scalar becomes a 0-d
    tensor, which torch's promotion treats as a weak operand)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, device=like.device)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _t(x, y)
    elif not isinstance(y, torch.Tensor):
        y = _t(y, x)
    return x, y


def _float(x: torch.Tensor) -> torch.Tensor:
    """Integers and bools as the default float type (jnp's promotion for
    the transcendental functions)."""
    if x.is_floating_point() or x.is_complex():
        return x
    from ..core.dtype import get_default_dtype

    return x.to(get_default_dtype())


# ------------------------------------------------------ reference math.py
@op("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


@op("logit")
def logit(x, eps=None):
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


# ---------------------------------------------------- ops.yaml: math
@op("exp2", amp="black", method="exp2")
def exp2(x):
    return torch.exp2(_float(x))


@op("logaddexp2", method="logaddexp2")
def logaddexp2(x, y):
    return torch.logaddexp2(*_pair(x, y))


@op("xlogy", method="xlogy")
def xlogy(x, y):
    return torch.xlogy(*_pair(x, y))


@op("gammainc", method="gammainc")
def gammainc(x, y):
    return torch.special.gammainc(*_pair(x, y))


@op("gammaincc", method="gammaincc")
def gammaincc(x, y):
    return torch.special.gammaincc(*_pair(x, y))


@op("multigammaln", method="multigammaln")
def multigammaln(x, p):
    return torch.special.multigammaln(x, int(p))


@op("sgn", method="sgn")
def sgn(x):
    return torch.sgn(x) if x.is_complex() else torch.sign(x)


@op("negative", method="negative")
def negative(x):
    return torch.neg(x)


@op("positive", method="positive")
def positive(x):
    return x.clone()


@op("signbit", method="signbit")
def signbit(x):
    return torch.signbit(x)


@op("isneginf", method="isneginf")
def isneginf(x):
    return torch.isneginf(x)


@op("isposinf", method="isposinf")
def isposinf(x):
    return torch.isposinf(x)


@op("nextafter", method="nextafter")
def nextafter(x, y):
    return torch.nextafter(*_pair(x, y))


@op("frexp", method="frexp", multi_output=True)
def frexp(x):
    return tuple(torch.frexp(x))


@op("gcd", method="gcd")
def gcd(x, y):
    return torch.gcd(*_pair(x, y))


@op("lcm", method="lcm")
def lcm(x, y):
    return torch.lcm(*_pair(x, y))


def _edge(v, x, axis):
    if v is None or isinstance(v, torch.Tensor) and v.dim() == x.dim():
        return v
    shape = list(x.shape)
    shape[axis] = 1
    return torch.broadcast_to(_t(v, x).to(x.dtype), shape)


@op("diff", method="diff")
def diff(x, n=1, axis=-1, prepend=None, append=None):
    return torch.diff(x, n=n, dim=axis, prepend=_edge(prepend, x, axis),
                      append=_edge(append, x, axis))


@op("trapezoid", method="trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1):
    if x is not None:
        return torch.trapezoid(y, x, dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@op("cumulative_trapezoid", method="cumulative_trapezoid")
def cumulative_trapezoid(y, x=None, dx=None, axis=-1):
    y = torch.movedim(y, axis, -1)
    if x is not None:
        x = _t(x, y)
        d = torch.diff(torch.movedim(x, axis, -1) if x.dim() == y.dim()
                       else x, dim=-1)
    else:
        d = 1.0 if dx is None else dx
    avg = (y[..., 1:] + y[..., :-1]) / 2.0
    return torch.movedim(torch.cumsum(d * avg, dim=-1), -1, axis)


@op("polar", method="polar")
def polar(abs, angle):
    return abs * torch.exp(1j * angle.to(torch.complex64))


@op("vecdot", method="vecdot")
def vecdot(x, y, axis=-1):
    return torch.sum(x * y, dim=axis)


@op("reduce_as", method="reduce_as")
def reduce_as(x, target):
    extra = x.dim() - target.dim()
    axes = tuple(range(extra)) + tuple(
        extra + i for i, d in enumerate(target.shape)
        if d == 1 and x.shape[extra + i] != 1)
    out = torch.sum(x, dim=axes) if axes else x
    return out.reshape(target.shape)


@op("igamma", amp="black", method="igamma")
def igamma(x, a):
    # paddle's igamma(x, a) = GAMMA(x, a) / GAMMA(x): the regularized upper
    # incomplete gamma with the first argument as the shape parameter
    return torch.special.gammaincc(*_pair(x, a))


@op("igammac", amp="black", method="igammac")
def igammac(x, a):
    return torch.special.gammainc(*_pair(x, a))


@op("i0e", amp="black", method="i0e")
def i0e(x):
    return torch.special.i0e(_float(x))


@op("i1", amp="black", method="i1")
def i1(x):
    return torch.special.i1(_float(x))


@op("i1e", amp="black", method="i1e")
def i1e(x):
    return torch.special.i1e(_float(x))


@op("isin", amp="black", method="isin")
def isin(x, test_x, assume_unique=False, invert=False):
    return torch.isin(x, _t(test_x, x), invert=invert)


@op("is_empty")
def is_empty(x):
    return torch.tensor(x.numel() == 0, device=x.device)


@op("log_sigmoid", amp="black")
def log_sigmoid(x):
    return _F.logsigmoid(x)


@op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0):
    return torch.where(x > threshold, x, _t(value, x).to(x.dtype))


@op("shard_index", method="shard_index")
def shard_index(x, index_num, nshards, shard_id, ignore_value=-1):
    size = (index_num + nshards - 1) // nshards
    shard = torch.div(x, size, rounding_mode="floor")
    return torch.where(shard == shard_id, x % size,
                       _t(ignore_value, x).to(x.dtype))


# ----------------------------------------------- binary arithmetic
@op("add")
def add(x, y):
    return x + y


@op("subtract")
def subtract(x, y):
    return x - y


@op("multiply")
def multiply(x, y):
    return x * y


@op("divide")
def divide(x, y):
    return x / y


@op("floor_divide")
def floor_divide(x, y):
    return torch.div(*_pair(x, y), rounding_mode="floor")


@op("mod")
def mod(x, y):
    return x % y


@op("remainder")
def remainder(x, y):
    return x % y


@op("elementwise_pow")
def elementwise_pow(x, y):
    return x ** y


@op("maximum")
def maximum(x, y):
    return torch.maximum(*_pair(x, y))


@op("minimum")
def minimum(x, y):
    return torch.minimum(*_pair(x, y))


@op("fmax")
def fmax(x, y):
    return torch.fmax(*_pair(x, y))


@op("fmin")
def fmin(x, y):
    return torch.fmin(*_pair(x, y))


@op("atan2")
def atan2(x, y):
    x, y = _pair(x, y)
    return torch.atan2(_float(x), _float(y))


# ------------------------------------------------------------ unary
def _unary(name, fn, amp=None, floats=False):
    def body(x):
        return fn(_float(x) if floats else x)

    body.__name__ = name
    op(name, amp=amp)(body)
    return body


neg = _unary("neg", torch.neg)
abs = _unary("abs", torch.abs)
sqrt = _unary("sqrt", torch.sqrt, "black", True)
rsqrt = _unary("rsqrt", torch.rsqrt, "black", True)
exp = _unary("exp", torch.exp, "black", True)
expm1 = _unary("expm1", torch.expm1, floats=True)
log = _unary("log", torch.log, "black", True)
log2 = _unary("log2", torch.log2, floats=True)
log10 = _unary("log10", torch.log10, floats=True)
log1p = _unary("log1p", torch.log1p, floats=True)
sin = _unary("sin", torch.sin, floats=True)
cos = _unary("cos", torch.cos, floats=True)
tan = _unary("tan", torch.tan, floats=True)
asin = _unary("asin", torch.asin, floats=True)
acos = _unary("acos", torch.acos, floats=True)
atan = _unary("atan", torch.atan, floats=True)
sinh = _unary("sinh", torch.sinh, floats=True)
cosh = _unary("cosh", torch.cosh, floats=True)
asinh = _unary("asinh", torch.asinh, floats=True)
acosh = _unary("acosh", torch.acosh, floats=True)
atanh = _unary("atanh", torch.atanh, floats=True)
tanh = _unary("tanh", torch.tanh, floats=True)
sigmoid = _unary("sigmoid", torch.sigmoid, floats=True)
erf = _unary("erf", torch.erf, floats=True)
erfinv = _unary("erfinv", torch.erfinv, floats=True)
floor = _unary("floor", torch.floor)
ceil = _unary("ceil", torch.ceil)
round = _unary("round", torch.round)
trunc = _unary("trunc", torch.trunc)
sign = _unary("sign", torch.sign)
reciprocal = _unary("reciprocal", torch.reciprocal)
square = _unary("square", torch.square)
angle = _unary("angle", torch.angle)
digamma = _unary("digamma", torch.digamma, floats=True)
lgamma = _unary("lgamma", torch.lgamma, floats=True)
gammaln = _unary("gammaln", torch.lgamma, floats=True)
i0 = _unary("i0", torch.i0, floats=True)
sinc = _unary("sinc", torch.sinc, floats=True)
deg2rad = _unary("deg2rad", torch.deg2rad, floats=True)
rad2deg = _unary("rad2deg", torch.rad2deg, floats=True)
clone = _unary("clone", torch.clone)


@op("frac")
def frac(x):
    return x - torch.trunc(x)


@op("clip")
def clip(x, min=None, max=None):
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


@op("lerp")
def lerp(x, y, weight):
    return x + weight * (y - x)


@op("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


@op("conj")
def conj(x):
    return torch.conj(x).resolve_conj() if x.is_complex() else x.clone()


@op("real")
def real(x):
    return torch.real(x).clone() if x.is_complex() else x.clone()


@op("imag")
def imag(x):
    return torch.imag(x).clone() if x.is_complex() else torch.zeros_like(x)


@op("multiply_scalar")
def multiply_scalar(x, value):
    return x * value


@op("pow_scalar")
def pow_scalar(x, value):
    return x ** value


@op("rpow_scalar")
def rpow_scalar(x, value):
    return value ** x


@op("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    return scale_b * torch.tanh(scale_a * x)


@op("logaddexp")
def logaddexp(x, y):
    return torch.logaddexp(*_pair(x, y))


@op("heaviside")
def heaviside(x, y):
    x, y = _pair(x, y)
    return torch.where(x > 0, torch.ones_like(x), torch.where(
        x < 0, torch.zeros_like(x), y.to(x.dtype)))


@op("copysign")
def copysign(x, y):
    return torch.copysign(*_pair(x, y))


@op("hypot")
def hypot(x, y):
    return torch.hypot(*_pair(x, y))


@op("ldexp")
def ldexp(x, y):
    return torch.ldexp(*_pair(x, y))


@op("polygamma")
def polygamma(x, n=0):
    return torch.polygamma(int(n), x)


# --------------------------------------- comparison / logical / bitwise
def _binary(name, fn, method=None):
    def body(x, y):
        return fn(*_pair(x, y))

    body.__name__ = name
    op(name, method=method)(body)
    return body


equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)


@op("equal_all")
def equal_all(x, y):
    x, y = _pair(x, y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


@op("isclose")
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_pair(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


@op("allclose")
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False):
    return torch.isclose(*_pair(x, y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@op("isnan")
def isnan(x):
    return torch.isnan(x)


@op("isinf")
def isinf(x):
    return torch.isinf(x)


@op("isfinite")
def isfinite(x):
    return torch.isfinite(x)


@op("logical_not")
def logical_not(x):
    return torch.logical_not(x)


@op("bitwise_not")
def bitwise_not(x):
    return torch.bitwise_not(x)


# ------------------------------------------------------ activations
@op("relu")
def relu(x):
    return torch.relu(x)


@op("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@op("gelu")
def gelu(x, approximate=False):
    return _F.gelu(x, approximate="tanh" if approximate else "none")


@op("silu")
def silu(x):
    return _F.silu(x)


@op("swish")
def swish(x):
    return _F.silu(x)


@op("leaky_relu")
def leaky_relu(x, negative_slope=0.01):
    return _F.leaky_relu(x, negative_slope)


@op("elu")
def elu(x, alpha=1.0):
    return _F.elu(x, alpha)


@op("selu")
def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op("celu")
def celu(x, alpha=1.0):
    return _F.celu(x, alpha)


@op("hardswish")
def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


@op("hardsigmoid")
def hardsigmoid(x, slope=1.0 / 6.0, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0):
    return torch.clamp(x, min, max)


@op("hardshrink")
def hardshrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@op("softshrink")
def softshrink(x, threshold=0.5):
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold,
                                   torch.zeros_like(x)))


@op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@op("mish")
def mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


@op("softsign")
def softsign(x):
    return x / (1.0 + torch.abs(x))


@op("softmax", amp="black")
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@op("log_softmax", amp="black")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


@op("glu")
def glu(x, axis=-1):
    return _F.glu(x, dim=axis)


@op("square_error_cost")
def square_error_cost(input, label):
    return torch.square(input - label)


@op("log_loss")
def log_loss(input, label, epsilon=0.0001):
    return (-label * torch.log(input + epsilon)
            - (1.0 - label) * torch.log(1.0 - input + epsilon))


@op("rotary_position_embedding", multi_output=True)
def rotary_position_embedding(q, k, theta=10000.0, position_offset=0):
    """NeoX rotate-half RoPE over (b, s, heads, head_dim): fp32 angles,
    each output cast back to its input's type."""
    b, s, h, d = q.shape
    if d % 2 != 0:
        raise ValueError(f"RoPE requires an even head_dim, got {d}")
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=q.device) * 2.0 / d))
    off = _t(position_offset, q).to(torch.float32)
    if off.dim() == 0:
        pos = torch.arange(s, dtype=torch.float32, device=q.device) + off
        ang = pos[:, None] * freqs[None, :]
        cos, sin = torch.cos(ang)[None, :, None, :], \
            torch.sin(ang)[None, :, None, :]
    else:
        pos = off if off.dim() == 2 else (
            torch.arange(s, dtype=torch.float32, device=q.device)[None, :]
            + off[:, None])
        ang = pos[..., None] * freqs[None, None, :]
        cos, sin = torch.cos(ang)[:, :, None, :], \
            torch.sin(ang)[:, :, None, :]

    def rot(x):
        xc = x.float()
        x1, x2 = xc[..., :half], xc[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


@op("renorm", method="renorm")
def renorm(x, p, axis, max_norm):
    moved = torch.movedim(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    norms = torch.sum(torch.abs(flat) ** p, dim=1) ** (1.0 / p)
    factor = torch.where(norms > max_norm,
                         max_norm / torch.clamp(norms, min=1e-12),
                         torch.ones_like(norms))
    out = flat * factor[:, None]
    return torch.movedim(out.reshape(moved.shape), 0, axis)

