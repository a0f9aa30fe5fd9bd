"""Random tensor creation under paddle's names (counterpart of
paddle_tpu/tensor/random.py). Every draw comes from the default
generator's torch.Generator on the device it writes to (`core.rng`)."""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype, get_default_dtype
from ..core.place import torch_device
from ..core.rng import generator_for
from ..core.tensor import Tensor, to_torch

__all__ = ["rand", "randn", "normal", "uniform", "randint", "randint_like",
           "randperm", "bernoulli", "poisson", "multinomial",
           "standard_normal", "rand_like", "randn_like", "standard_gamma"]


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _draw(fn, *args, dtype=None, device=None, **kw):
    dev = torch_device(device)
    return Tensor._wrap(fn(*args, generator=generator_for(dev), device=dev,
                           dtype=dtype, **kw))


def rand(shape, dtype=None, name=None):
    return _draw(torch.rand, _shape(shape),
                 dtype=convert_dtype(dtype) or get_default_dtype())


def randn(shape, dtype=None, name=None):
    return _draw(torch.randn, _shape(shape),
                 dtype=convert_dtype(dtype) or get_default_dtype())


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype=dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._t if isinstance(mean, Tensor) else mean
        s = std._t if isinstance(std, Tensor) else std
        ref = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(
            tuple(getattr(m, "shape", ())), tuple(getattr(s, "shape", ()))) \
            if shape is None else _shape(shape)
        z = torch.randn(shp, generator=generator_for(ref.device),
                        device=ref.device, dtype=get_default_dtype())
        return Tensor._wrap(m + s * z)
    z = randn(_shape(shape) if shape is not None else ())
    return Tensor._wrap(mean + std * z._t)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    d = convert_dtype(dtype) or get_default_dtype()
    dev = torch_device(None)
    gen = torch.Generator(device=dev).manual_seed(seed) if seed \
        else generator_for(dev)
    out = torch.empty(_shape(shape), dtype=d, device=dev)
    return Tensor._wrap(out.uniform_(min, max, generator=gen))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return _draw(torch.randint, low, high, _shape(shape),
                 dtype=convert_dtype(dtype))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return _draw(torch.randint, low, high, tuple(x.shape),
                 dtype=convert_dtype(dtype) or x.dtype, device=x._t.device)


def randperm(n, dtype="int64", name=None):
    return _draw(torch.randperm, n, dtype=convert_dtype(dtype))


def rand_like(x, dtype=None):
    return _draw(torch.rand, tuple(x.shape),
                 dtype=convert_dtype(dtype) or x.dtype, device=x._t.device)


def randn_like(x, dtype=None):
    return _draw(torch.randn, tuple(x.shape),
                 dtype=convert_dtype(dtype) or x.dtype, device=x._t.device)


def bernoulli(x, name=None):
    p = to_torch(x)
    p = p if p.is_floating_point() else p.float()
    return Tensor._wrap(torch.bernoulli(p, generator=generator_for(
        p.device)))


def poisson(x, name=None):
    lam = to_torch(x)
    return Tensor._wrap(torch.poisson(lam, generator=generator_for(
        lam.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    p = to_torch(x)
    return Tensor._wrap(torch.multinomial(
        p, num_samples, replacement, generator=generator_for(p.device)))


def standard_gamma(x, name=None):
    """Gamma(alpha=x, 1.0) draws: torch's `_standard_gamma` takes no
    generator, so the draw runs on a copy of the default stream's state
    (forked and advanced by one draw)."""
    alpha = to_torch(x)
    gen = generator_for(alpha.device)
    with torch.random.fork_rng(devices=[alpha.device] if
                               alpha.device.type == "cuda" else []):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=alpha.device))
        torch.manual_seed(seed)
        out = torch._standard_gamma(alpha)
    return Tensor._wrap(out)
