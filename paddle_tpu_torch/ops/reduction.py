"""Reductions, scans and order statistics of the op table (counterparts of
paddle_tpu/ops/reduction.py and the inline reduction entries of
ops.yaml), as torch code over torch tensors.

jnp's median and nanmedian average the two middle values; torch's take
the lower one, so both go through `quantile(0.5)` here. jnp sums of
integers stay 32-bit (no x64); the port's sums of int64 stay int64.
"""
from __future__ import annotations

import torch

from .math import _float, _t
from .registry import register_op as op


def _dims(x, axis):
    """`axis` (None, an int, a list or tuple; [] is None) as a tuple."""
    if axis is None or (isinstance(axis, (list, tuple)) and not axis):
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(a % x.dim() for a in axis)
    return (axis % (x.dim() or 1),)


def _keep(out, x, dims, keepdim):
    if keepdim and x.dim():
        shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        return out.reshape(shape)
    return out


def _reduce(fn, x, axis, keepdim, **kw):
    if x.dim() == 0:
        return fn(x.reshape(1), dim=(0,), **kw).reshape(())
    dims = _dims(x, axis)
    return fn(x, dim=dims, keepdim=keepdim, **kw)


@op("sum")
def sum(x, axis=None, keepdim=False, dtype=None):
    from ..core.dtype import convert_dtype

    dt = convert_dtype(dtype)
    return _reduce(torch.sum, x, axis, keepdim, **(
        {"dtype": dt} if dt is not None else {}))


@op("mean")
def mean(x, axis=None, keepdim=False):
    return _reduce(torch.mean, _float(x), axis, keepdim)


@op("max")
def max(x, axis=None, keepdim=False):
    return _reduce(torch.amax, x, axis, keepdim)


@op("min")
def min(x, axis=None, keepdim=False):
    return _reduce(torch.amin, x, axis, keepdim)


@op("amax")
def amax(x, axis=None, keepdim=False):
    return _reduce(torch.amax, x, axis, keepdim)


@op("amin")
def amin(x, axis=None, keepdim=False):
    return _reduce(torch.amin, x, axis, keepdim)


@op("prod")
def prod(x, axis=None, keepdim=False, dtype=None):
    from ..core.dtype import convert_dtype

    dt = convert_dtype(dtype)
    out = x if dt is None else x.to(dt)
    dims = _dims(x, axis)
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d)
    return _keep(out, x, dims, keepdim)


@op("all")
def all(x, axis=None, keepdim=False):
    return _reduce(torch.all, x, axis, keepdim)


@op("any")
def any(x, axis=None, keepdim=False):
    return _reduce(torch.any, x, axis, keepdim)


@op("argmax")
def argmax(x, axis=None, keepdim=False, dtype="int64"):
    from ..core.dtype import convert_dtype

    out = torch.argmax(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))


@op("argmin")
def argmin(x, axis=None, keepdim=False, dtype="int64"):
    from ..core.dtype import convert_dtype

    out = torch.argmin(x, dim=axis, keepdim=keepdim and axis is not None)
    return out.to(convert_dtype(dtype))


@op("logsumexp", amp="black")
def logsumexp(x, axis=None, keepdim=False):
    return _reduce(torch.logsumexp, _float(x), axis, keepdim)


@op("std")
def std(x, axis=None, unbiased=True, keepdim=False):
    return _reduce(torch.std, _float(x), axis, keepdim,
                   correction=1 if unbiased else 0)


@op("var")
def var(x, axis=None, unbiased=True, keepdim=False):
    return _reduce(torch.var, _float(x), axis, keepdim,
                   correction=1 if unbiased else 0)


def _quantile(fn, x, q, axis, keepdim, interpolation="linear"):
    """torch's (nan)quantile over any set of axes: the reduced axes are
    moved last and flattened into one."""
    x = _float(x)
    qt = _t(q, x).to(x.dtype)
    if axis is None:
        out = fn(x.reshape(-1), qt, dim=0, interpolation=interpolation)
        if keepdim:
            out = out.reshape(tuple(qt.shape) + (1,) * x.dim())
        return out
    dims = _dims(x, axis)
    keep = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(keep + list(dims)).reshape(
        [x.shape[d] for d in keep] + [-1])
    out = fn(moved, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        out = out.reshape(tuple(qt.shape) + tuple(shape))
    return out


@op("median")
def median(x, axis=None, keepdim=False):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


@op("nanmedian", method="nanmedian")
def nanmedian(x, axis=None, keepdim=False):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


@op("quantile", method="quantile")
def quantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


@op("nanquantile", method="nanquantile")
def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear"):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


@op("nanmean")
def nanmean(x, axis=None, keepdim=False):
    return _reduce(torch.nanmean, _float(x), axis, keepdim)


@op("nansum")
def nansum(x, axis=None, keepdim=False):
    return _reduce(torch.nansum, x, axis, keepdim)


@op("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False):
    dims = _dims(x, axis)
    return _keep(torch.count_nonzero(x, dim=dims), x, dims, keepdim)


def _scan_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


@op("cumsum")
def cumsum(x, axis=None, dtype=None):
    from ..core.dtype import convert_dtype

    x, axis = _scan_axis(x, axis)
    return torch.cumsum(x, dim=axis, dtype=convert_dtype(dtype))


@op("cumprod")
def cumprod(x, dim=None, dtype=None):
    from ..core.dtype import convert_dtype

    x, dim = _scan_axis(x, dim)
    return torch.cumprod(x, dim=dim, dtype=convert_dtype(dtype))


def _running_index(x, vals, axis, last):
    """Index of the first (or last) position up to each one where x equals
    its running extreme `vals` (the reference's scan over (value,
    index) pairs)."""
    n = x.shape[axis]
    shape = [n if d == axis % x.dim() else 1 for d in range(x.dim())]
    idx = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    hit = x == vals
    if last:
        return torch.cummax(torch.where(hit, idx, -1), dim=axis).values
    # the first index at which the running extreme took its value
    new = torch.cat([torch.ones_like(hit.narrow(axis, 0, 1)),
                     vals.narrow(axis, 1, n - 1)
                     != vals.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cummax(torch.where(new, idx, 0), dim=axis).values


@op("cummax", multi_output=True)
def cummax(x, axis=None):
    x, axis = _scan_axis(x, axis)
    vals = torch.cummax(x, dim=axis).values
    return vals, _running_index(x, vals, axis, last=True)


@op("cummin", method="cummin", multi_output=True)
def cummin(x, axis=None):
    x, axis = _scan_axis(x, axis)
    vals = torch.cummin(x, dim=axis).values
    return vals, _running_index(x, vals, axis, last=False)


@op("logcumsumexp")
def logcumsumexp(x, axis=None):
    x, axis = _scan_axis(x, axis)
    return torch.logcumsumexp(_float(x), dim=axis)


@op("kthvalue", method="kthvalue", multi_output=True)
def kthvalue(x, k, axis=-1, keepdim=False):
    order = torch.argsort(x, dim=axis, stable=True)
    idx = order.select(axis, k - 1)
    vals = torch.take_along_dim(x, idx.unsqueeze(axis), dim=axis)
    if keepdim:
        idx = idx.unsqueeze(axis)      # paddle: both keep the axis
    else:
        vals = vals.squeeze(axis)
    return vals, idx


@op("mode", method="mode", multi_output=True)
def mode(x, axis=-1, keepdim=False):
    s = torch.movedim(torch.sort(x, dim=axis).values, axis, -1)
    n = s.shape[-1]
    same = torch.cat([torch.ones(s.shape[:-1] + (1,), dtype=torch.bool,
                                 device=x.device),
                      s[..., 1:] == s[..., :-1]], dim=-1)
    pos = torch.arange(n, device=x.device)
    start = torch.cummax(torch.where(same, 0, pos), dim=-1).values
    run_len = pos - start + 1
    best = torch.argmax(run_len, dim=-1)
    vals = torch.take_along_dim(s, best[..., None], dim=-1)[..., 0]
    x_m = torch.movedim(x, axis, -1)
    indices = torch.amax((x_m == vals[..., None]) * pos, dim=-1)
    if keepdim:
        vals, indices = vals.unsqueeze(axis), indices.unsqueeze(axis)
    return vals, indices


@op("histogramdd", multi_output=True, eager_only=True)
def histogramdd(x, bins=10, ranges=None, density=False, weights=None):
    flat = None if ranges is None else [float(v) for r in ranges for v in r]
    h, edges = torch.histogramdd(x, bins=bins, range=flat, density=density,
                                 weight=weights)
    if weights is None and not density:
        h = h.long()             # counts, as the reference's
    return (h, *edges)
