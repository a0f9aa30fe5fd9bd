"""Linear algebra and FFT ops of the op table (counterparts of
paddle_tpu/ops/linalg.py and the inline linalg / fft entries of
ops.yaml), as torch code over torch tensors.

`svd_lowrank` and `pca_lowrank` sketch with a Gaussian test matrix drawn
from a generator seeded 0 on the input's device (the reference's fixed
PRNGKey(0)): deterministic, but not the reference's draws, so the two
agree on what the sketch recovers, not bit for bit.
"""
from __future__ import annotations

import torch

from .registry import register_op as op


@op("matmul", amp="white")
def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


@op("t", inplace_view=True)
def t(x):
    return x if x.dim() < 2 else x.transpose(-1, -2)


@op("norm", amp="black")
def norm(x, p="fro", axis=None, keepdim=False):
    if axis is None and p in ("fro", 2):
        return torch.sqrt(torch.sum(torch.square(x)))
    if isinstance(axis, (list, tuple)) and len(axis) == 2:
        return torch.linalg.matrix_norm(x, ord=p, dim=tuple(axis),
                                        keepdim=keepdim)
    if p == "fro":
        p = 2
    if p == float("inf"):
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), dim=axis, keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dim=axis, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                               keepdim=keepdim), 1.0 / p)


@op("cholesky", amp="black")
def cholesky(x, upper=False):
    low = torch.linalg.cholesky(x)
    return low.transpose(-1, -2) if upper else low


@op("svd", amp="black", multi_output=True)
def svd(x, full_matrices=False):
    return tuple(torch.linalg.svd(x, full_matrices=full_matrices))


@op("slogdet", amp="black", multi_output=True)
def slogdet(x):
    return tuple(torch.linalg.slogdet(x))


@op("eigh", amp="black", multi_output=True)
def eigh(x, UPLO="L"):
    return tuple(torch.linalg.eigh(x, UPLO=UPLO))


@op("lstsq", amp="black", multi_output=True)
def lstsq(x, y, rcond=None):
    driver = "gelsd" if x.device.type == "cpu" else "gels"
    return tuple(torch.linalg.lstsq(x, y, rcond=rcond, driver=driver))


@op("histogram")
def histogram(x, bins=100, min=0.0, max=0.0):
    return torch.histc(x.float(), bins=bins, min=min, max=max)


# -------------------------------------------------- ops.yaml: linalg
@op("tensordot", method="tensordot")
def tensordot(x, y, axes=2):
    return torch.tensordot(x, y, dims=axes)


@op("multi_dot")
def multi_dot(xs):
    return torch.linalg.multi_dot(list(xs))


@op("addmm", amp="white", method="addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


@op("eigvalsh", amp="black", method="eigvalsh")
def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO=UPLO)


@op("lu", amp="black", method="lu", multi_output=True)
def lu(x, pivot=True):
    lu_mat, piv = torch.linalg.lu_factor(x, pivot=pivot)
    return lu_mat, piv.to(torch.int32)


def _pairwise(d, p, dtype):
    if p == 2.0:
        return torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1), min=0.0))
    if p == float("inf"):
        return torch.amax(torch.abs(d), dim=-1)
    if p == 0:
        return torch.sum(d != 0, dim=-1).to(dtype)
    return torch.sum(torch.abs(d) ** p, dim=-1) ** (1.0 / p)


@op("cdist", amp="black", method="cdist")
def cdist(x, y, p=2.0):
    return _pairwise(x[..., :, None, :] - y[..., None, :, :], p, x.dtype)


@op("pdist", amp="black")
def pdist(x, p=2.0):
    n = x.shape[0]
    full = _pairwise(x[:, None, :] - x[None, :, :], p, x.dtype)
    iu = torch.triu_indices(n, n, 1, device=x.device)
    return full[iu[0], iu[1]]


@op("dist", amp="black", method="dist")
def dist(x, y, p=2.0):
    d = torch.abs(x - y).reshape(-1).float()
    if p == float("inf"):
        return torch.amax(d)
    if p == 0:
        return torch.sum(d != 0).float()
    return torch.sum(d ** p) ** (1.0 / p)


@op("corrcoef", amp="black", method="corrcoef")
def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.transpose(-1, -2))


@op("cov", amp="black", method="cov")
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    return torch.cov(x if rowvar else x.transpose(-1, -2),
                     correction=1 if ddof else 0,
                     fweights=None if fweights is None else fweights.long(),
                     aweights=aweights)


@op("cholesky_solve", amp="black", method="cholesky_solve")
def cholesky_solve(x, y, upper=False):
    # paddle: solve A X = B given y, the Cholesky factor of A, and x = B;
    # only y's triangle is read, so only it takes a gradient
    y = torch.triu(y) if upper else torch.tril(y)
    return torch.cholesky_solve(x, y, upper=upper)


@op("eig", amp="black", method="eig", multi_output=True)
def eig(x):
    return tuple(torch.linalg.eig(x))


@op("eigvals", amp="black", method="eigvals")
def eigvals(x):
    return torch.linalg.eigvals(x)


@op("matrix_exp", amp="black", method="matrix_exp")
def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


@op("lu_unpack", amp="black", method="lu_unpack", multi_output=True)
def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True):
    if x.dim() != 2:
        raise NotImplementedError(
            "lu_unpack supports 2-D factors, as the reference")
    pmat, low, up = torch.lu_unpack(x, y.to(torch.int32))
    empty = torch.zeros((0, 0), dtype=x.dtype, device=x.device)
    if not unpack_ludata:
        low = up = empty
    if not unpack_pivots:
        pmat = empty
    return pmat, low, up


@op("householder_product", amp="black", method="householder_product")
def householder_product(x, tau):
    if x.dim() != 2:
        raise NotImplementedError(
            "householder_product supports 2-D factors, as the reference")
    return torch.linalg.householder_product(x, tau)


@op("ormqr")
def ormqr(x, tau, y, left=True, transpose=False):
    if x.dim() != 2:
        raise NotImplementedError(
            "ormqr supports 2-D reflectors, as the reference")
    return torch.ormqr(x, tau, y, left=left, transpose=transpose)


def _lowrank(x, q, niter):
    m, n = x.shape
    q = min(int(q), m, n)
    k = min(q + 6, m, n)          # oversampling
    gen = torch.Generator(device=x.device).manual_seed(0)
    omega = torch.randn((n, k), generator=gen, dtype=x.dtype,
                        device=x.device)
    y = x @ omega
    for _ in range(int(niter)):
        y = x @ (x.transpose(-1, -2).conj() @ y)
    qm, _ = torch.linalg.qr(y)
    b = qm.transpose(-1, -2).conj() @ x
    ub, s, vh = torch.linalg.svd(b, full_matrices=False)
    u = qm @ ub
    return u[:, :q], s[:q], vh.transpose(-1, -2)[:, :q]


@op("svd_lowrank", multi_output=True)
def svd_lowrank(x, q=6, niter=2, M=None):
    if x.dim() != 2:
        raise NotImplementedError("svd_lowrank supports 2-D, as the "
                                  "reference")
    return _lowrank(x if M is None else x - M, q, niter)


@op("pca_lowrank", multi_output=True)
def pca_lowrank(x, q=None, center=True, niter=2):
    if x.dim() != 2:
        raise NotImplementedError("pca_lowrank supports 2-D, as the "
                                  "reference")
    if q is None:
        q = min(6, x.shape[-2], x.shape[-1])
    if center:
        x = x - x.mean(dim=-2, keepdim=True)
    return _lowrank(x, q, niter)


@op("vander", method="vander")
def vander(x, n=None, increasing=False):
    n = x.shape[-1] if n is None else n
    powers = torch.cumprod(torch.cat([torch.ones_like(x[..., None]),
                                      x[..., None].expand(
                                          *x.shape, max(n - 1, 0))], -1),
                           dim=-1)[..., :n]
    return powers if increasing else torch.flip(powers, (-1,))


@op("bmm", amp="white")
def bmm(x, y):
    return torch.matmul(x, y)


@op("mm", amp="white")
def mm(x, y):
    return torch.matmul(x, y)


@op("dot")
def dot(x, y):
    return torch.sum(x * y, dim=-1)


@op("outer")
def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


@op("inner")
def inner(x, y):
    return torch.inner(x, y)


@op("cross")
def cross(x, y, axis=-1):
    return torch.linalg.cross(x, y, dim=axis)


@op("einsum", amp="white")
def einsum(operands, equation):
    return torch.einsum(equation, *list(operands))


@op("qr", amp="black", multi_output=True)
def qr(x, mode="reduced"):
    if mode == "r":
        return (torch.linalg.qr(x, mode="r").R,)
    return tuple(torch.linalg.qr(x, mode=mode))


@op("inverse", amp="black")
def inverse(x):
    return torch.linalg.inv(x)


@op("pinv", amp="black")
def pinv(x, rcond=1e-15):
    return torch.linalg.pinv(x, rtol=rcond)


@op("det", amp="black")
def det(x):
    return torch.linalg.det(x)


@op("matrix_power", amp="black")
def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


@op("solve", amp="black")
def solve(x, y):
    return torch.linalg.solve(x, y)


@op("triangular_solve", amp="black")
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    a = x.transpose(-1, -2) if transpose else x
    return torch.linalg.solve_triangular(a, y, upper=upper != transpose,
                                         left=True,
                                         unitriangular=unitriangular)


@op("matrix_rank", amp="black")
def matrix_rank(x, tol=None):
    return torch.linalg.matrix_rank(x, rtol=tol)


@op("cond", amp="black")
def cond(x, p=None):
    return torch.linalg.cond(x, p)


@op("mv", amp="white")
def mv(x, vec):
    return torch.matmul(x, vec)


@op("trace_op")
def trace_op(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


# ------------------------------------------------------------ fft
def _fft1(fn):
    def body(x, n=None, axis=-1, norm="backward"):
        return fn(x, n=n, dim=axis, norm=norm)

    return body


def _fftn(fn, default_axes):
    def body(x, s=None, axes=default_axes, norm="backward"):
        return fn(x, s=None if s is None else tuple(s),
                  dim=None if axes is None else tuple(axes), norm=norm)

    return body


for _name in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
    op(_name, amp="black", method=_name)(_fft1(getattr(torch.fft, _name)))
for _name in ("fft2", "ifft2", "rfft2", "irfft2"):
    op(_name, amp="black", method=_name)(
        _fftn(getattr(torch.fft, _name), (-2, -1)))
for _name in ("fftn", "ifftn", "rfftn", "irfftn"):
    op(_name, amp="black", method=_name)(
        _fftn(getattr(torch.fft, _name), None))
del _name


@op("fftshift")
def fftshift(x, axes=None):
    return torch.fft.fftshift(x, dim=axes)


@op("ifftshift")
def ifftshift(x, axes=None):
    return torch.fft.ifftshift(x, dim=axes)


def _hfft_nd(x, s, axes, norm):
    axes = tuple(axes)
    y = x
    if len(axes) > 1:
        y = torch.fft.fftn(y, s=None if s is None else tuple(s[:-1]),
                           dim=axes[:-1], norm=norm)
    return torch.fft.hfft(y, n=None if s is None else s[-1], dim=axes[-1],
                          norm=norm)


def _ihfft_nd(x, s, axes, norm):
    axes = tuple(axes)
    y = torch.fft.ihfft(x, n=None if s is None else s[-1], dim=axes[-1],
                        norm=norm)
    if len(axes) > 1:
        y = torch.fft.ifftn(y, s=None if s is None else tuple(s[:-1]),
                            dim=axes[:-1], norm=norm)
    return y


@op("hfft2", amp="black")
def hfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _hfft_nd(x, s, axes, norm)


@op("hfftn", amp="black")
def hfftn(x, s=None, axes=None, norm="backward"):
    return _hfft_nd(x, s, range(-x.dim(), 0) if axes is None else axes,
                    norm)


@op("ihfft2", amp="black")
def ihfft2(x, s=None, axes=(-2, -1), norm="backward"):
    return _ihfft_nd(x, s, axes, norm)


@op("ihfftn", amp="black")
def ihfftn(x, s=None, axes=None, norm="backward"):
    return _ihfft_nd(x, s, range(-x.dim(), 0) if axes is None else axes,
                     norm)

