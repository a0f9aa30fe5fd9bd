"""Fused RMSNorm / LayerNorm: the forward kernel K4 and the backward
kernel K5 (both Triton), their plain PyTorch versions, launch counters,
and the autograd Function joining them.

K4 replaces the TPU kernel `_norm_fwd_call` (paddle_tpu/ops/pallas_kernels.py
:796, pallas_call at :832, reached through `rms_norm_fused` :934 and
`layer_norm_fused` :939): y = (x - mean) * rstd * w (+ b) over the last
axis, with mean = 0 for RMSNorm, all in fp32 whatever the input type, and
mean / rstd returned per row as (rows,) fp32 (the TPU's (rows, 128)
sublane broadcast is gone).

K5 replaces `_norm_bwd_call` (:846, pallas_call at :869): dx = rstd * (dy*w
- xhat * mean(dy*w*xhat) [- mean(dy*w)]) in one pass from the mean and
rstd K4 returned, xhat = (x - mean) * rstd. As in `_fused_norm_data`
(:883-931), dw = sum(dy * xhat) and db = sum(dy) over rows are a plain
row reduction (`FusedNorm.backward`). K5 reads x and dy once and writes dx
once, so it is bound by bytes like K4: at ERNIE's (16384, 768) fp32 151
MB, 0.045 ms at 3.35 TB/s.

The kernel is a row reduction followed by an elementwise affine pass, so
it is bound by bytes: at (512, 4096) bf16 it must read x once and write y
once, 8 MB, ~2.5 us at 3.35 TB/s. One Triton program handles a block of
rows with the whole hidden width in registers, so x is read from device
memory exactly once; the ragged row and column edges are masked in the
kernel, so no caller pads.

`norm_forward` and `norm_backward` launch their kernels for CUDA tensors
and run `norm_forward_reference` / `norm_backward_reference` only for CPU
tensors. Triton is imported inside the launching function: the CPU test
machines have none.
"""
import functools
from typing import Optional, Tuple

import torch

__all__ = ["norm_forward", "norm_forward_reference", "norm_backward",
           "norm_backward_reference", "FusedNorm", "rms_norm", "layer_norm",
           "MAX_HIDDEN"]

# widest hidden size one program holds in registers (the TPU kernel's cap)
MAX_HIDDEN = 16384


def norm_forward_reference(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           eps: float = 1e-6, subtract_mean: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of the kernel: returns (y like x, mean (rows,) fp32,
    rstd (rows,) fp32), rows = x.numel() // x.shape[-1]."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h).float()
    if subtract_mean:
        mean = x2.mean(dim=1, keepdim=True)
        xc = x2 - mean
    else:
        mean = torch.zeros((x2.shape[0], 1), dtype=torch.float32,
                           device=x.device)
        xc = x2
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(x.shape), mean[:, 0], rstd[:, 0]


def norm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                            dy: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, subtract_mean: bool = False
                            ) -> torch.Tensor:
    """Plain version of K5: dx like x, from the forward's per-row (rows,)
    fp32 mean and rstd; fp32 arithmetic, as the TPU kernel's."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h).float()
    dyw = dy.reshape(-1, h).float() * weight.float()
    xhat = (x2 - mean[:, None] if subtract_mean else x2) * rstd[:, None]
    dx = dyw - xhat * (dyw * xhat).mean(dim=1, keepdim=True)
    if subtract_mean:
        dx = dx - dyw.mean(dim=1, keepdim=True)
    return (dx * rstd[:, None]).to(x.dtype).reshape(x.shape)


# triton.language, bound by _kernel() at the first launch. The kernel is
# defined after the binding, so its body and its `tl.constexpr`
# annotations resolve through this module's globals (this module keeps no
# `from __future__ import annotations` for that reason).
tl = None


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    import triton
    import triton.language

    tl = triton.language

    @triton.jit
    def norm_fwd(x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, rows, h,
                 eps, SUBTRACT_MEAN: tl.constexpr, HAS_BIAS: tl.constexpr,
                 BLOCK_R: tl.constexpr, BLOCK_H: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.arange(0, BLOCK_H)
        rmask = r < rows
        cmask = c < h
        m2 = rmask[:, None] & cmask[None, :]
        offs = r.to(tl.int64)[:, None] * h + c[None, :]
        x = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
        if SUBTRACT_MEAN:
            mean = tl.sum(x, axis=1) / h
            xc = tl.where(m2, x - mean[:, None], 0.0)
        else:
            mean = tl.zeros([BLOCK_R], dtype=tl.float32)
            xc = x
        rstd = 1.0 / tl.sqrt(tl.sum(xc * xc, axis=1) / h + eps)
        w = tl.load(w_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        y = xc * rstd[:, None] * w[None, :]
        if HAS_BIAS:
            bv = tl.load(b_ptr + c, mask=cmask, other=0.0).to(tl.float32)
            y = y + bv[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m2)
        tl.store(mean_ptr + r, mean, mask=rmask)
        tl.store(rstd_ptr + r, rstd, mask=rmask)

    @triton.jit
    def norm_bwd(x_ptr, w_ptr, dy_ptr, mean_ptr, rstd_ptr, dx_ptr, rows, h,
                 SUBTRACT_MEAN: tl.constexpr, BLOCK_R: tl.constexpr,
                 BLOCK_H: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.arange(0, BLOCK_H)
        rmask = r < rows
        cmask = c < h
        m2 = rmask[:, None] & cmask[None, :]
        offs = r.to(tl.int64)[:, None] * h + c[None, :]
        x = tl.load(x_ptr + offs, mask=m2, other=0.0).to(tl.float32)
        dy = tl.load(dy_ptr + offs, mask=m2, other=0.0).to(tl.float32)
        w = tl.load(w_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        rstd = tl.load(rstd_ptr + r, mask=rmask, other=0.0)
        if SUBTRACT_MEAN:
            mean = tl.load(mean_ptr + r, mask=rmask, other=0.0)
            xhat = (x - mean[:, None]) * rstd[:, None]
        else:
            xhat = x * rstd[:, None]
        # padded columns have dy*w = 0, so they add nothing to the sums
        dyw = dy * w[None, :]
        dx = dyw - xhat * (tl.sum(dyw * xhat, axis=1) / h)[:, None]
        if SUBTRACT_MEAN:
            dx = dx - (tl.sum(dyw, axis=1) / h)[:, None]
        dx = dx * rstd[:, None]
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=m2)

    return triton, norm_fwd, norm_bwd


def _launch(x2, weight, bias, eps, subtract_mean):
    triton, kern, _ = _kernel()
    rows, h = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2.device)
    block_h = triton.next_power_of_2(h)
    # ~8K fp32 values per program keeps the row block in registers
    block_r = max(1, min(16, 8192 // block_h))
    grid = (triton.cdiv(rows, block_r),)
    kern[grid](x2, weight, bias if bias is not None else weight, y, mean,
               rstd, rows, h, float(eps), SUBTRACT_MEAN=bool(subtract_mean),
               HAS_BIAS=bias is not None, BLOCK_R=block_r, BLOCK_H=block_h,
               num_warps=8 if block_h >= 4096 else 4)
    return y, mean, rstd


def norm_forward(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, eps: float = 1e-6,
                 subtract_mean: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused norm over the last axis: (y, mean, rstd). CUDA tensors launch
    the Triton kernel (counted in `norm_forward.launches`); CPU tensors run
    `norm_forward_reference`."""
    if not x.is_cuda:
        return norm_forward_reference(x, weight, bias, eps, subtract_mean)
    h = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"norm kernel takes fp32/bf16/fp16, got {x.dtype}")
    if h > MAX_HIDDEN:
        raise ValueError(f"norm kernel takes hidden <= {MAX_HIDDEN}, got {h}")
    if weight.shape != (h,) or not weight.is_cuda or (
            bias is not None and (bias.shape != (h,) or not bias.is_cuda)):
        raise ValueError("weight/bias must be CUDA tensors of shape "
                         f"({h},) beside x {tuple(x.shape)}")
    x2 = x.reshape(-1, h).contiguous()
    y, mean, rstd = _launch(x2, weight.contiguous(),
                            None if bias is None else bias.contiguous(),
                            eps, subtract_mean)
    norm_forward.launches += 1
    return y.reshape(x.shape), mean, rstd


norm_forward.launches = 0


def _launch_bwd(x2, weight, dy2, mean, rstd, subtract_mean):
    triton, _, kern = _kernel()
    rows, h = x2.shape
    dx = torch.empty_like(x2)
    block_h = triton.next_power_of_2(h)
    # x and dy both in registers: ~4K fp32 values of each per program
    block_r = max(1, min(16, 4096 // block_h))
    grid = (triton.cdiv(rows, block_r),)
    kern[grid](x2, weight, dy2, mean, rstd, dx, rows, h,
               SUBTRACT_MEAN=bool(subtract_mean), BLOCK_R=block_r,
               BLOCK_H=block_h, num_warps=8 if block_h >= 2048 else 4)
    return dx


def norm_backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                  mean: torch.Tensor, rstd: torch.Tensor,
                  subtract_mean: bool = False) -> torch.Tensor:
    """dx of the fused norm, from K4's mean and rstd. CUDA tensors launch
    the Triton kernel K5 (counted in `norm_backward.launches`); CPU tensors
    run `norm_backward_reference`."""
    if not x.is_cuda:
        return norm_backward_reference(x, weight, dy, mean, rstd,
                                       subtract_mean)
    h = x.shape[-1]
    rows = x.numel() // h
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"norm kernel takes fp32/bf16/fp16, got {x.dtype}")
    if h > MAX_HIDDEN:
        raise ValueError(f"norm kernel takes hidden <= {MAX_HIDDEN}, got {h}")
    if dy.shape != x.shape or not dy.is_cuda:
        raise ValueError(f"dy {tuple(dy.shape)} must be a CUDA tensor of x's "
                         f"shape {tuple(x.shape)}")
    if weight.shape != (h,) or not weight.is_cuda:
        raise ValueError(f"weight must be a CUDA tensor of shape ({h},)")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (rows,) or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{name} must be ({rows},) fp32 on the card")
    dx = _launch_bwd(x.reshape(-1, h).contiguous(), weight.contiguous(),
                     dy.reshape(-1, h).to(x.dtype).contiguous(),
                     mean.contiguous(), rstd.contiguous(), subtract_mean)
    norm_backward.launches += 1
    return dx.reshape(x.shape)


norm_backward.launches = 0


class FusedNorm(torch.autograd.Function):
    """K4 forward, K5 backward for dx, and the plain row reductions for dw
    and db (the TPU's `_fused_norm_data` custom vjp)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, subtract_mean):
        y, mean, rstd = norm_forward(x, weight, bias, eps, subtract_mean)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.subtract_mean = subtract_mean
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dx = norm_backward(x, weight, dy, mean, rstd, ctx.subtract_mean)
        h = x.shape[-1]
        x2 = x.reshape(-1, h).float()
        xhat = (x2 - mean[:, None] if ctx.subtract_mean else x2) * \
            rstd[:, None]
        dyf = dy.reshape(-1, h).float()
        dw = (dyf * xhat).sum(dim=0).to(weight.dtype)
        db = dyf.sum(dim=0).to(weight.dtype) if ctx.has_bias else None
        return dx, dw, db, None, None


def _norm(x, weight, bias, eps, subtract_mean):
    if torch.is_grad_enabled() and (
            x.requires_grad or weight.requires_grad
            or (bias is not None and bias.requires_grad)):
        return FusedNorm.apply(x, weight, bias, eps, subtract_mean)
    return norm_forward(x, weight, bias, eps, subtract_mean)[0]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Differentiable RMSNorm through K4 / K5."""
    return _norm(x, weight, None, eps, False)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """Differentiable LayerNorm through K4 / K5."""
    return _norm(x, weight, bias, eps, True)
