"""Fused RMSNorm / LayerNorm forward: a Triton kernel, its plain PyTorch
version, and a launch counter.

Replaces the TPU kernel `_norm_fwd_call` (paddle_tpu/ops/pallas_kernels.py
:796, pallas_call at :832, reached through `rms_norm_fused` :934 and
`layer_norm_fused` :939): y = (x - mean) * rstd * w (+ b) over the last
axis, with mean = 0 for RMSNorm, all in fp32 whatever the input type, and
mean / rstd returned per row as (rows,) fp32 (the TPU's (rows, 128)
sublane broadcast is gone).

The kernel is a row reduction followed by an elementwise affine pass, so
it is bound by bytes: at (512, 4096) bf16 it must read x once and write y
once, 8 MB, ~2.5 us at 3.35 TB/s. One Triton program handles a block of
rows with the whole hidden width in registers, so x is read from device
memory exactly once; the ragged row and column edges are masked in the
kernel, so no caller pads.

`norm_forward` launches the kernel for CUDA tensors and runs
`norm_forward_reference` only for CPU tensors. Triton is imported inside
the launching function: the CPU test machines have none.
"""
import functools
from typing import Optional, Tuple

import torch

__all__ = ["norm_forward", "norm_forward_reference", "rms_norm",
           "layer_norm", "MAX_HIDDEN"]

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

    return triton, norm_fwd


def _launch(x2, weight, bias, eps, subtract_mean):
    triton, kern = _kernel()
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return norm_forward(x, weight, None, eps, subtract_mean=False)[0]


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    return norm_forward(x, weight, bias, eps, subtract_mean=True)[0]
