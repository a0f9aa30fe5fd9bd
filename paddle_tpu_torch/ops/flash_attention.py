"""Flash-attention forward: the CUDA kernel `csrc/flash_fwd.cu`, its plain
PyTorch version, and a launch counter.

Replaces the TPU kernel `_fwd_call` (paddle_tpu/ops/pallas_kernels.py:164,
pallas_call at :303), reached through `flash_attention` (:729) and
`_flash_attention_data` (:667). Public layout (batch, seq, heads,
head_dim), as `F.scaled_dot_product_attention` takes it; an optional
additive float mask of shape (b|1, h|1, sq|1, sk) and top-left causal
masking; optional lse (b, h, sq) fp32. Dropout and the ring offsets of
the TPU kernel are not ported yet.

See the header of `csrc/flash_fwd.cu` for the kernel's design and what
bounds it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from .. import _build

__all__ = ["flash_attention", "flash_attention_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attn_mask: Optional[torch.Tensor] = None,
                              is_causal: bool = False,
                              return_lse: bool = False
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version: the materialized-softmax attention of the reference
    op (paddle_tpu/ops/nn_ops.py scaled_dot_product_attention): fp32
    logits and softmax, probabilities cast back to the input type.
    Rows whose every column is -inf give 0 and lse 0, as the kernel."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (b, h, s, d)
    logits = (qt @ kt.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    if is_causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    l_sum = p.sum(dim=-1, keepdim=True)
    probs = (p / l_sum.clamp_min(1e-30)).to(q.dtype)
    out = (probs @ vt).transpose(1, 2)
    if not return_lse:
        return out
    lse = (m + torch.log(l_sum.clamp_min(1e-30)))[..., 0]
    lse = torch.where(torch.isinf(lse) & (lse < 0), torch.zeros_like(lse),
                      lse)
    return out, lse


def _lib():
    lib = _build.load("flash_fwd")
    fn = lib.ptt_flash_fwd
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32,
                       i64, i64, i64, i32, ctypes.c_float, i32, vp]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k, v, mask, want_lse, is_causal):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    msb = msh = msq = 0
    if mask is not None:
        mb, mh, mq, _ = mask.shape
        msb = mask.stride(0) if mb > 1 else 0
        msh = mask.stride(1) if mh > 1 else 0
        msq = mask.stride(2) if mq > 1 else 0
    lib, fn = _lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             mask.data_ptr() if mask is not None else None, out.data_ptr(),
             lse.data_ptr() if lse is not None else None, b, sq, sk, h, d,
             msb, msh, msq, int(bool(is_causal)), 1.0 / math.sqrt(d),
             _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd", lib)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: Optional[torch.Tensor] = None,
                    is_causal: bool = False, return_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """softmax(q k^T / sqrt(d) + mask) v over (b, s, h, d) tensors. CUDA
    tensors launch the kernel (counted in `flash_attention.launches`); CPU
    tensors run `flash_attention_reference`."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, attn_mask, is_causal,
                                         return_lse)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention takes (b, s, h, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError("flash_attention needs k/v with q's batch, heads "
                         "and head_dim (expand grouped kv heads first)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes fp32 or bf16 q/k/v of one "
                        f"type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= 256:
        raise ValueError(f"flash_attention takes head_dim 1..256, got {d}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must all be CUDA tensors")
    mask = None
    if attn_mask is not None:
        if attn_mask.dim() != 4 or not attn_mask.is_floating_point():
            raise ValueError("attn_mask must be a 4-D additive float mask")
        mb, mh, mq, mk = attn_mask.shape
        if (mb not in (1, b) or mh not in (1, h) or mq not in (1, sq)
                or mk != k.shape[1]):
            raise ValueError(f"attn_mask {tuple(attn_mask.shape)} does not "
                             f"broadcast to ({b}, {h}, {sq}, {k.shape[1]})")
        mask = attn_mask.float().contiguous()
    out, lse = _launch(q.contiguous(), k.contiguous(), v.contiguous(), mask,
                       return_lse, is_causal)
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
