"""Softmax cross-entropy: the plain `cross_entropy` and the chunked
`fused_linear_cross_entropy` head that never materializes the (N, vocab)
logits.

Counterparts of `cross_entropy` (paddle_tpu/ops/nn_ops.py:405-440) and
`fused_linear_cross_entropy` (:460-597). The fused head walks the rows in
chunks of `chunk_size`: the forward keeps each row's log-sum-exp and gold
logit, the backward recomputes each chunk's logits and forms dlogits =
(softmax - onehot) * g chunk by chunk, so only one (chunk, vocab) block is
ever resident (flash attention's trick applied to the LM head). There is
no TPU kernel here. Its products take the input type's values (bf16 under
O1) and, as the reference's (`preferred_element_type=jnp.float32`,
:493-494 and :546-553), sum them in fp32 and keep the fp32 result: the
logits, and each chunk's weight gradient, which is added into an fp32 sum
and rounded to the weight's type once, at the end. dx is rounded to x's
type once, as there. Log-sum-exp and softmax are fp32. The final chunk is
simply shorter, so no padded row exists (the reference pads and gives
padded rows lse = +inf, :522-528, to keep them at exactly zero).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100,
                  reduction: str = "mean") -> torch.Tensor:
    """Hard-label softmax cross-entropy over the last axis in fp32; rows
    labelled `ignore_index` count neither in the loss nor in the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = label.reshape(logp.shape[:-1]).long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = -logp.gather(-1, safe[..., None])[..., 0] * valid
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.sum().clamp_min(1).float()


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in fp32 and returned in fp32 (fp64 stays fp64): on the
    card the `out_dtype` product of the bf16 operands, on the CPU the fp32
    product of their values."""
    if a.dtype in (torch.float32, torch.float64):
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _logits(x_c, w, bias_f, transpose_y):
    return _mm_f32(x_c, w.t() if transpose_y else w) + bias_f


class _FusedLinearCE(torch.autograd.Function):
    """Per-row losses (n,) fp32 of cross_entropy(x2 @ w(^T) + b, lbl), with
    the reference's custom VJP: the backward recomputes the logits chunk by
    chunk from the saved per-row lse."""

    @staticmethod
    def forward(ctx, x2, w, b, lbl, ignore_index, transpose_y, chunk):
        n = x2.shape[0]
        bias_f = b.float()
        loss = torch.empty(n, dtype=torch.float32, device=x2.device)
        lse = torch.empty(n, dtype=torch.float32, device=x2.device)
        for s in range(0, n, chunk):
            logits = _logits(x2[s:s + chunk], w, bias_f, transpose_y)
            lse_c = torch.logsumexp(logits, dim=1)
            l_c = lbl[s:s + chunk]
            valid = l_c != ignore_index
            gold = logits.gather(1, torch.where(valid, l_c, 0)[:, None])[:, 0]
            loss[s:s + chunk] = torch.where(valid, lse_c - gold, 0.0)
            lse[s:s + chunk] = lse_c
        ctx.save_for_backward(x2, w, b, lbl, lse)
        ctx.ignore_index, ctx.transpose_y, ctx.chunk = (ignore_index,
                                                        transpose_y, chunk)
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, w, b, lbl, lse = ctx.saved_tensors
        chunk, transpose_y = ctx.chunk, ctx.transpose_y
        n = x2.shape[0]
        bias_f = b.float()
        dx = torch.empty_like(x2)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        g = g.float()
        for s in range(0, n, chunk):
            x_c = x2[s:s + chunk]
            rows = x_c.shape[0]
            p = torch.exp(_logits(x_c, w, bias_f, transpose_y)
                          - lse[s:s + chunk, None])
            l_c = lbl[s:s + chunk]
            valid = l_c != ctx.ignore_index
            p[torch.arange(rows, device=p.device),
              torch.where(valid, l_c, 0)] -= 1.0
            coeff = p * (g[s:s + chunk] * valid)[:, None]      # dlogits
            coeff_l = coeff.to(x2.dtype)      # the products in x's type
            dx[s:s + chunk] = coeff_l @ (w if transpose_y else w.t())
            if transpose_y:
                dw += _mm_f32(coeff_l.t(), x_c)
            else:
                dw += _mm_f32(x_c.t(), coeff_l)
            db += coeff.sum(dim=0)
        return (dx, dw.to(w.dtype), db.to(b.dtype), None, None, None, None)


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               bias: Optional[torch.Tensor] = None,
                               label: Optional[torch.Tensor] = None,
                               ignore_index: int = -100,
                               transpose_y: bool = False,
                               reduction: str = "mean",
                               chunk_size: int = 2048) -> torch.Tensor:
    """cross_entropy(x @ weight(^T) + bias, label) with hard labels, in
    chunks of `chunk_size` rows. weight is (vocab, H) with `transpose_y`,
    else (H, vocab)."""
    if label is None:
        raise ValueError("fused_linear_cross_entropy needs labels")
    hdim = x.shape[-1]
    x2 = x.reshape(-1, hdim)
    lbl = label.reshape(-1).long()
    vocab = weight.shape[0] if transpose_y else weight.shape[1]
    dtype = torch.promote_types(x2.dtype, weight.dtype)
    x2, weight = x2.to(dtype), weight.to(dtype)
    b = (torch.zeros(vocab, dtype=torch.float32, device=x.device)
         if bias is None else bias)
    chunk = max(1, int(min(chunk_size, x2.shape[0])))
    loss = _FusedLinearCE.apply(x2, weight, b, lbl, int(ignore_index),
                                bool(transpose_y), chunk)
    if reduction == "none":
        return loss.reshape(label.shape)
    if reduction == "sum":
        return loss.sum()
    valid = (lbl != ignore_index).sum().clamp_min(1).float()
    return loss.sum() / valid
