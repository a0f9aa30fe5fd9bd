"""Flash attention: the forward kernel K1 (`csrc/flash_fwd.cu`), the
backward kernels K2 (dQ) and K3 (dK, dV) (`csrc/flash_bwd.cu`), their plain
PyTorch versions, launch counters, and the autograd Function joining them.

K1 replaces the TPU kernel `_fwd_call` (paddle_tpu/ops/pallas_kernels.py
:164, pallas_call at :303); K2 `_bwd_dq_call` (:357, pallas_call :462); K3
`_bwd_dkv_call` (:474, pallas_call :572); `FlashAttention` the custom-vjp
glue `_flash_vjp` (:587-660), reached through `flash_attention` (:729) and
`_flash_attention_data` (:667). Public layout (batch, seq, heads,
head_dim), as `F.scaled_dot_product_attention` takes it; an optional
additive float mask of shape (b|1, h|1, sq|1, sk); top-left causal
masking; lse (b, h, sq) fp32; attention dropout (upscale_in_train, the
softmax denominator undropped) whose keep mask is the counter-based hash
of `ops.dropout_mask`, drawn from a one-element int32 `seed` tensor on the
device. A trainable mask (T5's relative position bias) gets its gradient
from K2: d(mask) = dS in fp32, which the kernel sums over batch groups into
(groups, h, sq, sk) partials (`dmask_groups` picks the groups; a mask with
its own batch dim takes one entry a group) and `reduce_dmask` sums here over
the groups and the mask's other size-1 dims, as `_flash_vjp` does
(:643-657).

The ring form of the three kernels (K1r, K2r, K3r: the TPU kernels' `offs=`
and `keep_neg_inf_lse=` parameters, which only K8's `_ring_vjp` passes) is
`offsets=(q_off, k_off)`: causal masking at global positions, query row r
seeing key column c iff r + q_off >= c + k_off, so that one ring step
attends its query shard to the key shard of another rank
(`ops.ring_flash`). With `keep_neg_inf_lse` a row that sees no key reports
lse = -inf instead of 0, so the ring's merge weighs it at zero. Launches
with offsets are counted apart (`ring_launches`) from the single-call ones
(`launches`). `scale` replaces the default 1 / sqrt(head_dim).

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors. See the headers of the .cu files for the
kernels' design and what bounds them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from .. import _build
from .dropout_mask import keep_mask, threshold

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_backward", "flash_attention_backward_reference",
           "attention_delta", "dmask_groups", "dmask_partials",
           "reduce_dmask", "FlashAttention", "attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _keep(seed, b, h, sq, sk, dropout_p, device):
    return keep_mask(seed.to(device), b, h, sq, sk, dropout_p)


def _causal_keep(sq, sk, device, offsets=None):
    """(sq, sk) bool: row + q_off >= col + k_off."""
    q_off, k_off = offsets or (0, 0)
    rows = torch.arange(sq, device=device)[:, None] + q_off
    return rows >= torch.arange(sk, device=device)[None, :] + k_off


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def _acc_dtype(x):
    """The plain versions' arithmetic type: fp32, or fp64 for fp64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              attn_mask: Optional[torch.Tensor] = None,
                              is_causal: bool = False,
                              return_lse: bool = False,
                              dropout_p: float = 0.0,
                              seed: Optional[torch.Tensor] = None,
                              scale: Optional[float] = None,
                              offsets: Optional[Tuple[int, int]] = None,
                              keep_neg_inf_lse: bool = False
                              ) -> Union[torch.Tensor,
                                         Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version: the materialized-softmax attention of the reference
    op (paddle_tpu/ops/nn_ops.py scaled_dot_product_attention): fp32
    (fp64 for fp64 inputs) logits and softmax, probabilities cast back to
    the input type. Rows whose every column is -inf give 0 and lse 0 (-inf
    with `keep_neg_inf_lse`), as the kernel. With dropout the probabilities
    are where(keep, p / (1 - r), 0) and lse is the undropped one. Causal
    masking is at the global positions `offsets` (K1r's plain version)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))   # (b, h, s, d)
    acc = _acc_dtype(q)
    logits = (qt @ kt.transpose(-1, -2)).to(acc) * _scale(scale, d)
    if attn_mask is not None:
        logits = logits + attn_mask.to(acc)
    if is_causal:
        logits = logits.masked_fill(~_causal_keep(sq, sk, q.device, offsets),
                                    float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe)
    l_sum = p.sum(dim=-1, keepdim=True)
    probs = p / l_sum.clamp_min(1e-30)
    if dropout_p > 0.0:
        keep = _keep(seed, b, h, sq, sk, dropout_p, q.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)), 0.0)
    out = (probs.to(q.dtype) @ vt).transpose(1, 2)
    if not return_lse:
        return out
    lse = (m + torch.log(l_sum.clamp_min(1e-30)))[..., 0]
    if not keep_neg_inf_lse:
        lse = torch.where(torch.isinf(lse) & (lse < 0), torch.zeros_like(lse),
                          lse)
    return out, lse


# K2's query rows a block (csrc/flash_bwd.cu kDqRows), the H100's SMs, and
# the most d(mask) groups: partials of at most 8 x h x sq x sk fp32
_DQ_ROWS, _SMS, _MAX_DMASK_GROUPS = 128, 132, 8


def dmask_groups(b: int, h: int, sq: int, mask_shape,
                 sms: int = _SMS) -> int:
    """The number of batch groups whose d(mask) partials K2 writes: b for a
    mask with its own batch dim (each entry is its own group); else at most
    8, the count whose grid (ceil(sq / 128) x h blocks a group, one block an
    SM) finishes soonest, reckoned as waves of blocks times the batch
    entries a block walks, the fewest groups among equals. Every group
    holds ceil(b / groups) entries but the last, which holds the rest."""
    if mask_shape[0] != 1:
        return b
    blocks = -(-sq // _DQ_ROWS) * h

    def cost(groups):
        return (-(-blocks * groups // sms) * -(-b // groups), groups)

    # group counts with no empty group: ceil(b / n) for n entries a group
    return min((-(-b // n) for n in range(-(-b // _MAX_DMASK_GROUPS), b + 1)),
               key=cost)


def dmask_partials(full: torch.Tensor, groups: int) -> torch.Tensor:
    """The plain version of K2's grouped d(mask): the (b, h, sq, sk) dS
    summed over consecutive batch groups of ceil(b / groups) entries, in
    batch order, into (groups, h, sq, sk)."""
    n = -(-full.shape[0] // groups)
    if n == 1:
        return full
    return torch.stack([full[i:i + n].sum(0)
                        for i in range(0, full.shape[0], n)])


def reduce_dmask(partials: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """d(mask) from K2's (groups, h, sq, sk) fp32 partials (groups = b: the
    whole dS): summed over the dims where `mask` has size 1 (batch, heads,
    query), in the mask's dtype, as `_flash_vjp` collapses the broadcast
    dims (:643-657)."""
    dims = tuple(i for i in range(3) if mask.shape[i] == 1)
    if dims:
        partials = partials.sum(dim=dims, keepdim=True)
    return partials.to(mask.dtype)


def _check_groups(groups, b, mask_shape):
    if not 1 <= groups <= b or (mask_shape[0] != 1 and groups != b):
        raise ValueError(f"d(mask) of a {tuple(mask_shape)} mask at batch {b} "
                         f"cannot sum over {groups} batch groups")


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 (fp64 for fp64 inputs), (b, h, sq):
    the backward's row term, computed outside the kernels as `_flash_vjp`
    does (:627-633)."""
    acc = _acc_dtype(out)
    return (dout.to(acc) * out.to(acc)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None, is_causal: bool = False,
        dropout_p: float = 0.0, seed: Optional[torch.Tensor] = None,
        need_dq: bool = True, need_dkv: bool = True, need_dmask: bool = False,
        scale: Optional[float] = None,
        offsets: Optional[Tuple[int, int]] = None,
        groups: Optional[int] = None
        ) -> Tuple[Optional[torch.Tensor], ...]:
    """Plain version of K2 and K3: (dq, dk, dv), each None when not asked
    for, and d(mask) fourth with `need_dmask`. The arithmetic of
    `_recompute_p_ds` and the two TPU kernels: fp32 (fp64 for fp64 inputs)
    products of the input-type values, p = exp(s - lse), dS = p * (dP -
    delta), and dS / P_dropped rounded to the input type before their
    products, as the kernels feed them to the matrix units. d(mask) is the
    unrounded dS, summed as K2 sums it: over `groups` batch groups
    (`dmask_groups` by default) by `dmask_partials`, then by
    `reduce_dmask`. Causal masking is at the global positions `offsets`
    (K2r's and K3r's plain version)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale(scale, d)
    acc = _acc_dtype(q)
    qt, kt, vt, dot = (x.transpose(1, 2).to(acc) for x in (q, k, v, dout))
    s = (qt @ kt.transpose(-1, -2)) * scale
    if attn_mask is not None:
        s = s + attn_mask.to(acc)
    if is_causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device, offsets),
                          float("-inf"))
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = dot @ vt.transpose(-1, -2)
    p_drop = p
    if dropout_p > 0.0:
        keep = _keep(seed, b, h, sq, sk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        p_drop = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds_full = p * (dp - delta.to(acc)[..., None])
    ds = ds_full.to(q.dtype).to(acc)
    dq = dk = dv = None
    if need_dq:
        dq = ((ds @ kt) * scale).transpose(1, 2).to(q.dtype)
    if need_dkv:
        dk = ((ds.transpose(-1, -2) @ qt) * scale).transpose(1, 2).to(k.dtype)
        dv = (p_drop.to(q.dtype).to(acc).transpose(-1, -2) @ dot
              ).transpose(1, 2).to(v.dtype)
    if need_dmask:
        if groups is None:
            groups = dmask_groups(b, h, sq, attn_mask.shape)
        _check_groups(groups, b, attn_mask.shape)
        return dq, dk, dv, reduce_dmask(dmask_partials(ds_full, groups),
                                        attn_mask)
    return dq, dk, dv


# ------------------------------------------------------- kernel launches

def _fn(lib_name, sym, argtypes):
    lib = _build.load(lib_name)
    fn = getattr(lib, sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


_VP, _I32, _I64, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_uint,
                               ctypes.c_float)
_FWD_ARGS = [_VP] * 6 + [_I32] * 5 + [_I64] * 3 + [_I32] * 4 + [
    _F32, _VP, _U32, _F32, _I32, _VP]
_DQ_ARGS = [_VP] * 9 + [_I32] * 6 + [_I64] * 3 + [_I32] * 3 + [
    _F32, _VP, _U32, _F32, _I32, _VP]
_DKV_ARGS = [_VP] * 9 + [_I32] * 5 + [_I64] * 3 + [_I32] * 3 + [
    _F32, _VP, _U32, _F32, _I32, _VP]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_qkv(q, k, v, what):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{what} takes (b, s, h, d) q/k/v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{what} needs k/v with q's batch, heads and "
                         "head_dim (expand grouped kv heads first)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes fp32 or bf16 q/k/v of one type, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= 256:
        raise ValueError(f"{what} takes head_dim 1..256, got {d}")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must all be CUDA tensors")


def _mask_args(attn_mask, q, sk):
    """(mask fp32 contiguous or None, msb, msh, msq): size-1 dims of the
    mask become zero strides."""
    if attn_mask is None:
        return None, 0, 0, 0
    b, sq, h, _ = q.shape
    if attn_mask.dim() != 4 or not attn_mask.is_floating_point():
        raise ValueError("attn_mask must be a 4-D additive float mask")
    mb, mh, mq, mk = attn_mask.shape
    if mb not in (1, b) or mh not in (1, h) or mq not in (1, sq) or mk != sk:
        raise ValueError(f"attn_mask {tuple(attn_mask.shape)} does not "
                         f"broadcast to ({b}, {h}, {sq}, {sk})")
    if not attn_mask.is_cuda:
        raise ValueError("attn_mask must be a CUDA tensor beside q")
    mask = attn_mask.detach().float().contiguous()
    return (mask, mask.stride(0) if mb > 1 else 0,
            mask.stride(1) if mh > 1 else 0, mask.stride(2) if mq > 1 else 0)


def _dropout_args(dropout_p, seed, q):
    """(seed tensor or None, threshold, inv_keep) for the C interface."""
    if dropout_p <= 0.0:
        return None, 0, 1.0
    if not 0.0 < dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1), got {dropout_p}")
    if seed is None or seed.numel() < 1 or seed.is_floating_point():
        raise ValueError("dropout needs a one-element integer seed tensor")
    if seed.device != q.device:
        raise ValueError(f"the dropout seed lies on {seed.device}, q on "
                         f"{q.device}")
    return (seed.reshape(-1)[:1].to(torch.int32).contiguous(),
            threshold(dropout_p), 1.0 / (1.0 - dropout_p))


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def _offset_args(offsets):
    """(q_off, k_off) as host ints; (0, 0) for one call."""
    if offsets is None:
        return 0, 0
    q_off, k_off = (int(o) for o in offsets)
    if abs(q_off) >= 2 ** 30 or abs(k_off) >= 2 ** 30:
        raise ValueError(f"offsets {offsets} overflow the kernels' int32 "
                         "positions")
    return q_off, k_off


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask: Optional[torch.Tensor] = None,
                    is_causal: bool = False, return_lse: bool = False,
                    dropout_p: float = 0.0,
                    seed: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    offsets: Optional[Tuple[int, int]] = None,
                    keep_neg_inf_lse: bool = False
                    ) -> Union[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """softmax(q k^T * scale + mask) v over (b, s, h, d) tensors, scale
    1 / sqrt(d) by default, with attention dropout `dropout_p` keyed by
    `seed` (a one-element int32 tensor on q's device). With `offsets`
    (q_off, k_off), causal masking is at those global positions (the ring
    form K1r); `keep_neg_inf_lse` reports lse = -inf for rows that see no
    key. CUDA tensors launch K1 (counted in `flash_attention.launches`, or
    in `flash_attention.ring_launches` with offsets); CPU tensors run
    `flash_attention_reference`."""
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, attn_mask, is_causal,
                                         return_lse, dropout_p, seed, scale,
                                         offsets, keep_neg_inf_lse)
    _check_qkv(q, k, v, "flash_attention")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    mask, msb, msh, msq = _mask_args(attn_mask, q, sk)
    seed_t, thresh, inv = _dropout_args(dropout_p, seed, q)
    q_off, k_off = _offset_args(offsets)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib, fn = _fn("flash_fwd", "ptt_flash_fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
             out.data_ptr(), _ptr(lse), b, sq, sk, h, d, msb, msh, msq,
             int(bool(is_causal)), q_off, k_off, int(bool(keep_neg_inf_lse)),
             _scale(scale, d), _ptr(seed_t), thresh, inv, _DTYPES[q.dtype],
             _stream(q))
    _build.check(err, "flash_fwd", lib)
    if offsets is None:
        flash_attention.launches += 1
    else:
        flash_attention.ring_launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.ring_launches = 0


def _bwd_prepare(q, k, v, dout, lse, delta, attn_mask, dropout_p, seed,
                 what):
    """K2's and K3's inputs, checked and laid out once for both: ((q, k, v,
    dout) contiguous and aligned, lse, delta, mask args, dropout args)."""
    _check_qkv(q, k, v, what)
    if dout.shape != q.shape:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"{what}: {name} must be ({b}, {h}, {sq}) fp32 "
                             f"on the card, got {tuple(t.shape)} {t.dtype}")
    mask_args = _mask_args(attn_mask, q, k.shape[1])
    drop_args = _dropout_args(dropout_p, seed, q)
    tensors = tuple(_aligned(x) for x in (q, k, v, dout.to(q.dtype)))
    return (tensors, lse.contiguous(), delta.contiguous(), mask_args,
            drop_args)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_dq(prep, is_causal, groups=0, scale=None, offsets=None):
    """K2: (dq, partials). With `groups` > 0 K2 also writes d(mask) as
    (groups, h, sq, sk) fp32 partial sums over batch groups of
    ceil(b / groups) entries (every element written, so the buffer is not
    zeroed), for `reduce_dmask`; else partials is None."""
    (q, k, v, dout), lse, delta, (mask, msb, msh, msq), (seed_t, thresh,
                                                         inv) = prep
    b, sq, h, d = q.shape
    sk = k.shape[1]
    partials, n_per = None, 1
    if groups:
        if offsets is not None:
            raise ValueError("flash_attention_dq: ring offsets and d(mask) "
                             "do not combine (as the TPU kernel asserts)")
        if mask is None:
            raise ValueError("flash_attention_dq: d(mask) needs a mask")
        _check_groups(groups, b, (1 if msb == 0 else b,))
        n_per = -(-b // groups)
        partials = torch.empty((-(-b // n_per), h, sq, sk),
                               dtype=torch.float32, device=q.device)
    q_off, k_off = _offset_args(offsets)
    dq = torch.empty_like(q)
    lib, fn = _fn("flash_bwd", "ptt_flash_bwd_dq", _DQ_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             _ptr(partials), b, n_per, sq, sk, h, d, msb, msh, msq,
             int(bool(is_causal)), q_off, k_off, _scale(scale, d),
             _ptr(seed_t), thresh, inv, _DTYPES[q.dtype], _stream(q))
    _build.check(err, "flash_bwd_dq", lib)
    if offsets is None:
        flash_attention_dq.launches += 1
    else:
        flash_attention_dq.ring_launches += 1
    if groups:
        flash_attention_dq.dmask_launches += 1
    return dq, partials


def _launch_dkv(prep, is_causal, scale=None, offsets=None):
    (q, k, v, dout), lse, delta, (mask, msb, msh, msq), (seed_t, thresh,
                                                         inv) = prep
    b, sq, h, d = q.shape
    q_off, k_off = _offset_args(offsets)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = _fn("flash_bwd", "ptt_flash_bwd_dkv", _DKV_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), b, sq, k.shape[1], h, d, msb, msh, msq,
             int(bool(is_causal)), q_off, k_off, _scale(scale, d),
             _ptr(seed_t), thresh, inv, _DTYPES[q.dtype], _stream(q))
    _build.check(err, "flash_bwd_dkv", lib)
    if offsets is None:
        flash_attention_dkv.launches += 1
    else:
        flash_attention_dkv.ring_launches += 1
    return dk, dv


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor,
                       attn_mask: Optional[torch.Tensor] = None,
                       is_causal: bool = False, dropout_p: float = 0.0,
                       seed: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None,
                       offsets: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """dQ. CUDA tensors launch K2 (counted in `flash_attention_dq.launches`,
    or with `offsets`, the ring form K2r, in `.ring_launches`; the launches
    that also write d(mask), from `flash_attention_backward`, in
    `.dmask_launches`); CPU tensors run the dq part of
    `flash_attention_backward_reference`."""
    if not q.is_cuda:
        return flash_attention_backward_reference(
            q, k, v, dout, lse, delta, attn_mask, is_causal, dropout_p, seed,
            need_dkv=False, scale=scale, offsets=offsets)[0]
    return _launch_dq(_bwd_prepare(q, k, v, dout, lse, delta, attn_mask,
                                   dropout_p, seed, "flash_attention_dq"),
                      is_causal, scale=scale, offsets=offsets)[0]


flash_attention_dq.launches = 0
flash_attention_dq.ring_launches = 0
flash_attention_dq.dmask_launches = 0


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor,
                        attn_mask: Optional[torch.Tensor] = None,
                        is_causal: bool = False, dropout_p: float = 0.0,
                        seed: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None,
                        offsets: Optional[Tuple[int, int]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV). CUDA tensors launch K3 (counted in
    `flash_attention_dkv.launches`, or with `offsets`, the ring form K3r,
    in `.ring_launches`); CPU tensors run the dk / dv part of
    `flash_attention_backward_reference`."""
    if not q.is_cuda:
        return flash_attention_backward_reference(
            q, k, v, dout, lse, delta, attn_mask, is_causal, dropout_p, seed,
            need_dq=False, scale=scale, offsets=offsets)[1:3]
    return _launch_dkv(_bwd_prepare(q, k, v, dout, lse, delta, attn_mask,
                                    dropout_p, seed, "flash_attention_dkv"),
                       is_causal, scale=scale, offsets=offsets)


flash_attention_dkv.launches = 0
flash_attention_dkv.ring_launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             attn_mask: Optional[torch.Tensor] = None,
                             is_causal: bool = False, dropout_p: float = 0.0,
                             seed: Optional[torch.Tensor] = None,
                             need_dmask: bool = False,
                             scale: Optional[float] = None
                             ) -> Tuple[Optional[torch.Tensor], ...]:
    """(dq, dk, dv, d(mask) or None) from the forward's out and lse: delta
    outside the kernels, then K2 (asked for d(mask) only with
    `need_dmask`) and K3 on inputs checked and laid out once for CUDA
    tensors, the plain version (once) for CPU tensors."""
    delta = attention_delta(out, dout)
    if not q.is_cuda:
        grads = flash_attention_backward_reference(
            q, k, v, dout, lse, delta, attn_mask, is_causal, dropout_p, seed,
            need_dmask=need_dmask, scale=scale)
        return grads if need_dmask else (*grads, None)
    prep = _bwd_prepare(q, k, v, dout, lse, delta, attn_mask, dropout_p,
                        seed, "flash_attention_backward")
    b, sq, h, _ = q.shape
    groups = (dmask_groups(b, h, sq, attn_mask.shape, _sms(q.device))
              if need_dmask else 0)
    dq, partials = _launch_dq(prep, is_causal, groups, scale)
    dk, dv = _launch_dkv(prep, is_causal, scale)
    dmask = reduce_dmask(partials, attn_mask) if need_dmask else None
    return dq, dk, dv, dmask


class FlashAttention(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the TPU's `_flash_vjp`). The forward
    saves q, k, v (as the kernels read them), the mask, the seed, out and
    lse. The mask gets its gradient from K2 when autograd asks for one
    (a trainable mask), and K2 writes no d(mask) otherwise."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, is_causal, dropout_p, seed,
                scale=None):
        if q.is_cuda:
            # the kernels read contiguous, aligned q / k / v (the fused QKV
            # projection gives strided views): lay them out once here and
            # save those, so the backward copies none of them again
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
        out, lse = flash_attention(q, k, v, attn_mask, is_causal, True,
                                   dropout_p, seed, scale)
        ctx.save_for_backward(q, k, v, attn_mask, seed, out, lse)
        ctx.is_causal = is_causal
        ctx.dropout_p = dropout_p
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, attn_mask, seed, out, lse = ctx.saved_tensors
        dq, dk, dv, dmask = flash_attention_backward(
            q, k, v, out, lse, dout, attn_mask, ctx.is_causal, ctx.dropout_p,
            seed, need_dmask=ctx.needs_input_grad[3], scale=ctx.scale)
        return dq, dk, dv, dmask, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              attn_mask: Optional[torch.Tensor] = None,
              is_causal: bool = False, dropout_p: float = 0.0,
              seed: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention: `FlashAttention` when a gradient is
    wanted (of q, k, v or a trainable mask), the forward kernel alone
    otherwise."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (q, k, v, attn_mask)):
        return FlashAttention.apply(q, k, v, attn_mask, is_causal, dropout_p,
                                    seed, scale)
    return flash_attention(q, k, v, attn_mask, is_causal, False, dropout_p,
                           seed, scale)
