"""Paged attention over the page pool (ported from
paddle_tpu/serving/attention.py:89-365, 456-585).

`paged_attend` is the op behind `attend_with_cache` for a
`PagedLayerCache`: it WRITES this step's K/V into the pool in place, at
each row's own position, and then attends each query over its own pages.
Writing first is what makes prefill padding harmless: a padded prefill
token writes garbage K/V into the tail of its request's last page (or the
null page past the table), and decode overwrites each position before any
query attends to it.

One-token decode steps go to `paged_decode_attention`, whose CUDA kernels
(`csrc/paged_decode.cu`: a split-KV pass and a merge of the splits)
replace the TPU kernel `_paged_decode_pallas`;
`_paged_decode_reference` is its plain version (gather the pages, mask
past `pos` to -1e9, softmax), the only path for CPU tensors. Prefill at
offset 0 attends over its own K/V block through the flash-attention
kernel, as the JAX engine does through `F.scaled_dot_product_attention`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..nn import functional as F
from .kv_cache import NULL_PAGE, PagedLayerCache, overflow_position

__all__ = ["paged_attend", "paged_decode_attention", "advance_positions"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def advance_positions(positions: torch.Tensor, live: torch.Tensor,
                      max_pages: int, page_size: int) -> torch.Tensor:
    """Device-side position advance for the multi-step decode horizon:
    live rows step to the next token position; dead rows (EOS emitted,
    budget exhausted, batch padding) park at the table-overflow position,
    which `paged_attend` routes to the null page.

    positions: (b,) int32 current write positions; live: (b,) bool."""
    park = overflow_position(max_pages, page_size)
    return torch.where(live, positions + 1,
                       torch.full_like(positions, park))


def _positions(start_pos, b: int, s: int, device) -> torch.Tensor:
    """(b, s) int64 global positions of this step's tokens: `start_pos` is
    a host int (prefill) or a (b,) tensor (ragged decode)."""
    offs = torch.arange(s, dtype=torch.int64, device=device)
    if isinstance(start_pos, int):
        return (offs + start_pos).expand(b, s)
    return start_pos.to(torch.int64)[:, None] + offs[None, :]


def _write_pages(pool: torch.Tensor, vals: torch.Tensor,
                 entries: torch.Tensor, slots: torch.Tensor) -> None:
    """IN PLACE: scatter (N, kvh, hd) token rows into the (kvh, P, ps, hd)
    pool at (entries, slots). Rows routed to the null page collide there
    harmlessly."""
    pool[:, entries, slots] = vals.transpose(0, 1)


def _route(cache: PagedLayerCache, start_pos, b: int, s: int, device):
    """Where this step's tokens write: (positions (b, s) int32, flat pool
    page ids (b*s,), flat slots (b*s,))."""
    page_table, ps = cache.page_table, cache.page_size
    max_pages = page_table.shape[1]
    pos = _positions(start_pos, b, s, device)            # (b, s)
    page_idx = pos // ps
    entries = torch.gather(page_table, 1,
                           page_idx.clamp(0, max_pages - 1)).to(torch.int64)
    # positions past the table (padding rows, parked rows) must land in the
    # null page: clipping the index instead would alias them onto the
    # sequence's real last page and corrupt it
    entries = torch.where(page_idx >= max_pages,
                          torch.full_like(entries, NULL_PAGE), entries)
    return (pos.to(torch.int32), entries.reshape(-1),
            (pos % ps).reshape(-1))


def paged_attend(q, k, v, cache: PagedLayerCache, start_pos, rep: int):
    """Write K/V into the pool (in place), attend q over the page table.
    Returns (ctx (b, s, heads, hd), cache).

    q: (b, s, heads, hd); k/v: (b, s, kv_heads, hd); start_pos: host int 0
    (prefill, one request at offset 0) or a (b,) int tensor (decode, one
    token per row at its own position)."""
    kp, vp = cache.k_pool, cache.v_pool
    b, s = q.shape[0], q.shape[1]
    kd = k.to(kp.dtype)
    vd = v.to(vp.dtype)
    shared = cache.routing
    if (shared is not None and shared.get("start_pos") is start_pos
            and shared.get("shape") == (b, s)):
        pos, entries, slots = shared["route"]
    else:
        pos, entries, slots = _route(cache, start_pos, b, s, q.device)
        if shared is not None:
            shared.update(start_pos=start_pos, shape=(b, s),
                          route=(pos, entries, slots))
    _write_pages(kp, kd.reshape(b * s, *kd.shape[2:]), entries, slots)
    _write_pages(vp, vd.reshape(b * s, *vd.shape[2:]), entries, slots)
    if s == 1:
        ctx = paged_decode_attention(q, cache, pos[:, 0], rep)
    elif isinstance(start_pos, int) and start_pos == 0:
        ctx = _prefill_attention(q, kd, vd, pos, rep)
    else:
        raise NotImplementedError(
            "prefill at a nonzero offset (prefix caching, chunked prefill) "
            "is not ported yet (ROADMAP queue 1: S2/S3)")
    return ctx, cache


def _expand_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=2) if rep > 1 else x


def _prefill_attention(q, kd, vd, pos, rep):
    """Prefill attends over this step's own K/V block (the sequence starts
    at position 0, so the block IS the cache), with the same -1e9 mask
    arithmetic as the reference engine. Positions run 0..s-1, so the mask
    is exactly top-left causal: `is_causal` adds nothing to the result
    (masked columns get probability 0 either way) but lets the kernel
    skip the key tiles above the diagonal."""
    kf = _expand_kv(kd, rep).to(q.dtype)
    vf = _expand_kv(vd, rep).to(q.dtype)
    # query at global pos[i, r] sees keys at pos[i, c] <= pos[i, r]
    allowed = pos[:, None, :] <= pos[:, :, None]            # (b, s, s)
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[:, None]
    return F.scaled_dot_product_attention(q, kf, vf, attn_mask=mask,
                                          is_causal=True)


def _paged_decode_reference(q, cache: PagedLayerCache, pos, rep: int):
    """Plain version of the decode kernel: gather each row's pages into a
    contiguous (b, L, kvh, hd) view and attend with a per-row length mask
    (columns past `pos` at -1e9, the reference engine's floor), fp32
    logits and softmax, probabilities cast back to q's type."""
    kp, vp, page_table = cache.k_pool, cache.v_pool, cache.page_table
    b, max_pages = page_table.shape
    ps = cache.page_size
    length = max_pages * ps
    pt = page_table.to(torch.int64)

    def gather(pool):
        g = pool[:, pt]                        # (kvh, b, maxP, ps, hd)
        kvh, _, mp, _, hd = g.shape
        return g.permute(1, 2, 3, 0, 4).reshape(b, mp * ps, kvh, hd)

    kf = _expand_kv(gather(kp), rep).to(q.dtype)
    vf = _expand_kv(gather(vp), rep).to(q.dtype)
    allowed = (torch.arange(length, device=q.device)[None, :]
               <= pos.to(torch.int64)[:, None])
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[:, None, None]
    d = q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kf, vf))
    logits = (qt @ kt.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    probs = torch.softmax(logits + mask, dim=-1).to(q.dtype)
    return (probs @ vt).transpose(1, 2)


def _lib():
    lib = _build.load("paged_decode")
    fn = lib.ptt_paged_decode
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 8 + [i32] * 7 + [ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        lib.ptt_paged_decode_splits.argtypes = [i32, i32]
        lib.ptt_paged_decode_splits.restype = i32
    return lib, fn


def paged_decode_attention(q, cache: PagedLayerCache, pos, rep: int):
    """One-token-per-row attention over the page pool. q: (b, 1, heads,
    hd); pos: (b,) int - each row's token position (its key length minus
    one). Returns (b, 1, heads, hd). CUDA tensors launch the kernel
    (counted in `paged_decode_attention.launches`); CPU tensors run
    `_paged_decode_reference`."""
    if not q.is_cuda:
        return _paged_decode_reference(q, cache, pos, rep)
    kp, vp, page_table = cache.k_pool, cache.v_pool, cache.page_table
    b, one, heads, hd = q.shape
    kvh, num_pages, ps, hd_pool = kp.shape
    if one != 1 or hd_pool != hd or vp.shape != kp.shape:
        raise ValueError(f"paged decode takes q (b, 1, heads, hd) and pools "
                         f"(kvh, P, ps, hd); got {tuple(q.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(vp.shape)}")
    if heads != kvh * rep or rep not in (1, 2, 4, 8) \
            or hd not in (32, 64, 128, 256):
        raise ValueError(f"paged decode kernel takes heads == kv_heads * rep "
                         f"with rep in 1/2/4/8 and head_dim in 32/64/128/256 "
                         f"(heads {heads}, kv_heads {kvh}, rep {rep}, "
                         f"head_dim {hd})")
    if q.dtype not in _DTYPES or kp.dtype not in _DTYPES \
            or vp.dtype != kp.dtype:
        raise TypeError(f"paged decode takes fp32/bf16 q and pools, got "
                        f"{q.dtype} / {kp.dtype} / {vp.dtype}")
    if page_table.shape[0] != b or pos.shape != (b,):
        raise ValueError("page_table rows and pos must match the batch")
    if not (kp.is_cuda and vp.is_cuda and page_table.is_cuda and pos.is_cuda):
        raise ValueError("paged decode needs every operand on the card")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("paged decode needs contiguous pools")
    qc = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    lib, fn = _lib()
    max_pages = page_table.shape[1]
    # per-split partials (max, sum, unnormalized output) the merge reads
    splits = lib.ptt_paged_decode_splits(max_pages, ps)
    part_ml = torch.empty((b, heads, splits, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, heads, splits, hd), dtype=torch.float32,
                           device=q.device)
    err = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
             pos32.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
             part_acc.data_ptr(), b, heads, kvh, hd, num_pages, ps,
             max_pages, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             _DTYPES[kp.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode", lib)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
