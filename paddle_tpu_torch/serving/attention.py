"""Paged attention over the page pool (ported from
paddle_tpu/serving/attention.py:89-451, 456-715).

`paged_attend` is the op behind `attend_with_cache` for a
`PagedLayerCache`: it WRITES this step's K/V into the pool in place, at
each token's own position, and then attends each query over its own
pages. Writing first is what makes padding harmless: a padded token writes
garbage K/V into the tail of its request's last page (or the null page
past the table), and later tokens overwrite each position before any
query attends to it. Quantized pools (int8 / fp8) quantize the fresh K/V
once, here, and scatter the scales with the same entries and slots, so
every path reads back the same bytes.

Routing, as in the JAX package:

- a flat ragged step (`cache.row_ids` set: every row's tokens on one
  (1, T) axis, token t reading through page-table row row_ids[t]) goes to
  `ragged_paged_attention`, whose CUDA kernels (`csrc/ragged_paged.cu`)
  replace the TPU kernel `_ragged_paged_pallas` (K7);
- one-token decode steps go to `paged_decode_attention`, whose CUDA
  kernels (`csrc/paged_decode.cu`) replace `_paged_decode_pallas` (K6, and
  its dequantizing form K6q over int8 / fp8 pools);
- a prefill at the static offset 0 over fp32 / bf16 pools attends over its
  own K/V block through the flash-attention kernel (K1);
- every other multi-token prefill - a chunk of a chunked prefill, whose
  offset is a tensor even for a first chunk at 0, and any prefill over
  quantized pools - gathers the request's pages and attends through K1
  with a -1e9 mask over L = max_pages * page_size columns
  (`_prefill_attention_paged`).

Each kernel has its plain version here (`_paged_decode_reference`,
`_ragged_attention_reference`), the only path for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..nn import torch_functional as F
from .kv_cache import NULL_PAGE, PagedLayerCache, overflow_position

__all__ = ["paged_attend", "paged_decode_attention",
           "ragged_paged_attention", "advance_positions"]

# dtype codes of the C interface (csrc/common.cuh ptt::DType)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
           torch.float8_e4m3fn: 3}
_QUANT = (torch.int8, torch.float8_e4m3fn)

# Most query vectors (tokens x rep) a query tile of the ragged kernel holds
# (`kTileRows` in csrc/ragged_paged.cu): bf16 q over bf16 / int8 / fp8 pools
# walk a tile as one warpgroup on wgmma, whose products take 64 rows
RAGGED_TILE_ROWS = 64
# the same for the fp32 forms' FMA kernel (`kNQ` there)
RAGGED_FMA_TILE_ROWS = 16


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
    """(b, s) int64 global positions of this step's tokens. `start_pos` is
    a host int (unchunked prefill), a 0-d tensor (a chunk's offset), a
    (b,) tensor (decode, every row at its own position) or a (b, s)
    tensor that already holds the positions (a flat ragged step)."""
    offs = torch.arange(s, dtype=torch.int64, device=device)
    if isinstance(start_pos, int):
        return (offs + start_pos).expand(b, s)
    start = start_pos.to(device=device, dtype=torch.int64)
    if start.dim() == 2:
        return start
    if start.dim() == 0:
        return (offs + start).expand(b, s)
    return start[:, None] + offs[None, :]


def _raw(t: torch.Tensor) -> torch.Tensor:
    """fp8 pools are indexed through a uint8 view (the same bytes): not
    every PyTorch build indexes float8 tensors."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _write_pages(pool: torch.Tensor, vals: torch.Tensor,
                 entries: torch.Tensor, slots: torch.Tensor) -> None:
    """IN PLACE: scatter (N, kvh, d) token rows into the (kvh, P, ps, d)
    pool at (entries, slots). Rows routed to the null page collide there
    harmlessly."""
    _raw(pool)[:, entries, slots] = _raw(vals).transpose(0, 1)


def _route(cache: PagedLayerCache, start_pos, b: int, s: int, device):
    """Where this step's tokens write: (positions (b, s) int32, flat pool
    page ids (b*s,), flat slots (b*s,))."""
    page_table, ps = cache.page_table, cache.page_size
    max_pages = page_table.shape[1]
    pos = _positions(start_pos, b, s, device)            # (b, s)
    page_idx = pos // ps
    idx = page_idx.clamp(0, max_pages - 1)
    if cache.row_ids is not None:
        # flat ragged batch (b == 1, s == T): token t writes through the
        # page-table ROW it belongs to, not batch row 0
        rows = page_table[cache.row_ids.to(torch.int64)]     # (T, maxP)
        entries = torch.gather(rows, 1, idx[0][:, None])[:, 0][None]
    else:
        entries = torch.gather(page_table, 1, idx)
    # positions past the table (padding, parked rows) must land in the
    # null page: clipping the index instead would alias them onto the
    # sequence's real last page and corrupt it
    entries = torch.where(page_idx >= max_pages,
                          torch.full_like(entries, NULL_PAGE),
                          entries).to(torch.int64)
    return (pos.to(torch.int32), entries.reshape(-1),
            (pos % ps).reshape(-1))


def _pool_quant_spec(storage_dtype):
    """KVQuantSpec of a quantized pool's storage type (reached only from
    quantized branches)."""
    from .quant import resolve_kv_dtype

    return resolve_kv_dtype("int8" if storage_dtype == torch.int8
                            else "fp8")


def paged_attend(q, k, v, cache: PagedLayerCache, start_pos, rep: int):
    """Write K/V into the pool (in place), attend q over the page table.
    Returns (ctx (b, s, heads, hd), cache).

    q: (b, s, heads, hd); k/v: (b, s, kv_heads, hd); start_pos: a host int
    (unchunked prefill), a 0-d tensor (a prefill chunk's offset), a (b,)
    tensor (decode) or the (1, T) positions of a flat ragged step."""
    kp, vp = cache.k_pool, cache.v_pool
    b, s = q.shape[0], q.shape[1]
    if cache.quantized:
        from .quant import quantize_tokens

        spec = _pool_quant_spec(kp.dtype)
        kd, k_sc = quantize_tokens(k, spec)
        vd, v_sc = quantize_tokens(v, spec)
    else:
        kd = k.to(kp.dtype)
        vd = v.to(vp.dtype)
    shared = cache.routing
    if (shared is not None and shared.get("start_pos") is start_pos
            and shared.get("row_ids") is cache.row_ids
            and shared.get("shape") == (b, s)):
        pos, entries, slots = shared["route"]
    else:
        pos, entries, slots = _route(cache, start_pos, b, s, q.device)
        if shared is not None:
            shared.clear()
            shared.update(start_pos=start_pos, row_ids=cache.row_ids,
                          shape=(b, s), route=(pos, entries, slots))
    _write_pages(kp, kd.reshape(b * s, *kd.shape[2:]), entries, slots)
    _write_pages(vp, vd.reshape(b * s, *vd.shape[2:]), entries, slots)
    if cache.quantized:
        _write_pages(cache.k_scale, k_sc.reshape(b * s, -1, 1), entries,
                     slots)
        _write_pages(cache.v_scale, v_sc.reshape(b * s, -1, 1), entries,
                     slots)
    static_zero = isinstance(start_pos, int) and start_pos == 0
    if cache.row_ids is not None:
        ctx = ragged_paged_attention(q, cache, pos, rep)
    elif s == 1:
        ctx = paged_decode_attention(q, cache, pos[:, 0], rep)
    elif static_zero and not cache.quantized:
        ctx = _prefill_attention(q, kd, vd, pos, rep)
    else:
        # a prefill chunk (tensor offset, even a first chunk at 0) or any
        # prefill over quantized pools: earlier K/V, and for quantized
        # pools the bytes every other path reads, live only in the pages
        ctx = _prefill_attention_paged(q, cache, pos, rep)
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


def _gather(pool: torch.Tensor, pt: torch.Tensor,
            scale: torch.Tensor = None) -> torch.Tensor:
    """The pages `pt` (n, maxP) int64 names, as (n, maxP * ps, kvh, d);
    dequantized to fp32 against the scale slab when one is given."""
    g = _raw(pool)[:, pt].view(pool.dtype)       # (kvh, n, maxP, ps, d)
    kvh, n, mp, ps, d = g.shape
    out = g.permute(1, 2, 3, 0, 4).reshape(n, mp * ps, kvh, d)
    if scale is None:
        return out
    return out.to(torch.float32) * _gather(scale, pt)


def _prefill_attention_paged(q, cache: PagedLayerCache, pos, rep):
    """Multi-token prefill through the page table: gather each row's
    whole table (the pool already holds this step's K/V), dequantize
    quantized pages, and mask by global position: query at pos[i, r] sees
    column j iff j <= pos[i, r], other columns (later slots, the null
    page) at the -1e9 floor. K1 through `F.scaled_dot_product_attention`
    with the float mask."""
    pt = cache.page_table.to(torch.int64)
    length = pt.shape[1] * cache.page_size
    kf = _expand_kv(_gather(cache.k_pool, pt, cache.k_scale), rep)
    vf = _expand_kv(_gather(cache.v_pool, pt, cache.v_scale), rep)
    allowed = (torch.arange(length, device=q.device)[None, None, :]
               <= pos.to(torch.int64)[:, :, None])           # (b, s, L)
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[:, None]
    return F.scaled_dot_product_attention(q, kf.to(q.dtype), vf.to(q.dtype),
                                          attn_mask=mask)


def _paged_decode_reference(q, cache: PagedLayerCache, pos, rep: int):
    """Plain version of the decode kernel: gather each row's pages into a
    contiguous (b, L, kvh, hd) view (dequantized against the gathered
    scales for quantized pools) and attend with a per-row length mask
    (columns past `pos` at -1e9, the reference engine's floor), fp32
    logits and softmax. Plain pools compute in q's type, quantized ones
    in fp32."""
    pt = cache.page_table.to(torch.int64)
    b, max_pages = pt.shape
    length = max_pages * cache.page_size
    cdt = torch.float32 if cache.quantized else q.dtype
    kf = _expand_kv(_gather(cache.k_pool, pt, cache.k_scale), rep).to(cdt)
    vf = _expand_kv(_gather(cache.v_pool, pt, cache.v_scale), rep).to(cdt)
    allowed = (torch.arange(length, device=q.device)[None, :]
               <= pos.to(torch.int64)[:, None])
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[:, None, None]
    d = q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q.to(cdt), kf, vf))
    logits = (qt @ kt.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    probs = torch.softmax(logits + mask, dim=-1).to(cdt)
    return (probs @ vt).transpose(1, 2).to(q.dtype)


def _ragged_attention_reference(q, cache: PagedLayerCache, pos, rep: int):
    """Plain version of the ragged kernel: every flat token t attends the
    pages of its own page-table row `row_ids[t]`, columns 0..pos[0, t]
    (the rest at -1e9), fp32 logits and softmax, as the decode reference
    does for a row. A token parked at or past the table capacity (flat
    padding) attends nothing and emits zeros, as the kernel does. Works
    per kv head on (kvh, T, L, hd) gathers, so nothing is expanded for
    GQA. q: (1, T, heads, hd); pos: (1, T). Returns (1, T, heads, hd)."""
    rows = cache.row_ids.to(torch.int64)
    pt = cache.page_table.to(torch.int64)[rows]              # (T, maxP)
    t, mp = pt.shape
    ps = cache.page_size
    length = mp * ps
    kvh, hd = cache.k_pool.shape[0], cache.k_pool.shape[3]
    cdt = torch.float32 if cache.quantized else q.dtype

    def gather(pool, scale):
        g = _raw(pool)[:, pt].view(pool.dtype).reshape(kvh, t, length, -1)
        if scale is None:
            return g.to(cdt)
        return g.to(torch.float32) * gather(scale, None).to(torch.float32)

    kf = gather(cache.k_pool, cache.k_scale)                 # (kvh,T,L,hd)
    vf = gather(cache.v_pool, cache.v_scale)
    qh = q[0].to(cdt).reshape(t, kvh, rep, hd).permute(1, 0, 2, 3)
    p = pos[0].to(torch.int64)
    allowed = torch.arange(length, device=q.device)[None, :] <= p[:, None]
    mask = torch.where(allowed, 0.0, -1e9).to(torch.float32)[None, :, None]
    logits = (qh @ kf.transpose(-1, -2)).float() * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits + mask, dim=-1).to(cdt)
    out = (probs @ vf).permute(1, 0, 2, 3).reshape(1, t, kvh * rep, hd)
    live = (p < length)[None, :, None, None]
    return torch.where(live, out, torch.zeros_like(out)).to(q.dtype)


def _paged_lib():
    lib = _build.load("paged_decode")
    fn = lib.ptt_paged_decode
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [i32] * 7 + [ctypes.c_float, i32, i32, vp]
        fn.restype = ctypes.c_int
        lib.ptt_paged_decode_splits.argtypes = [i32] * 5
        lib.ptt_paged_decode_splits.restype = i32
    return lib, fn


def _partials(n: int, heads: int, splits: int, hd: int, device):
    """Scratch of the kernels' key-split partials, fp32: (max, sum) and
    the unnormalized output of each (token, head, split)."""
    return (torch.empty((n, heads, splits, 2), dtype=torch.float32,
                        device=device),
            torch.empty((n, heads, splits, hd), dtype=torch.float32,
                        device=device))


# (device, stream) -> int32 arrival counters of the kernels' in-launch
# merge of their key splits
_COUNTERS = {}


def _arrival_counters(device, n: int) -> torch.Tensor:
    """At least `n` zeroed int32 arrival counters on `device`, one buffer
    per device and stream: it is zeroed once, when it is made (or grown),
    and every launch leaves the counters it used at zero again, so a call
    costs no memset launch."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 0 if buf is None else 2 * buf.numel())
        buf = torch.zeros(size, dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _check_pools(what: str, cache: PagedLayerCache, hd: int, heads: int,
                 rep: int, q_dtype, head_dims):
    """Common operand checks of the two paged kernels; returns the scale
    pointers (0, 0 for plain pools)."""
    kp, vp = cache.k_pool, cache.v_pool
    kvh, _, _, hd_pool = kp.shape
    if hd_pool != hd or vp.shape != kp.shape:
        raise ValueError(f"{what} takes pools (kvh, P, ps, hd) matching q's "
                         f"head_dim; got {tuple(kp.shape)}, "
                         f"{tuple(vp.shape)} for head_dim {hd}")
    if heads != kvh * rep or rep not in (1, 2, 4, 8) or hd not in head_dims:
        raise ValueError(f"{what} kernel takes heads == kv_heads * rep with "
                         f"rep in 1/2/4/8 and head_dim in {head_dims} "
                         f"(heads {heads}, kv_heads {kvh}, rep {rep}, "
                         f"head_dim {hd})")
    if q_dtype not in (torch.float32, torch.bfloat16) \
            or kp.dtype not in _DTYPES or vp.dtype != kp.dtype:
        raise TypeError(f"{what} takes fp32/bf16 q and fp32/bf16/int8/fp8 "
                        f"pools, got {q_dtype} / {kp.dtype} / {vp.dtype}")
    if (kp.dtype in _QUANT) != cache.quantized:
        raise TypeError(f"{what}: int8/fp8 pools need scale slabs and "
                        "fp32/bf16 pools take none")
    tensors = [kp, vp, cache.page_table]
    if cache.quantized:
        sshape = kp.shape[:3] + (1,)
        for sc in (cache.k_scale, cache.v_scale):
            if sc.shape != sshape or sc.dtype != torch.float32 \
                    or not sc.is_contiguous():
                raise ValueError(f"{what} takes contiguous fp32 scale slabs "
                                 f"of shape {tuple(sshape)}")
        tensors += [cache.k_scale, cache.v_scale]
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{what} needs every operand on the card")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError(f"{what} needs contiguous pools")
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError(f"{what} needs 16-byte aligned pools (they are "
                         "read in 16-byte pieces)")
    if cache.quantized:
        return cache.k_scale.data_ptr(), cache.v_scale.data_ptr()
    return 0, 0


def paged_decode_attention(q, cache: PagedLayerCache, pos, rep: int):
    """One-token-per-row attention over the page pool. q: (b, 1, heads,
    hd); pos: (b,) int - each row's token position (its key length minus
    one). Returns (b, 1, heads, hd). CUDA tensors launch the kernel: K6
    over fp32 / bf16 pools (counted in `paged_decode_attention.launches`),
    K6q over int8 / fp8 pools with their scale slabs (counted in
    `.quant_launches`), one count a call; CPU tensors run
    `_paged_decode_reference`.

    bf16 q over bf16, int8 or fp8 pools at head_dim 64 / 128 takes the
    decode walk (csrc/paged_common.cuh): one launch, splits of 128 keys
    merged in the launch by the last split to arrive (arrival counters
    from `_arrival_counters`). fp32 q or pools, and head_dim 32 / 256, take
    the FMA kernel and its merge kernel."""
    if not q.is_cuda:
        return _paged_decode_reference(q, cache, pos, rep)
    kp, vp, page_table = cache.k_pool, cache.v_pool, cache.page_table
    b, one, heads, hd = q.shape
    kvh, num_pages, ps, _ = kp.shape
    if one != 1:
        raise ValueError(f"paged decode takes q (b, 1, heads, hd), got "
                         f"{tuple(q.shape)}")
    ks_ptr, vs_ptr = _check_pools("paged decode", cache, hd, heads, rep,
                                  q.dtype, (32, 64, 128, 256))
    if page_table.shape[0] != b or pos.shape != (b,) or not pos.is_cuda:
        raise ValueError("page_table rows and pos must match the batch, "
                         "on the card")
    qc = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    lib, fn = _paged_lib()
    max_pages = page_table.shape[1]
    splits = lib.ptt_paged_decode_splits(max_pages, ps, hd, _DTYPES[q.dtype],
                                         _DTYPES[kp.dtype])
    part_ml, part_acc = _partials(b, heads, splits, hd, q.device)
    counters = _arrival_counters(q.device, b * kvh)
    err = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks_ptr, vs_ptr,
             pt.data_ptr(), pos32.data_ptr(), out.data_ptr(),
             part_ml.data_ptr(), part_acc.data_ptr(), counters.data_ptr(), b,
             heads, kvh, hd, num_pages, ps, max_pages, 1.0 / math.sqrt(hd),
             _DTYPES[q.dtype], _DTYPES[kp.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode", lib)
    if cache.quantized:
        paged_decode_attention.quant_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = 0


def _ragged_lib():
    lib = _build.load("ragged_paged")
    fn = lib.ptt_ragged_paged
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 14 + [i32] * 9
                       + [ctypes.c_float, i32, i32, vp])
        fn.restype = ctypes.c_int
        lib.ptt_ragged_paged_splits.argtypes = [i32] * 4
        lib.ptt_ragged_paged_splits.restype = i32
    return lib, fn


def _ragged_tile_rows(q_dtype, kv_dtype) -> int:
    """Most query vectors of a query tile for these types (the kernel's
    `ptt_ragged_paged_tile_rows`, readable without loading it)."""
    if q_dtype == torch.bfloat16 and kv_dtype != torch.float32:
        return RAGGED_TILE_ROWS
    return RAGGED_FMA_TILE_ROWS


def _ragged_plan(row_ids: torch.Tensor, pos: torch.Tensor, tq: int,
                 cap: int, rows: int):
    """Query tiles of a flat step, on the device and without a host sync.
    A run is a stretch of consecutive tokens with the same row id that are
    all live or all parked (position outside [0, cap), or a row id outside
    [0, rows)); a run of n tokens is cut into ceil(n / tq) tiles of nearly
    equal length, so for tq >= 4 a tile of one token is exactly a token
    alone in its run. Returns (starts (T + 2,) int32, whose first `count`
    entries are the tile starts in order and entry `count` is T; (2,)
    int32: count, then the number of live tiles)."""
    t = row_ids.shape[0]
    dev = row_ids.device
    idx = torch.arange(t, device=dev)
    parked = (pos < 0) | (pos >= cap) | (row_ids < 0) | (row_ids >= rows)
    brk = torch.ones(t, dtype=torch.bool, device=dev)
    brk[1:] = (row_ids[1:] != row_ids[:-1]) | (parked[1:] != parked[:-1])
    run = torch.cumsum(brk, 0) - 1
    run_start = torch.cummax(torch.where(brk, idx, 0), 0).values
    run_len = torch.zeros(t, dtype=torch.int64, device=dev).scatter_add_(
        0, run, torch.ones_like(run))[run]
    pieces = (run_len + tq - 1) // tq
    piece = (idx - run_start) * pieces // run_len
    first = brk.clone()
    first[1:] |= piece[1:] != piece[:-1]
    slot = torch.where(first, torch.cumsum(first, 0) - 1, t + 1)
    starts = torch.full((t + 2,), t, dtype=torch.int32, device=dev)
    starts.scatter_(0, slot, idx.to(torch.int32))
    count = torch.stack((first.sum(), (first & ~parked).sum()))
    return starts, count.to(torch.int32)


def ragged_paged_attention(q, cache: PagedLayerCache, pos, rep: int):
    """Flat ragged attention: all rows' tokens of a mixed prefill/decode
    step ride one (1, T) axis; `cache.row_ids[t]` names token t's
    page-table row and `pos[0, t]` its global position (its key length
    minus one). Decode rows contribute one token, prefill chunks a
    contiguous run; padding tokens park at the table capacity and emit
    zeros. q: (1, T, heads, hd); pos: (1, T). Returns (1, T, heads, hd).

    CUDA tensors launch K7 (plain pools counted in
    `ragged_paged_attention.launches`, int8 / fp8 pools in
    `.quant_launches`), one count a call; CPU tensors run
    `_ragged_attention_reference`.

    bf16 q over bf16, int8 or fp8 pools takes the Hopper kernel in one
    launch: a query tile of one token (a decode token) is the decode walk
    over splits of 128 keys, merged in the launch; a longer tile (at most
    RAGGED_TILE_ROWS query vectors of one row's consecutive tokens) runs
    on wgmma over all its keys and writes no partials, unless the live
    tiles give fewer (tile, kv head) pairs than half the card's SMs: then
    it too is split over 128 keys and merged in the launch. fp32 q or pools
    take the FMA kernel and its merge kernel."""
    if not q.is_cuda:
        return _ragged_attention_reference(q, cache, pos, rep)
    kp, vp, page_table = cache.k_pool, cache.v_pool, cache.page_table
    one, t, heads, hd = q.shape
    kvh, num_pages, ps, _ = kp.shape
    row_ids = cache.row_ids
    if one != 1 or row_ids is None or tuple(row_ids.shape) != (t,) \
            or tuple(pos.shape) != (1, t):
        raise ValueError(f"ragged attention takes q (1, T, heads, hd) with "
                         f"row_ids (T,) and pos (1, T); got q "
                         f"{tuple(q.shape)}, row_ids "
                         f"{None if row_ids is None else tuple(row_ids.shape)}"
                         f", pos {tuple(pos.shape)}")
    ks_ptr, vs_ptr = _check_pools("ragged attention", cache, hd, heads, rep,
                                  q.dtype, (64, 128))
    if not (row_ids.is_cuda and pos.is_cuda):
        raise ValueError("ragged attention needs every operand on the card")
    lib, fn = _ragged_lib()
    max_pages = page_table.shape[1]
    rows = page_table.shape[0]
    cap = max_pages * ps
    tq = _ragged_tile_rows(q.dtype, kp.dtype) // rep
    shared = cache.routing
    key = ("ragged_plan", tq)
    hit = shared.get(key) if shared is not None else None
    if hit is not None and hit[0] is row_ids and hit[1] is pos:
        rows32, pos32, starts, count = hit[2:]
    else:
        rows32 = row_ids.to(torch.int32).contiguous()
        pos32 = pos.reshape(t).to(torch.int32).contiguous()
        starts, count = _ragged_plan(rows32, pos32, tq, cap, rows)
        if shared is not None:
            shared[key] = (row_ids, pos, rows32, pos32, starts, count)
    qc = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    qd, kd = _DTYPES[q.dtype], _DTYPES[kp.dtype]
    splits = lib.ptt_ragged_paged_splits(max_pages, ps, qd, kd)
    part_ml, part_acc = _partials(t, heads, splits, hd, q.device)
    counters = _arrival_counters(q.device, t * kvh)
    grid_tiles = min(t, -(-t // tq) + rows + 1)
    err = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks_ptr, vs_ptr,
             pt.data_ptr(), pos32.data_ptr(), rows32.data_ptr(),
             starts.data_ptr(), count.data_ptr(), part_ml.data_ptr(),
             part_acc.data_ptr(), counters.data_ptr(), out.data_ptr(), t,
             heads, kvh, hd, num_pages, ps, max_pages, rows, grid_tiles,
             1.0 / math.sqrt(hd), qd, kd,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ragged_paged", lib)
    if cache.quantized:
        ragged_paged_attention.quant_launches += 1
    else:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.quant_launches = 0
