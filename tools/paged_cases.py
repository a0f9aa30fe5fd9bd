"""Seeded inputs of the paged attention kernels at their main-path shapes,
shared by tools/paged_ab.py and tools/paged_stamps.py.

LLaMA-7B's attention widths (32 query heads of 128, page 16, 64 pages a
row, capacity 1024):

- `decode_case`: K6 / K6q, one query token for each of 8 rows at positions
  spread over 0..1023 (the served decode shape);
- `flat_case`: K7 / K7q on the flat step of the chunked serve: 8 decode
  tokens at positions spread over 0..1023, one 256-token chunk at 512..767
  (row 8), padded with parked tokens to T = 328. `park="chunk"` parks the
  chunk's tokens, `park="decode"` the decode tokens, so the two halves of
  the call can be timed apart; `run=n` keeps only the chunk's last n
  tokens, at 1024 - n..1023 (the tail of a prompt chunked at ~1000), and
  parks the rest of it.

Only the wrappers' public signatures and `PagedLayerCache` are used, so the
cases run against any tree of the port.
"""
import numpy as np
import torch

FLAT_T = 328
HD, PS, MAXP = 128, 16, 64


def _pools(kvh, num_pages, kv, g, dev):
    shape = (kvh, num_pages, PS, HD)
    if kv in ("bf16", "fp32"):
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        return (torch.randn(shape, generator=g, device=dev).to(dt),
                torch.randn(shape, generator=g, device=dev).to(dt),
                None, None)
    from paddle_tpu_torch.serving.quant import (quantize_tokens,
                                                resolve_kv_dtype)

    spec = resolve_kv_dtype(kv)
    (kd, ks), (vd, vs) = (quantize_tokens(
        torch.randn(shape, generator=g, device=dev), spec) for _ in range(2))
    return kd, vd, ks, vs


def decode_case(dev, kv="bf16", rep=1, seed=3):
    """(call, plain, label): the paged decode wrapper at b = 8 and its
    plain version on the same inputs."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    b, heads = 8, 32
    kvh = heads // rep
    num_pages = b * MAXP + 1
    kp, vp, ks, vs = _pools(kvh, num_pages, kv, g, dev)
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages))[
        :b * MAXP].reshape(b, MAXP).astype(np.int32)).to(dev)
    pos = torch.from_numpy(np.linspace(0, MAXP * PS - 1, b)
                           .astype(np.int32)).to(dev)
    dtype = torch.float32 if kv == "fp32" else torch.bfloat16
    q = torch.randn(b, 1, heads, HD, generator=g, device=dev).to(dtype)
    cache = PagedLayerCache(kp, vp, table, k_scale=ks, v_scale=vs)
    return (lambda: att.paged_decode_attention(q, cache, pos, rep),
            lambda: att._paged_decode_reference(q, cache, pos, rep),
            f"decode {kv} rep {rep} b=8 positions 0..1023")


def flat_case(dev, kv="bf16", rep=1, park=None, run=0, seed=8):
    """(call, plain, label): the ragged wrapper on the flat step and its
    plain version on the same inputs."""
    from paddle_tpu_torch.serving import attention as att
    from paddle_tpu_torch.serving.kv_cache import PagedLayerCache

    g = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.RandomState(seed)
    heads, nrows = 32, 9
    kvh = heads // rep
    cap = MAXP * PS
    num_pages = nrows * MAXP + 1
    kp, vp, ks, vs = _pools(kvh, num_pages, kv, g, dev)
    table = torch.from_numpy(rng.permutation(np.arange(1, num_pages))[
        :nrows * MAXP].reshape(nrows, MAXP).astype(np.int32)).to(dev)
    pos_np = np.full((FLAT_T,), cap, np.int32)
    rid_np = np.zeros((FLAT_T,), np.int32)
    pos_np[:8] = np.linspace(0, cap - 1, 8).astype(np.int32)
    rid_np[:8] = np.arange(8)
    pos_np[8:264] = np.arange(512, 768)
    rid_np[8:264] = 8
    if run:
        pos_np[8:264 - run] = cap
        pos_np[264 - run:264] = np.arange(cap - run, cap)
    if park == "chunk":
        pos_np[8:264] = cap
    elif park == "decode":
        pos_np[:8] = cap
    pos = torch.from_numpy(pos_np).to(dev)[None]
    rid = torch.from_numpy(rid_np).to(dev)
    dtype = torch.float32 if kv == "fp32" else torch.bfloat16
    q = torch.randn(1, FLAT_T, heads, HD, generator=g, device=dev).to(dtype)
    cache = PagedLayerCache(kp, vp, table, rid, k_scale=ks, v_scale=vs,
                            routing={})
    label = (f"flat {kv} rep {rep}" + (f", {run}-token run" if run else "")
             + (f", {park} parked" if park else ""))
    return (lambda: att.ragged_paged_attention(q, cache, pos, rep),
            lambda: att._ragged_attention_reference(q, cache, pos, rep),
            label)
