"""The attention-dropout keep mask: a counter-based hash of (seed, batch,
head, query row, key column).

Counterpart of `_keep_mask` (paddle_tpu/ops/pallas_kernels.py:68-92),
which seeds the TPU's on-chip generator per (batch, head, q-block, k-block)
so that the forward and both backward kernels redraw the same mask. Here
the keep bit of every element is a pure function of its absolute
coordinates, so it does not depend on how a kernel tiles the score matrix:
the CUDA forward (`csrc/flash_fwd.cu`), both CUDA backward kernels
(`csrc/flash_bwd.cu`) and the plain versions draw the identical mask, and
kernel-versus-plain checks stay exact with dropout on. The bits are not
the TPU's (they cannot be: the TPU's generator is its own), so the port is
held to the JAX package with dropout off and to itself with dropout on.

The hash is MurmurHash3's 32-bit finalizer (`fmix32`), the same mixing the
serving engine's sampler uses:

    key(b, h)   = fmix32(fmix32(fmix32(seed ^ 0x9E3779B9) ^ b) ^ h)
    row(b,h,i)  = fmix32(key(b, h) ^ i)
    bits        = fmix32(row(b, h, i) + j * 0x9E3779B9)      (mod 2**32)
    keep        = bits >= threshold(p)

with threshold(p) = min(floor(p * 2**32), 2**32 - 1), the TPU kernel's
rule (:91-92). `ptt::dropout_row_key` / `ptt::dropout_keep` in
`csrc/common.cuh` compute the same in uint32 arithmetic; here it runs in
int64 tensors, multiplying in 16-bit halves so no product overflows.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["fmix32", "mul32", "threshold", "keep_mask", "GOLDEN", "M32"]

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9

IndexLike = Union[int, torch.Tensor]


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32), in 16-bit halves of c so
    no int64 product overflows."""
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer (a bijection of [0, 2**32))."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threshold(dropout_p: float) -> int:
    """The uint32 threshold: an element is kept iff its bits >= this."""
    return min(int(dropout_p * (2.0 ** 32)), 2 ** 32 - 1)


def _index(x: IndexLike, device) -> torch.Tensor:
    if isinstance(x, int):
        return torch.arange(x, dtype=torch.int64, device=device)
    return x.to(device=device, dtype=torch.int64)


def keep_mask(seed: torch.Tensor, batch: IndexLike, heads: IndexLike,
              rows: IndexLike, cols: IndexLike,
              dropout_p: float) -> torch.Tensor:
    """Bool keep mask of shape (len(batch), len(heads), len(rows),
    len(cols)). `seed` is a one-element integer tensor (its low 32 bits
    are used); each index argument is a count n (meaning 0..n-1) or a 1-D
    tensor of absolute indices, so a tile of the mask is computed from its
    own coordinates."""
    dev = seed.device
    s = seed.reshape(-1)[:1].to(torch.int64) & M32
    bi, hi, ri, ci = (_index(x, dev) for x in (batch, heads, rows, cols))
    k0 = fmix32(s ^ GOLDEN)                                   # (1,)
    key = fmix32(fmix32(k0 ^ bi)[:, None] ^ hi[None, :])      # (b, h)
    col_term = mul32(ci, GOLDEN)                              # (sk,)
    thresh = threshold(dropout_p)
    out = torch.empty((len(bi), len(hi), len(ri), len(ci)), dtype=torch.bool,
                      device=dev)
    for n in range(len(bi)):            # one batch element at a time
        row = fmix32(key[n][:, None] ^ ri[None, :])           # (h, sq)
        bits = fmix32((row[..., None] + col_term) & M32)
        out[n] = bits >= thresh
    return out
