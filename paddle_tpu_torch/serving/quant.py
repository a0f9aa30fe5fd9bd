"""Quantized serving: int8 / fp8 paged KV storage with per-slot scales,
and the block-scaled int8 all-reduce of tensor-parallel serving (port of
paddle_tpu/serving/quant.py).

K/V projections are quantized ONCE, at page-write time, with one fp32
scale per (token, kv head) taken over head_dim, and the scale lands in a
scale slab beside the data slab at the same (head, page, slot). Every
attention path dequantizes what it reads (q x scale), so decode, chunked
prefill and the ragged step all see the identical bytes. The bytes and
scales are the JAX package's: amax in fp32, scale = amax / qmax (1 where
amax is 0, so unwritten slots read exact zeros), x / scale clipped to
+-qmax, then round-half-to-even for int8 or a cast to float8_e4m3fn.

The quantized all-reduce (`quantized_allreduce`, the reference's
`quantized_psum`) replaces the row-parallel sum of a tensor-parallel
engine built with `tp_quantized_allreduce=True`: each shard splits its
partial (..., hidden) into 256-wide blocks along hidden, quantizes each
block to int8 against its own fp32 abs-max scale (`block_quantize`), and
every device of the group dequantizes the shards' blocks and sums them in
shard order 0..n-1 (`block_dequant_sum`), so every shard holds the same
bits. A payload moves as ~1 byte an element (+ 4 bytes of scale a block)
instead of 4 or 2. Rows quantize independently, so quantizing a chunk of
rows gives the rows of the whole quantization (serving/overlap.py moves
chunks).

This module is imported only by quantized pools (kv_dtype "int8" /
"fp8") and by tensor-parallel engines with the quantized all-reduce: an
fp32 or bf16 engine without it never loads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["KVQuantSpec", "SCALE_DTYPE", "resolve_kv_dtype",
           "quantize_tokens", "dequantize", "kv_pool_bytes",
           "measure_roundtrip_error", "block_quantize", "block_dequant_sum",
           "quantized_allreduce"]

# one fp32 scale per (kv head, page, slot), in a (kvh, P, ps, 1) slab
SCALE_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """A quantized KV storage format."""

    name: str                      # "int8" | "fp8"
    storage_dtype: torch.dtype     # the data slabs' type
    qmax: float                    # largest magnitude after scaling

    @property
    def storage_itemsize(self) -> int:
        return torch.empty((), dtype=self.storage_dtype).element_size()


def resolve_kv_dtype(kv_dtype: str,
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> KVQuantSpec:
    """Validate a quantized `kv_dtype` name ("int8" or "fp8") and, when
    given, the model's compute type (fp32 or bf16)."""
    if kv_dtype == "int8":
        spec = KVQuantSpec("int8", torch.int8, 127.0)
    elif kv_dtype == "fp8":
        spec = KVQuantSpec("fp8", torch.float8_e4m3fn, 448.0)
    else:
        raise ValueError(f"unsupported quantized kv_dtype {kv_dtype!r}: "
                         "expected 'int8' or 'fp8'")
    if compute_dtype is not None and compute_dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise ValueError(f"kv_dtype={kv_dtype!r} requires a float32/bfloat16 "
                         f"compute dtype, got {compute_dtype}")
    return spec


def quantize_tokens(x: torch.Tensor, spec: KVQuantSpec
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., head_dim) -> (q of spec.storage_dtype, fp32 scale (..., 1)),
    one scale per leading index."""
    xf = x.to(SCALE_DTYPE)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / spec.qmax, torch.ones_like(amax))
    q = (xf / scale).clamp(-spec.qmax, spec.qmax)
    if spec.storage_dtype == torch.int8:
        q = torch.round(q)         # half to even, as jnp.round
    return q.to(spec.storage_dtype), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of `quantize_tokens`: q (..., head_dim) times its fp32
    scale, in fp32."""
    return q.to(SCALE_DTYPE) * scale


def block_quantize(x: torch.Tensor, block: int = 256
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard-local half of the quantized all-reduce: x (..., hidden)
    zero-padded to a multiple of `block`, split into block-wide pieces
    along hidden, each quantized against its own abs-max. Returns (q int8
    (..., nblocks, block), scale fp32 (..., nblocks, 1)); an all-zero
    block takes scale 1."""
    h = x.shape[-1]
    nblocks = -(-h // block)
    xp = x.to(torch.float32)
    if nblocks * block != h:
        xp = torch.nn.functional.pad(xp, (0, nblocks * block - h))
    xb = xp.reshape(*x.shape[:-1], nblocks, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round((xb / scale).clamp(-127.0, 127.0)).to(torch.int8)
    return q, scale


def block_dequant_sum(qs, scales, h: int, out_dtype) -> torch.Tensor:
    """The replicated half: the shards' int8 blocks `qs` and scales
    `scales` (sequences in shard order, all on one device) dequantized in
    fp32 and summed in shard order 0..n-1, unpadded to `h` and cast to
    `out_dtype`."""
    out = qs[0].to(torch.float32) * scales[0]
    for q, s in zip(qs[1:], scales[1:]):
        out = out + q.to(torch.float32) * s
    out = out.reshape(*out.shape[:-2], -1)
    return out[..., :h].to(out_dtype)


def quantized_allreduce(partials, targets, block: int = 256):
    """Block-scaled int8 all-reduce of one partial per shard (each on its
    shard's device): each shard quantizes its own partial, and each
    distinct device of `targets` dequantizes and sums all of them in
    shard order. Returns device -> result (in the partials' dtype), the
    same bits on every device."""
    from ..parallel.mesh import distinct

    packed = [block_quantize(p, block) for p in partials]
    h, dt = partials[0].shape[-1], partials[0].dtype
    return {dev: block_dequant_sum(
        [q.to(dev, non_blocking=True) for q, _ in packed],
        [s.to(dev, non_blocking=True) for _, s in packed], h, dt)
        for dev in distinct(targets)}


def kv_pool_bytes(num_layers: int, num_pages: int, page_size: int,
                  num_kv_heads: int, head_dim: int, *, itemsize: int,
                  quantized: bool) -> int:
    """Bytes of a K + V pool set: data slabs plus, when quantized, the
    scale slabs."""
    slots = num_layers * num_pages * page_size * num_kv_heads
    data = 2 * slots * head_dim * itemsize
    return data + (2 * slots * 4 if quantized else 0)


def measure_roundtrip_error(spec: KVQuantSpec, head_dim: int,
                            samples: int = 512, seed: int = 0) -> float:
    """Quantize -> dequantize RMS relative error on gaussian data, once at
    engine construction (on the host; the hot path keeps no originals)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(samples, head_dim).astype(np.float32))
    q, scale = quantize_tokens(x, spec)
    err = dequantize(q, scale) - x
    num = err.pow(2).mean().sqrt()
    den = x.pow(2).mean().sqrt() + 1e-12
    return float(num / den)
