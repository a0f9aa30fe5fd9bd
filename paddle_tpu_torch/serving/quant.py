"""Quantized KV pools: int8 / fp8 paged KV storage with per-slot scales
(port of the KV half of paddle_tpu/serving/quant.py:42-111, 173-198).

K/V projections are quantized ONCE, at page-write time, with one fp32
scale per (token, kv head) taken over head_dim, and the scale lands in a
scale slab beside the data slab at the same (head, page, slot). Every
attention path dequantizes what it reads (q x scale), so decode, chunked
prefill and the ragged step all see the identical bytes. The bytes and
scales are the JAX package's: amax in fp32, scale = amax / qmax (1 where
amax is 0, so unwritten slots read exact zeros), x / scale clipped to
+-qmax, then round-half-to-even for int8 or a cast to float8_e4m3fn.

The block-scaled all-reduce of the reference (`block_quantize`,
`quantized_psum`) belongs to tensor-parallel serving and is not ported.

This module is imported only by quantized pools (kv_dtype "int8" /
"fp8"): an fp32 or bf16 engine never loads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["KVQuantSpec", "SCALE_DTYPE", "resolve_kv_dtype",
           "quantize_tokens", "dequantize", "kv_pool_bytes",
           "measure_roundtrip_error"]

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
