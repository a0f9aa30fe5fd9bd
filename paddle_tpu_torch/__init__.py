"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays the reference; this package imports
`torch` and never `jax` or anything of `paddle_tpu`. Its entry points run
on the card ("cuda") unless the caller passes device="cpu", where every
hand-written kernel gives way to its plain PyTorch version.

What is ported so far: LLaMA served through the paged-KV ServingEngine
(slice 1), and the ERNIE-1.0 pretrain step (`models.ernie`, `training`,
`optimizer.Adam`, `amp.auto_cast` O1; slice 2), with hand-written kernels
for flash-attention forward with dropout and its two backward kernels
(`ops.flash_attention`, CUDA), fused RMSNorm/LayerNorm forward and
backward (`ops.norm`, Triton) and paged decode attention
(`serving.attention.paged_decode_attention`, CUDA).
"""
from .device import get_device, resolve_device, set_device

__all__ = ["get_device", "resolve_device", "set_device"]
