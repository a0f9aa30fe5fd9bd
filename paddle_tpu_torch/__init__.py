"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays the reference; this package imports
`torch` and never `jax` or anything of `paddle_tpu`. Its entry points run
on the card ("cuda") unless the caller passes device="cpu", where every
hand-written kernel gives way to its plain PyTorch version.

What is ported, slice by slice:

1. LLaMA served through the paged-KV `serving.ServingEngine`, with
   flash-attention forward (K1), fused RMSNorm (K4) and paged decode (K6);
2. the ERNIE-1.0 pretrain step (`models.ernie`, `training.make_train_step`,
   `optimizer.Adam`, `amp.auto_cast` O1), adding attention dropout to K1,
   the flash backward (K2, K3) and LayerNorm forward and backward (K4, K5);
3. chunked prefill, the ragged mixed step and int8 / fp8 KV pools in the
   serving engine, through ragged paged attention (K7) and dequantizing
   paged decode (K6q);
4. the T5 pretraining step (`models.t5`,
   `training.make_seq2seq_train_step`), with K2's gradient of a trainable
   attention mask;
5. the MoE layer's train step (`incubate.distributed.models.moe`,
   `training.make_moe_train_step`), its dispatch and combine through the
   row gather K9 (`ops.moe_dispatch`).

The kernels are CUDA C++ (`csrc/`, built by `_build`) except K4 / K5,
which are Triton (`ops.norm`).
"""
from .device import get_device, resolve_device, set_device

__all__ = ["get_device", "resolve_device", "set_device"]
