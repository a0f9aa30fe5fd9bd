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
   row gather K9 (`ops.moe_dispatch`);

and later slices serving, generation and tensor parallelism (ROADMAP.md)
and the training plane: the optimizer family (`optimizer`, `optimizer.lr`,
`nn.clip`), amp O2 with the `GradScaler`, recompute
(`distributed.fleet.recompute`), ZeRO data parallelism (`parallel.zero`)
and its telemetry (`observability.training`); fleet hybrid parallelism
(`distributed.fleet`); and the rest of `distributed` (the launcher
`distributed.launch`, `DataParallel`, the resharding checkpoint,
`auto_parallel` and its `Engine`, the host services) with `io` and
`metric`.

The kernels are CUDA C++ (`csrc/`, built by `_build`) except K4 / K5,
which are Triton (`ops.norm`).

The package's names resolve at first use, so the host-only modules (the
launcher, TCPStore, rpc, elastic) start without importing torch.
"""
import importlib

__all__ = ["get_device", "resolve_device", "set_device"]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(".device", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
