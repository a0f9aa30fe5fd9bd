"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays the reference; this package imports
`torch` and never `jax` or anything of `paddle_tpu`. Its entry points run
on the card ("cuda") unless the caller asks for the CPU
(`paddle.set_device("cpu")`, or device="cpu"), where every hand-written
kernel gives way to its plain PyTorch version.

`import paddle_tpu_torch as paddle` runs a Paddle dygraph script:
`paddle.to_tensor`, the `paddle.*` ops and the Tensor methods and
operators (`core`, `ops`, `tensor`), `backward` / `paddle.grad` /
`paddle.no_grad` over torch autograd, `paddle.nn` (Layer, the common,
norm, activation, loss and transformer layers, `nn.functional`,
`nn.initializer`, `nn.utils`), `paddle.optimizer`, `paddle.amp`,
`paddle.seed`, `paddle.save` / `paddle.load` (`framework`), hapi's
`paddle.Model`, `paddle.summary` and `paddle.flops` (`hapi`) and
`paddle.vision` (transforms, datasets, LeNet and the ResNets).

What is ported, slice by slice (ROADMAP.md):

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

and later slices serving, generation and tensor parallelism and the
training plane: the optimizer family (`optimizer`, `optimizer.lr`,
`nn.clip`), amp O2 with the `GradScaler`, recompute
(`distributed.fleet.recompute`), ZeRO data parallelism (`parallel.zero`)
and its telemetry (`observability.training`); fleet hybrid parallelism
(`distributed.fleet`); the rest of `distributed` (the launcher
`distributed.launch`, `DataParallel`, the resharding checkpoint,
`auto_parallel` and its `Engine`, the host services) with `io` and
`metric`; the Paddle dygraph surface above; and `nn` in full (the
convolutions, pools, norms, losses and recurrent layers over the op
table's nn ops), `framework`, `hapi` and `vision`.

The kernels are CUDA C++ (`csrc/`, built by `_build`) except K4 / K5,
which are Triton (`ops.norm`).

The package's names resolve at first use, so the host-only modules (the
launcher, TCPStore, rpc, elastic) start without importing torch. A name
not in the tables below is looked up in the op namespace (`tensor`:
`paddle.add`, `paddle.matmul`, `paddle.to_tensor`, ...).
"""
import importlib

_SUBMODULES = ("amp", "autograd", "core", "device", "distributed",
               "framework", "hapi", "incubate", "io", "metric", "models",
               "nn", "observability", "ops", "optimizer", "parallel",
               "profiler", "serving", "tensor", "training", "vision",
               "weights")

_NAMES = {
    "amp": ("autocast",),
    "core": ("bfloat16", "bool_", "complex64", "complex128", "finfo",
             "float16", "float32", "float64", "get_default_dtype", "iinfo",
             "int8", "int16", "int32", "int64", "set_default_dtype",
             "uint8", "get_flags", "set_flags", "CPUPlace",
             "CUDAPinnedPlace", "CUDAPlace", "Place", "device_count",
             "Generator", "get_rng_state", "seed", "set_rng_state",
             "enable_grad", "grad", "is_grad_enabled", "no_grad",
             "set_grad_enabled", "Parameter", "Tensor", "create_parameter",
             "get_cuda_rng_state", "set_cuda_rng_state", "LazyGuard",
             "disable_signal_handler"),
    "device": ("get_device", "resolve_device", "set_device"),
    "distributed": ("DataParallel",),
    "framework": ("save", "load"),
    "hapi": ("Model", "summary", "flops"),
    "nn": ("ParamAttr",),
}
_HOME = {name: mod for mod, names in _NAMES.items() for name in names}

__all__ = sorted(_HOME) + list(_SUBMODULES)


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    if name in _HOME:
        value = getattr(importlib.import_module(f".{_HOME[name]}",
                                                __name__), name)
    elif name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    else:
        ops = importlib.import_module(".tensor", __name__)
        if name not in ops.__all__:
            raise AttributeError(f"module {__name__!r} has no attribute "
                                 f"{name!r}")
        value = getattr(ops, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_HOME) | set(_SUBMODULES))
