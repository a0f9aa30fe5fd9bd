"""Automatic mixed precision under paddle's names (counterpart of
paddle_tpu/amp/__init__.py): `auto_cast` at levels O1 and O2, `decorate`,
and the dynamic-loss-scaling `GradScaler`.

The reference casts at op dispatch (`_amp_handler`, :49-70): an op on the
black list runs in fp32; under O2 every other op, and under O1 an op on
the white list, runs in the amp type (bf16); under O1 the rest follow
their inputs. An op is on a list by name (`NAME_WHITE_LIST` /
`NAME_BLACK_LIST`, :23-33, changed by `custom_white_list` /
`custom_black_list`) or by its own declaration, the `amp:` field of
paddle_tpu/ops/ops.yaml (never read at run time):

    white: linear (:2114), matmul (:1765), scaled_dot_product_attention
           (:2197), fused_linear_cross_entropy (:2126)
    black: layer_norm (:2062), rms_norm (:2068), cross_entropy (:2120)

The port's functional layer (`nn.torch_functional`) asks
`cast_inputs(op, ...)` before each of its ops: the listed ones above and
`embedding`, `gelu`, `relu`, `silu`, `tanh`, `dropout`, `mse_loss`, `add`
and `multiply`, which are on no list. So under O1 the residual stream and every norm stay fp32
while the products and attention run in bf16; under O2 (parameters made
bf16 by `decorate`, fp32 master weights in the optimizer) everything but
the black list runs in bf16, the norms take fp32 inputs, and the residual
adds of the models (`F.add`) round to bf16 as the reference's `add` does.
Gradients flow back through the casts.

The cast is the one of the reference's op dispatch (paddle_tpu/core/
dispatch.py:67-68), which casts EVERY float input of a listed op: for
`scaled_dot_product_attention` that includes a float attention mask. That
dispatch is what the JAX package runs on the CPU, in its tests and in the
port's parity tests. Its TPU flash path (`apply_callable`, dispatch.py:125)
casts nothing; the port follows the op dispatch.

`torch.autocast` is not used: it keys its own lists on aten ops (its fp32
list alone covers exp, log, pow, sum and more than the reference casts),
it does not see inside the port's custom autograd Functions, and it runs
on CUDA and CPU with different lists, so it would not give the reference's
cast on every op of the step. The casts here are the same on every device.

`GradScaler` keeps the reference's contract (unscale once and step once
between updates, the grow / back-off rule of `update`) but reads the
found-inf flag on the host once a step: `unscale_` divides every gradient
and checks it for inf / NaN on the device with multi-tensor calls
(`torch._amp_foreach_non_finite_check_and_unscale_` for fp32 / fp16
gradients; for bf16, which CUDA's fused check does not take, a
`_foreach_mul_` and each gradient's max |g|), and `step` reads the one
flag, where the reference syncs once a parameter (:209-230).
"""
from __future__ import annotations

import weakref
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["auto_cast", "autocast", "amp_guard", "cast_inputs", "decorate",
           "GradScaler", "is_auto_cast_enabled", "get_amp_dtype",
           "is_float16_supported", "is_bfloat16_supported",
           "WHITE_LIST", "BLACK_LIST", "NAME_WHITE_LIST", "NAME_BLACK_LIST"]

# the port's ops' own declarations (ops.yaml `amp:` fields)
WHITE_LIST = frozenset({"linear", "matmul", "scaled_dot_product_attention",
                        "fused_linear_cross_entropy"})
BLACK_LIST = frozenset({"layer_norm", "rms_norm", "cross_entropy"})
# the reference's name lists (amp/__init__.py:23-33)
NAME_WHITE_LIST = frozenset({
    "matmul", "mm", "bmm", "conv1d", "conv2d", "conv3d", "conv2d_transpose",
    "linear", "einsum", "addmm"})
NAME_BLACK_LIST = frozenset({
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "nll_loss", "cosine_similarity", "mean", "sum", "pow", "rsqrt",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "norm",
    "cumsum", "cumprod", "sigmoid_cross_entropy_with_logits", "erfinv",
    "kl_div"})

_STATE = {"enabled": False, "level": "O1", "dtype": torch.bfloat16,
          "white": NAME_WHITE_LIST, "black": NAME_BLACK_LIST}

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}


def _resolve_dtype(dtype) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"amp dtype must be bfloat16 or float16, got "
                         f"{dtype!r}")
    return _DTYPES[dtype]


class auto_cast:
    """Context manager enabling autocast (paddle.amp.auto_cast). O0 is off;
    O1 casts the white list to `dtype` and the black list to fp32; O2
    casts every op but the black list to `dtype`; OD acts as O1, as in the
    reference."""

    def __init__(self, enable: bool = True,
                 custom_white_list: Optional[Sequence[str]] = None,
                 custom_black_list: Optional[Sequence[str]] = None,
                 level: str = "O1", dtype: str = "bfloat16",
                 use_promote: bool = True):
        if level not in ("O0", "O1", "O2", "OD"):
            raise ValueError(f"level must be O0/OD/O1/O2, got {level!r}")
        self.enable = bool(enable) and level != "O0"
        self.level = level
        self.dtype = _resolve_dtype(dtype)
        white, black = set(NAME_WHITE_LIST), set(NAME_BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        self.white, self.black = frozenset(white), frozenset(black)
        self._saved = None

    def __enter__(self):
        self._saved = dict(_STATE)
        _STATE.update(enabled=self.enable, level=self.level,
                      dtype=self.dtype, white=self.white, black=self.black)
        return self

    def __exit__(self, *exc):
        _STATE.update(self._saved)
        return False


amp_guard = auto_cast  # the legacy name (paddle.fluid.dygraph.amp_guard)
autocast = auto_cast   # paddle 3.x's top-level alias


def is_auto_cast_enabled() -> bool:
    return _STATE["enabled"]


def get_amp_dtype() -> torch.dtype:
    return _STATE["dtype"] if _STATE["enabled"] else torch.float32


def _target(op: str, declared: Optional[str]) -> Optional[torch.dtype]:
    if op in _STATE["black"] or op in BLACK_LIST or declared == "black":
        return torch.float32
    if (_STATE["level"] == "O2" or op in _STATE["white"]
            or op in WHITE_LIST or declared == "white"):
        return _STATE["dtype"]
    return None


def cast_inputs(op: str, *tensors: Optional[torch.Tensor],
                amp_list: Optional[str] = None
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """`tensors` cast as the active policy casts op `op`'s inputs: floating
    tensors to the amp type or to fp32 (see the module docstring); None,
    integer tensors and ops the policy leaves alone pass through.
    `amp_list` is the op's own declaration ('white' / 'black', the ops.yaml
    `amp:` field) for the ops of the op table (`ops.registry`), which the
    Paddle Tensor surface dispatches."""
    if not _STATE["enabled"]:
        return tensors
    target = _target(op, amp_list)
    if target is None:
        return tensors
    return tuple(t.to(target) if t is not None and t.is_floating_point()
                 and t.dtype != target else t for t in tensors)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None):
    """paddle.amp.decorate: under O2, every floating parameter of the
    models is cast to the amp type in place, and each optimizer keeps fp32
    master weights (`multi_precision`) unless `master_weight=False`.
    Returns the models, or (models, optimizers) when optimizers are
    given."""
    if level not in ("O1", "O2"):
        raise ValueError("decorate level must be O1 or O2")
    target = _resolve_dtype(dtype)
    model_list = list(models) if isinstance(models, (list, tuple)) \
        else [models]
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point() and p.dtype != target:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models
    if level == "O2" and master_weight is not False:
        opt_list = list(optimizers) if isinstance(
            optimizers, (list, tuple)) else [optimizers]
        for opt in opt_list:
            if hasattr(opt, "_multi_precision"):
                opt._multi_precision = True
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (paddle.amp.GradScaler).

    `scale(loss)` multiplies by the scale; `unscale_(opt)` divides the
    gradients once and finds inf / NaN on the device; `step(opt)` reads
    that flag once and skips the update when it is set; `update()` backs
    the scale off by `decr_ratio` after `decr_every_n_nan_or_inf` bad
    steps (never below 1) and grows it by `incr_ratio` after
    `incr_every_n_steps` good ones."""

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # the optimizers unscaled / stepped since the last update (paddle's
        # INIT / UNSCALED / STEPPED states); each optimizer's own flag rides
        # on it as `_amp_found_inf` (a device tensor until step reads it)
        self._unscaled = weakref.WeakSet()
        self._stepped = weakref.WeakSet()

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._use_dynamic

    def scale(self, var: torch.Tensor) -> torch.Tensor:
        if not self._enable or self._scale == 1.0:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide the optimizer's gradients by the scale, in place, and set
        its device-side found-inf flag. No host read."""
        if not self._enable:
            return
        if optimizer in self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update()")
        groups = {}
        for p in optimizer._parameter_list:
            if p.grad is not None:
                groups.setdefault((p.grad.device, p.grad.dtype),
                                  []).append(p.grad)
        flags = []
        for (dev, dtype), grads in groups.items():
            found = torch.zeros(1, dtype=torch.float32, device=dev)
            if dtype in (torch.float32, torch.float16):
                inv = torch.full((1,), 1.0 / self._scale,
                                 dtype=torch.float32, device=dev)
                torch._amp_foreach_non_finite_check_and_unscale_(
                    grads, found, inv)
            else:
                # bf16 (CUDA's fused check takes fp32 / fp16 only): the
                # scale is a power of two, so the multiply is exact, and a
                # gradient's max |g| is inf or NaN exactly when one of its
                # elements is
                torch._foreach_mul_(grads, 1.0 / self._scale)
                peaks = torch.stack(torch._foreach_norm(
                    grads, float("inf"), dtype=torch.float32))
                found += (~torch.isfinite(peaks)).any().float()
            flags.append(found)
        optimizer._amp_found_inf = flags
        self._unscaled.add(optimizer)

    @staticmethod
    def _read(flags) -> bool:
        """The one host read of a step: any flag set."""
        if isinstance(flags, bool):
            return flags
        if not flags:
            return False
        total = flags[0] if len(flags) == 1 else sum(
            f.to(flags[0].device) for f in flags)
        return bool(total.item() > 0)

    def step(self, optimizer):
        if self._enable and optimizer in self._stepped:
            raise RuntimeError(
                "step() has already been called since the last update()")
        if self._enable and optimizer not in self._unscaled:
            self.unscale_(optimizer)
        found = self._read(getattr(optimizer, "_amp_found_inf", False))
        optimizer._amp_found_inf = found
        self._found_inf = self._found_inf or found
        if not found:
            optimizer.step()
        self._stepped.add(optimizer)

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        """Grow or back off the scale by this step's found-inf flags."""
        for opt in list(self._unscaled):
            if opt not in self._stepped:
                # unscaled but never stepped: its flag still counts
                self._found_inf = self._found_inf or self._read(
                    opt._amp_found_inf)
            opt._amp_found_inf = False
        self._unscaled = weakref.WeakSet()
        self._stepped = weakref.WeakSet()
        if not (self._enable and self._use_dynamic):
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, new_scale: float):
        self._scale = float(new_scale)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)


def is_float16_supported(device=None) -> bool:
    """fp16 computes on the card and (emulated) on the CPU."""
    return True


def is_bfloat16_supported(device=None) -> bool:
    """bf16 on the CPU, and on a card that has it (Ampere and later)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return torch.cuda.is_bf16_supported()
    return True
