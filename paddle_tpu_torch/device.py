"""Device selection for the PyTorch port (counterpart of
`paddle_tpu/core/place.py:94-147`).

The default device is ``"cuda"``: every entry point of the port (model
construction, the serving engine, the kernel wrappers' callers) runs on
the card unless the caller asks for the CPU. Asking for CUDA on a machine
without one raises; nothing falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["set_device", "get_device", "resolve_device", "same_device"]

_DEFAULT = ["cuda"]

DeviceLike = Union[str, torch.device, None]


def set_device(device: DeviceLike) -> torch.device:
    """Set the process default device ('cuda', 'cuda:1', 'cpu'; 'gpu' is
    an alias of 'cuda'). Validates it as `resolve_device` does."""
    dev = resolve_device(device if device is not None else "cuda")
    _DEFAULT[0] = str(dev)
    return dev


def get_device() -> str:
    """The default device name, 'cuda' unless `set_device` changed it."""
    return _DEFAULT[0]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device`, or the default when None, as a torch.device. Raises
    RuntimeError when CUDA is asked for and this process has no CUDA
    device (pass device='cpu' to run the port's plain versions)."""
    if device is None:
        device = _DEFAULT[0]
    if isinstance(device, str):
        name, sep, idx = device.partition(":")
        if name.lower() == "gpu":
            device = "cuda" + sep + idx
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """True when `a` and `b` name the same device ('cuda' matches the
    current CUDA device's index)."""
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib
