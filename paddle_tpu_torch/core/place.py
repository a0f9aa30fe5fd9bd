"""Device identity ("Place"), the counterpart of paddle_tpu/core/place.py.

A Place names a torch device: `CPUPlace()` the host, `CUDAPlace(i)` card
i. `Tensor.place` returns one; creation ops take one (or a device string)
as `place=`. The default device is the port's (`device.get_device()`,
"cuda" unless `set_device("cpu")`); nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

from .. import device as _device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace",
           "place_of", "torch_device", "device_count"]


class Place:
    """Base device identity; equal by (kind, device_id)."""

    kind = "undefined"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self.kind, self._device_id))

    def __repr__(self):
        return (f"Place({self.kind})" if self.kind == "cpu"
                else f"Place({self.kind}:{self._device_id})")

    def is_cpu_place(self):
        return self.kind == "cpu"

    def is_gpu_place(self):
        return self.kind == "gpu"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    kind = "cpu"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    kind = "gpu"

    def torch_device(self) -> torch.device:
        return _device.resolve_device(f"cuda:{self._device_id}")


class CUDAPinnedPlace(CPUPlace):
    """Host memory (pinned on a CUDA host); tensors land on the CPU."""


def place_of(dev: torch.device) -> Place:
    """The Place of a torch device."""
    if dev.type == "cuda":
        return CUDAPlace(dev.index if dev.index is not None
                         else torch.cuda.current_device())
    return CPUPlace()


def torch_device(place=None) -> torch.device:
    """A Place, a device string ('cpu', 'gpu:0', 'cuda'), a torch.device or
    None (the default device) as a torch.device; CUDA without a card
    raises."""
    if isinstance(place, Place):
        return place.torch_device()
    return _device.resolve_device(place)


def device_count() -> int:
    return torch.cuda.device_count()
