"""paddle.vision for the port (counterpart of paddle_tpu/vision/):
`datasets`, `transforms` and `models` (LeNet and the ResNets, exported
here too). The detection ops (`vision.ops`) are ROADMAP queue 1 item 6b2
and raise NotImplementedError, as do the other zoo models."""
from . import datasets, models, transforms
from .models import *  # noqa: F401,F403
from .models import LATER as _LATER
from .models import __all__ as _models

__all__ = ["datasets", "models", "transforms", "set_image_backend",
           "get_image_backend", "image_load"] + _models

_image_backend = ["numpy"]


def set_image_backend(backend: str):
    if backend not in ("pil", "cv2", "numpy", "tensor"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _image_backend[0] = backend


def get_image_backend() -> str:
    return _image_backend[0]


def image_load(path, backend=None):
    from .datasets import _default_loader

    return _default_loader(path)


def __getattr__(name):
    if name == "ops" or name in _LATER:
        raise NotImplementedError(
            f"paddle.vision.{name} is ROADMAP queue 1 item 6b2")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
