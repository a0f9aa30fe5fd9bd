"""paddle.vision for the port (counterpart of paddle_tpu/vision/):
`datasets`, `transforms`, `models` (the zoo, exported here too) and
`ops` (the detection ops)."""
from . import datasets, models, ops, transforms
from .models import *  # noqa: F401,F403
from .models import __all__ as _models

__all__ = ["datasets", "models", "ops", "transforms", "set_image_backend",
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

