"""paddle.framework for the port (counterpart of
paddle_tpu/framework/__init__.py): `save` / `load`, and the dtype and
seed helpers."""
from ..core import get_default_dtype, set_default_dtype
from ..core.rng import seed
from .io import load, save

__all__ = ["save", "load", "get_default_dtype", "set_default_dtype", "seed"]
