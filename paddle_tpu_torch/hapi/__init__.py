"""paddle.hapi for the port (counterpart of paddle_tpu/hapi/): `Model`
(fit / evaluate / predict over an eager step), the callbacks, `summary`
and `flops`."""
from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["callbacks", "Model", "summary", "flops"]
