"""nn surface of the port: layers and the functional namespace."""
from . import functional
from .layers import RMSNorm

__all__ = ["functional", "RMSNorm"]
