"""nn surface of the port: layers and the functional namespace."""
from . import functional
from .layers import Dropout, LayerNorm, Linear, RMSNorm

__all__ = ["functional", "Dropout", "LayerNorm", "Linear", "RMSNorm"]
