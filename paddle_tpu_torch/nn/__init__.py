"""nn surface of the port: layers, the functional namespace and the
gradient clips."""
from . import clip, functional
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layers import Dropout, LayerNorm, Linear, RMSNorm

__all__ = ["clip", "functional", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "Dropout", "LayerNorm",
           "Linear", "RMSNorm"]
