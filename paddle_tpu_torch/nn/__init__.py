"""paddle.nn for the port: Paddle's `Layer` and layers over Paddle
Tensors (`nn.layer`), Paddle's functional namespace (`nn.functional`),
the initializers, the gradient clips and `nn.utils` (weight and spectral
norm, the parameter-vector helpers).

The torch-native building blocks the port's models, serving engine and
training steps are written on keep names of their own:
`nn.torch_functional` (functions over torch tensors, PyTorch's (out, in)
linear layout) and `nn.layers` (torch `nn.Module` RMSNorm, LayerNorm,
Linear and Dropout).
"""
from . import clip, functional, initializer, torch_functional, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layer_names

__all__ = ["clip", "functional", "initializer", "torch_functional", "utils",
           "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_"] + _layer_names
