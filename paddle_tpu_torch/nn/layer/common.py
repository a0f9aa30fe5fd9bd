"""The common layers (counterparts of paddle_tpu/nn/layer/common.py), in
paddle's layouts: Linear's weight is (in, out), XavierNormal;
Embedding's is Normal(0, 1) with the padding row zeroed at init;
Bilinear's is (out, in1, in2) with a (1, out) bias. The dropouts, pads,
resizers, shuffles and fold / unfold are thin layers over their
functionals."""
from __future__ import annotations

import torch

from ... import amp
from ...core.tensor import Tensor
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Identity", "Linear", "Embedding", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout", "Flatten", "Unflatten", "Pad1D",
           "Pad2D", "Pad3D", "ZeroPad1D", "ZeroPad2D", "ZeroPad3D",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Bilinear",
           "CosineSimilarity", "Fold", "Unfold"]


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        if padding_idx is not None and padding_idx < 0:
            padding_idx = num_embeddings + padding_idx
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight._t[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__(p, data_format)

    def forward(self, x):
        return F.dropout3d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)


class Unflatten(Layer):
    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = list(shape)

    def forward(self, x):
        return x.reshape(x.shape[:self.axis] + self.shape
                         + x.shape[self.axis + 1:])


class _Pad(Layer):
    _N = 1

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format=None, name=None):
        super().__init__()
        self.padding = list(padding) if isinstance(padding, (list, tuple)) \
            else [padding] * (2 * self._N)
        self.mode = mode
        self.value = value
        self.data_format = data_format or self._FORMAT

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_Pad):
    _N, _FORMAT = 1, "NCL"


class Pad2D(_Pad):
    _N, _FORMAT = 2, "NCHW"


class Pad3D(_Pad):
    _N, _FORMAT = 3, "NCDHW"


class ZeroPad1D(Pad1D):
    def __init__(self, padding, data_format="NCL", name=None):
        super().__init__(padding, data_format=data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, data_format=data_format)


class ZeroPad3D(Pad3D):
    def __init__(self, padding, data_format="NCDHW", name=None):
        super().__init__(padding, data_format=data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, size=self.size,
                             scale_factor=self.scale_factor, mode=self.mode,
                             align_corners=self.align_corners,
                             data_format=self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, mode="bilinear",
                         align_corners=True, data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, mode="nearest",
                         data_format=data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor,
                                 self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """out[b, o] = x1[b] @ weight[o] @ x2[b] + bias[0, o]."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features],
            attr=weight_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        a, w, b = amp.cast_inputs("einsum", x1._t, self.weight._t, x2._t)
        out = Tensor._wrap(torch.einsum("bi,oij,bj->bo", a, w, b))
        return out if self.bias is None else out + self.bias


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes, self.kernel_sizes = output_sizes, kernel_sizes
        self.strides, self.paddings, self.dilations = (strides, paddings,
                                                       dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes = kernel_sizes
        self.strides, self.paddings, self.dilations = (strides, paddings,
                                                       dilations)

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)
