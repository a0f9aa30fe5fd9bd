"""Conv1D / 2D / 3D and their Transpose forms (counterparts of
paddle_tpu/nn/layer/conv.py): paddle's (out, in / groups, *k) weight
((in, out / groups, *k) for the transposes), XavierNormal, a zero bias.
The functionals (`F.conv*d`, the op table's `nn_ops`) turn paddle's
string and asymmetric paddings into an explicit pad before the PyTorch
call; `padding_mode` is kept and, as in the reference, not applied."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


class _ConvNd(Layer):
    _N = 2                # spatial axes
    _FN = None            # the functional
    _FORMAT = "NCHW"      # the default data_format
    _TRANSPOSE = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 output_padding=0):
        super().__init__()
        n = self._N
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = _ntuple(stride, n)
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = _ntuple(dilation, n)
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        if self._TRANSPOSE:
            w_shape = [in_channels, out_channels // groups,
                       *self.kernel_size]
        else:
            w_shape = [out_channels, in_channels // groups,
                       *self.kernel_size]
        self.weight = self.create_parameter(
            shape=w_shape, attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True)

    def forward(self, x, output_size=None):
        kw = dict(stride=self.stride, padding=self.padding,
                  dilation=self.dilation, groups=self.groups,
                  data_format=self.data_format)
        if self._TRANSPOSE:
            kw["output_padding"] = self.output_padding
        return self._FN(x, self.weight, self.bias, **kw)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class _Conv(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr,
                         data_format or self._FORMAT)


class _ConvTranspose(_ConvNd):
    _TRANSPOSE = True

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format or self._FORMAT,
                         output_padding)


class Conv1D(_Conv):
    _N, _FN, _FORMAT = 1, staticmethod(F.conv1d), "NCL"


class Conv2D(_Conv):
    _N, _FN, _FORMAT = 2, staticmethod(F.conv2d), "NCHW"


class Conv3D(_Conv):
    _N, _FN, _FORMAT = 3, staticmethod(F.conv3d), "NCDHW"


class Conv1DTranspose(_ConvTranspose):
    _N, _FN, _FORMAT = 1, staticmethod(F.conv1d_transpose), "NCL"


class Conv2DTranspose(_ConvTranspose):
    _N, _FN, _FORMAT = 2, staticmethod(F.conv2d_transpose), "NCHW"


class Conv3DTranspose(_ConvTranspose):
    _N, _FN, _FORMAT = 3, staticmethod(F.conv3d_transpose), "NCDHW"
