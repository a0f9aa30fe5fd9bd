"""paddle.summary and paddle.flops for the port (counterpart of
paddle_tpu/hapi/summary.py): a forward of the network on a zero batch
(the given sizes, -1 / None as 1) in eval mode under no_grad, with a
forward hook on every leaf sublayer recording its output shape, its
parameter count and (flops) its operation count; the network's mode is
restored after. The reference traces abstractly (jax.eval_shape); the
port runs the forward once, on the network's own device."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ..core.tensor import Tensor

__all__ = ["summary", "flops"]


def _device(net):
    for p in net.parameters():
        return p._t.device
    return None


def _trace_with_hooks(net, make_hook, input_size=None, dtypes=None,
                      input=None):
    hooks = [sub.register_forward_post_hook(make_hook(name))
             for name, sub in net.named_sublayers()
             if not list(sub.children())]
    was_training = net.training
    try:
        if input is not None:
            args = [input] if isinstance(input, Tensor) else list(input)
        else:
            if input_size is None:
                raise ValueError("need input_size or input")
            one = all(s is None or isinstance(s, int) for s in input_size)
            sizes = [input_size] if one else list(input_size)
            dts = dtypes or ["float32"] * len(sizes)
            if isinstance(dts, str):
                dts = [dts] * len(sizes)
            args = [Tensor._wrap(torch.zeros(
                [1 if s is None or s == -1 else s for s in size],
                dtype=convert_dtype(dt), device=_device(net)))
                for size, dt in zip(sizes, dts)]
        net.eval()
        with torch.no_grad():
            net(*args)
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()


def _n_params(layer):
    return sum(int(np.prod(p.shape)) for p in layer.parameters(
        include_sublayers=False))


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a table of the leaf layers; returns {'total_params',
    'trainable_params'}."""
    rows = []

    def make_hook(name):
        def hook(layer, inputs, outputs):
            outs = outputs if isinstance(outputs, (list, tuple)) else \
                [outputs]
            shapes = [list(o.shape) for o in outs if isinstance(o, Tensor)]
            rows.append((name, type(layer).__name__, shapes,
                         _n_params(layer)))
        return hook

    _trace_with_hooks(net, make_hook, input_size, dtypes, input)
    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if not p.stop_gradient)
    w = max([len(r[0]) + len(r[1]) for r in rows] + [30]) + 8
    line = "-" * (w + 40)
    print(line)
    print(f"{'Layer (type)':<{w}}{'Output Shape':<24}{'Param #':>12}")
    print(line)
    for name, typ, shapes, n in rows:
        shape_s = str(shapes[0]) if len(shapes) == 1 else str(shapes)
        print(f"{name + ' (' + typ + ')':<{w}}{shape_s:<24}{n:>12,}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


def flops(net, input_size=None, inputs=None, custom_ops=None,
          print_detail=False, dtypes=None):
    """The network's operation count by leaf layer, the reference's
    conventions: a multiply-add is 2 for the products (a convolution's
    2 * Cin/g * prod(k) - 1, + 1 with a bias, an output element),
    normalizations 2 an element, pools and activations 1; `custom_ops`
    maps a layer class to fn(layer, input_shape, output_shape)."""
    from .. import nn

    custom_ops = custom_ops or {}
    rows = []

    def count(layer, in_shape, out_shape):
        for cls, fn in custom_ops.items():
            if isinstance(layer, cls):
                return int(fn(layer, in_shape, out_shape))
        out_el = int(np.prod(out_shape))
        in_el = int(np.prod(in_shape))
        has_bias = getattr(layer, "bias", None) is not None
        if isinstance(layer, (nn.Conv1D, nn.Conv2D, nn.Conv3D)):
            kernel_ops = int(np.prod(layer.weight.shape[1:]))
            return out_el * (2 * kernel_ops - 1 + int(has_bias))
        if isinstance(layer, nn.Conv2DTranspose):
            bias_ops = int(np.prod(out_shape[-2:])) if has_bias else 0
            return in_el * 2 * int(np.prod(layer.weight.shape[1:])) \
                + bias_ops
        if isinstance(layer, nn.Linear):
            return out_el * (2 * layer.weight.shape[0] - 1 + int(has_bias))
        if isinstance(layer, (nn.BatchNorm, nn.BatchNorm1D, nn.BatchNorm2D,
                              nn.BatchNorm3D, nn.LayerNorm, nn.GroupNorm)):
            return 2 * out_el
        if isinstance(layer, (nn.AvgPool2D, nn.MaxPool2D, nn.AvgPool1D,
                              nn.MaxPool1D, nn.AdaptiveAvgPool2D, nn.ReLU,
                              nn.ReLU6, nn.GELU, nn.Sigmoid, nn.Tanh,
                              nn.Hardswish, nn.Hardsigmoid, nn.Swish,
                              nn.SiLU, nn.LeakyReLU, nn.Softmax)):
            return out_el
        return 0

    def make_hook(name):
        def hook(layer, inputs_, outputs):
            ins = inputs_ if isinstance(inputs_, (list, tuple)) else \
                [inputs_]
            outs = outputs if isinstance(outputs, (list, tuple)) \
                else [outputs]
            in_shape = list(ins[0].shape) if ins and isinstance(
                ins[0], Tensor) else []
            out_shape = list(outs[0].shape) if outs and isinstance(
                outs[0], Tensor) else []
            rows.append((name, type(layer).__name__, out_shape,
                         _n_params(layer), count(layer, in_shape,
                                                 out_shape)))
        return hook

    _trace_with_hooks(net, make_hook, input_size, dtypes, inputs)
    total = sum(r[4] for r in rows)
    if print_detail:
        width = max((len(r[0]) for r in rows), default=10) + 2
        print(f"{'Layer':<{width}}{'Type':<18}{'Output':<20}"
              f"{'Params':>12}{'FLOPs':>16}")
        for name, tname, oshape, n_params, fl in rows:
            print(f"{name:<{width}}{tname:<18}{str(oshape):<20}"
                  f"{n_params:>12}{fl:>16}")
        print(f"Total FLOPs: {total}")
    return total
