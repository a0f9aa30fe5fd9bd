"""paddle.nn.utils for the port (counterpart of
paddle_tpu/nn/utils/__init__.py): `weight_norm` / `remove_weight_norm`,
`spectral_norm`, `parameters_to_vector`, `vector_to_parameters` and the
gradient clips.

Both reparametrizations are forward-pre-hooks: the effective weight is
recomputed from the registered parameters (and buffers) before every
forward and set as the layer's attribute, so torch autograd carries the
gradient to the new parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.tensor import Parameter, Tensor
from ..clip import clip_grad_norm_

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters",
           "clip_grad_norm_", "clip_grad_value_"]


def _like_param(src: Parameter, data: torch.Tensor) -> Parameter:
    """A new Parameter with `src`'s training attributes (trainable flag,
    learning rate scale, regularizer, clip), which the optimizers read."""
    p = Parameter(data.detach(), trainable=src.trainable,
                  place=data.device)
    p.optimize_attr = dict(src.optimize_attr)
    p.regularizer = src.regularizer
    p.need_clip = src.need_clip
    return p


def _row_norm(v: torch.Tensor, dim) -> torch.Tensor:
    """||v|| over every axis but `dim` (kept); over all with dim None."""
    if dim is None:
        axes = tuple(range(v.dim()))
    else:
        dim = dim % v.dim()
        axes = tuple(i for i in range(v.dim()) if i != dim)
    return torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))


def _weight_norm_value(layer, name, dim):
    v = layer._parameters[f"{name}_v"]
    return v * (layer._parameters[f"{name}_g"] / _row_norm(v, dim))


def _install(layer, name, value: torch.Tensor):
    object.__setattr__(layer, name, Tensor._wrap(value))


def weight_norm(layer, name: str = "weight", dim: int = 0):
    """Reparametrize `layer.<name>` as g * v / ||v||: the trainable
    `<name>_g` (the norms over every axis but `dim`; one scalar with dim
    None) and `<name>_v` (the direction) replace the parameter."""
    if f"{name}_g" in layer._parameters:
        raise ValueError(f"weight_norm already applied to {name!r}")
    w = getattr(layer, name)
    if not isinstance(w, Parameter):
        raise ValueError(f"{name!r} is not a Parameter of {type(layer)}")
    layer.add_parameter(f"{name}_g", _like_param(w, _row_norm(w._t, dim)))
    layer.add_parameter(f"{name}_v", _like_param(w, w._t))
    del layer._parameters[name]

    def recompute(lay, _inputs=None):
        _install(lay, name, _weight_norm_value(lay, name, dim))

    handle = layer.register_forward_pre_hook(recompute)
    recompute(layer)
    layer.__dict__.setdefault("_weight_norm_hooks", {})[name] = (handle,
                                                                  dim)
    return layer


def remove_weight_norm(layer, name: str = "weight"):
    """Fold g * v / ||v|| back into one parameter and drop the hook."""
    hooks = layer.__dict__.get("_weight_norm_hooks", {})
    if name not in hooks:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    handle, dim = hooks.pop(name)
    handle.remove()
    v = getattr(layer, f"{name}_v")
    eff = _weight_norm_value(layer, name, dim)
    del layer._parameters[f"{name}_g"], layer._parameters[f"{name}_v"]
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, _like_param(v, eff))
    return layer


def spectral_norm(layer, name: str = "weight", n_power_iterations: int = 1,
                  eps: float = 1e-12, dim: int = 0):
    """Divide `layer.<name>` by its largest singular value: sigma = u^T W v
    (W matricized with `dim` as rows), differentiable in W, with u / v
    buffers (seeded normal vectors) refreshed by power iteration on each
    training forward."""
    if f"{name}_orig" in layer._parameters:
        raise ValueError(f"spectral_norm already applied to {name!r}")
    w = getattr(layer, name)
    if not isinstance(w, Parameter):
        raise ValueError(f"{name!r} is not a Parameter of {type(layer)}")
    ndim = len(w.shape)
    dim = dim % ndim
    h = w.shape[dim]
    cols = int(np.prod([w.shape[i] for i in range(ndim) if i != dim])) \
        if ndim > 1 else 1
    rng = np.random.default_rng(0)
    for buf, n in ((f"{name}_u", h), (f"{name}_v", cols)):
        vec = rng.standard_normal(n).astype(np.float32)
        layer.register_buffer(buf, torch.from_numpy(
            vec / np.linalg.norm(vec)).to(w._t.device))
    layer.add_parameter(f"{name}_orig", _like_param(w, w._t))
    del layer._parameters[name]
    perm = [dim] + [i for i in range(ndim) if i != dim]

    def recompute(lay, _inputs=None):
        w_p = lay._parameters[f"{name}_orig"]
        mat = w_p.permute(perm).reshape(h, cols)
        u, v = lay._buffers[f"{name}_u"], lay._buffers[f"{name}_v"]
        if lay.training:
            with torch.no_grad():
                for _ in range(n_power_iterations):
                    vd = mat.t() @ u
                    v.copy_(vd / (torch.linalg.vector_norm(vd) + eps))
                    ud = mat @ v
                    u.copy_(ud / (torch.linalg.vector_norm(ud) + eps))
        sigma = (u.reshape(1, h) @ mat @ v.reshape(cols, 1)).reshape(1)
        _install(lay, name, w_p / sigma)

    handle = layer.register_forward_pre_hook(recompute)
    recompute(layer)
    layer.__dict__.setdefault("_spectral_norm_hooks", {})[name] = handle
    return layer


def parameters_to_vector(parameters) -> Tensor:
    """The parameters' values, flattened and concatenated (no gradient)."""
    return Tensor._wrap(torch.cat([p._t.detach().reshape(-1)
                                   for p in parameters]))


def vector_to_parameters(vec, parameters) -> None:
    """Copy consecutive slices of `vec` into the parameters, in place."""
    data = vec._t if isinstance(vec, Tensor) else torch.as_tensor(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p._t.numel()
            p._t.copy_(data[offset:offset + n].reshape(p._t.shape))
            offset += n


def clip_grad_value_(parameters, clip_value) -> None:
    """Clip every gradient to [-clip_value, clip_value], in place."""
    params = [parameters] if not isinstance(parameters, (list, tuple)) \
        else list(parameters)
    cv = float(clip_value)
    with torch.no_grad():
        for p in params:
            t = getattr(p, "_t", p)
            if t.grad is not None:
                t.grad.clamp_(-cv, cv)
