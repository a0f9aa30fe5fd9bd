"""nn.Layer for the port: paddle's module base over `torch.nn.Module`
(counterpart of paddle_tpu/nn/layer/layers.py:89-388, with `ParamAttr`
and `make_parameter`).

A Layer is a torch Module, so its parameters and buffers are registered
torch tensors: `.to(device)`, `copy.deepcopy`, torch's own state dict and
the port's optimizers see them as they see any Module's. The paddle
surface sits on top: `create_parameter` makes a paddle `Parameter` (whose
torch tensor, a `ParamBase`, is what gets registered), attribute access
returns the paddle wrapper of a parameter or buffer (one wrapper a
tensor, so `layer.weight is layer.weight`), and `parameters()`,
`named_parameters()`, `buffers()`, `state_dict()` and the hooks take and
give paddle objects with paddle's signatures. `set_state_dict` copies
Tensors, torch tensors or numpy arrays in place, name by name.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.place import torch_device
from ...core.tensor import Parameter, Tensor, wrap_state
from .. import initializer as I

__all__ = ["Layer", "ParamAttr", "make_parameter"]


class ParamAttr:
    """paddle.ParamAttr."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot convert {attr!r} to ParamAttr")


def make_parameter(shape, attr=None, dtype=None, is_bias=False,
                   default_initializer=None, name=None, place=None):
    """The one implementation behind Layer.create_parameter and
    paddle.create_parameter: the initializer is the attr's, else the
    explicit default, else the global one, else Constant(0) for a bias and
    XavierNormal for a weight. The parameter lands on `place` (default:
    the port's default device)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    dtype = convert_dtype(dtype) or get_default_dtype()
    init = attr.initializer or default_initializer
    if init is None:
        init = I.global_bias_init() if is_bias else I.global_weight_init()
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    data = init([int(s) for s in shape], dtype, torch_device(place))
    p = Parameter(data, name=name or attr.name or "",
                  trainable=attr.trainable)
    p.optimize_attr["learning_rate"] = attr.learning_rate
    p.regularizer = attr.regularizer
    p.need_clip = attr.need_clip
    return p


_LAYER_COUNTER = collections.defaultdict(int)


class Layer(torch.nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        cls = type(self).__name__.lower()
        _LAYER_COUNTER[cls] += 1
        self._full_name = name_scope or f"{cls}_{_LAYER_COUNTER[cls] - 1}"
        self._dtype = convert_dtype(dtype) or get_default_dtype()

    # ------------------------------------------------------------ params
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        return make_parameter(shape, attr=attr,
                              dtype=convert_dtype(dtype) or self._dtype,
                              is_bias=is_bias,
                              default_initializer=default_initializer)

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        setattr(self, name, parameter)
        return parameter

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        keep = persistable if persistent is None else persistent
        t = tensor._t if isinstance(tensor, Tensor) else tensor
        super().register_buffer(name, t, persistent=keep)
        return tensor

    def add_sublayer(self, name: str, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    # --------------------------------------------------------- attributes
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            if not value.name:
                value.name = f"{self._full_name}.{name}"
            self.__dict__.pop(name, None)
            self.register_parameter(name, value._t)
            value._t._paddle = value
        elif isinstance(value, Tensor) and name in self.__dict__.get(
                "_buffers", ()):
            self._buffers[name] = value._t
        else:
            super().__setattr__(name, value)
        if name in _SHADOWED:
            # a torch Module method paddle's Layer does not have (`type`,
            # `cuda`, `double`, ...): the instance attribute hides it, as a
            # paddle sublayer or parameter of that name must
            if isinstance(value, (Tensor, torch.nn.Module)):
                object.__setattr__(self, name, value)
            else:
                self.__dict__.pop(name, None)

    def __delattr__(self, name):
        super().__delattr__(name)
        if name in _SHADOWED:
            self.__dict__.pop(name, None)

    def __getattr__(self, name):
        d = self.__dict__
        for table in ("_parameters", "_buffers"):
            entries = d.get(table)
            if entries is not None and name in entries:
                t = entries[name]
                return None if t is None else wrap_state(t)
        return super().__getattr__(name)

    # ---------------------------------------------------------- iteration
    def sublayers(self, include_self=False) -> List["Layer"]:
        return [m for _, m in self.named_sublayers(
            include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def parameters(self, include_sublayers=True, recurse=None
                   ) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True
                         ) -> Iterator[Tuple[str, Parameter]]:
        rec = include_sublayers if recurse is None else recurse
        for name, p in super().named_parameters(
                prefix=prefix, recurse=rec,
                remove_duplicate=remove_duplicate):
            yield name, wrap_state(p)

    def buffers(self, include_sublayers=True, recurse=None) -> List[Tensor]:
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        rec = include_sublayers if recurse is None else recurse
        for name, b in super().named_buffers(
                prefix=prefix, recurse=rec,
                remove_duplicate=remove_duplicate):
            yield name, wrap_state(b)

    # ------------------------------------------------------- modes, etc
    def full_name(self):
        return self._full_name

    def to(self, device=None, dtype=None, blocking=None):
        kw = {}
        if device is not None:
            kw["device"] = torch_device(device)
        if dtype is not None:
            kw["dtype"] = self._dtype = convert_dtype(dtype)
        return super().to(**kw) if kw else self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def clear_gradients(self, set_to_zero=False):
        for p in self.parameters():
            p.clear_grad(set_to_zero)

    # ---------------------------------------------------------- state
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, **torch_kw):
        """{structured name: Parameter / Tensor} of the parameters and
        persistable buffers, sharing their storage, each tensor once. (Called by torch's own
        recursion with `prefix=` / `keep_vars=`, it is torch's.)"""
        if torch_kw:
            return super().state_dict(destination=destination, **torch_kw)
        own = super().state_dict(prefix=structured_name_prefix,
                                 keep_vars=True)
        out = destination if destination is not None else \
            collections.OrderedDict()
        # the parameters first, then the buffers, as the reference's; a
        # tensor shared by two sublayers under its first name only
        seen = set()
        for params in (True, False):
            for name, t in own.items():
                if isinstance(t, torch.nn.Parameter) == params and (
                        include_sublayers or "." not in name[
                            len(structured_name_prefix):]) and (
                        id(t) not in seen):
                    seen.add(id(t))
                    out[name] = wrap_state(t)
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each entry (a Tensor, a torch tensor or anything numpy
        takes) into the parameter or buffer of its name, in place; returns
        (missing, unexpected) names."""
        own = self.state_dict()
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                target = own[k]._t
                if isinstance(v, Tensor):
                    src = v._t
                elif isinstance(v, torch.Tensor):
                    src = v
                else:
                    arr = np.asarray(v)
                    if arr.dtype.name == "bfloat16":
                        arr = arr.astype(np.float32)
                    src = torch.from_numpy(np.ascontiguousarray(arr))
                target.copy_(src.reshape(target.shape))
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # --------------------------------------------------------- forward
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def register_forward_pre_hook(self, hook):
        """hook(layer, inputs) -> None or new inputs; returns a handle
        with remove()."""
        return super().register_forward_pre_hook(hook)

    def register_forward_post_hook(self, hook):
        """hook(layer, inputs, outputs) -> None or new outputs."""
        return super().register_forward_hook(hook)


# torch Module methods a paddle Layer does not define: a sublayer,
# parameter or buffer may take one of these names
_SHADOWED = frozenset(
    n for n, v in vars(torch.nn.Module).items()
    if callable(v) and not n.startswith("_")) - set(vars(Layer)) - {
        "train", "eval", "apply", "children", "named_children", "float",
        "half", "bfloat16", "forward", "extra_repr"}
