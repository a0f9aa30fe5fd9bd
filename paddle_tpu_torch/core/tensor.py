"""The Paddle Tensor of the port: a paddle-shaped handle over one torch
tensor (counterpart of paddle_tpu/core/tensor.py:39, which wraps a jax
array in `_data`).

It wraps rather than subclasses `torch.Tensor`, because paddle's methods
collide with torch's by name and differ in meaning: `transpose(perm)`
takes a whole permutation, `split(n)` makes n sections, `gather` is
`index_select`, `max(axis)` returns values only, `shape` is a list and
`stop_gradient` is the inverse of `requires_grad`. A subclass would hand
those methods to torch's own Python code and to the port's kernels, which
call `.transpose(1, 2)` and `.split(sizes)`. So torch code never sees a
paddle-semantics method: every op unwraps its inputs, runs torch code and
wraps the result (`core.dispatch.apply_op`).

Autograd is torch's: `stop_gradient=False` is `requires_grad`, `backward`
and `.grad` are torch's (`.grad` wrapped), and a leaf accumulates across
backward calls as in the reference.

In-place ops follow the reference's `_inplace_from` (:230): where torch
autograd must see the op (the tensor or an operand needs grad and grad
mode is on) the Tensor takes the op's result as its new value, so a leaf
that needs grad becomes a non-leaf as in the reference; otherwise the
result is written into the tensor's own storage, so a Parameter updated
under `no_grad` (an initializer, `set_value`) stays the registered
parameter of its Layer. `zero_`, `fill_`, `set_value`, `copy_` and the
random fills always write the storage, as the reference's rebinding of
`_data` never touches the graph.

`Parameter` wraps a `ParamBase`, a `torch.nn.Parameter` that carries
paddle's parameter attributes (`trainable`, `optimize_attr`,
`regularizer`, `need_clip`, and the name as `paddle_name`) in its own
attributes, so a Layer's
`.to(device)`, `state_dict` and `copy.deepcopy` keep the wrapper's
storage and attributes together, and the port's optimizers read them
from the torch parameter.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import tape
from .dispatch import apply_op, unwrap
from .dtype import convert_dtype, dtype_name, get_default_dtype
from .place import place_of, torch_device
from ..ops.registry import OPS, _load, get_op

__all__ = ["Tensor", "Parameter", "ParamBase", "to_torch", "wrap_state"]


def to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """`data` (a Tensor, a torch tensor, a numpy array, a scalar or nested
    lists) as a torch tensor on `place` (default: the port's default
    device). Python and numpy float64 data take the default dtype, as in
    the reference; integers stay int64."""
    dt = convert_dtype(dtype)
    if isinstance(data, Tensor):
        t = data._t.detach()
    elif isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        arr = np.asarray(data)
        if arr.dtype == object:
            arr = np.asarray([np.asarray(unwrap(x).detach().cpu())
                              if isinstance(x, (Tensor, torch.Tensor))
                              else x for x in data])
        if dt is None:
            if arr.dtype == np.float64:
                dt = get_default_dtype()
            elif arr.dtype == np.complex128:
                dt = torch.complex64
        t = torch.tensor(arr)
    dev = torch_device(place) if place is not None else (
        t.device if isinstance(data, (Tensor, torch.Tensor))
        else torch_device(None))
    if dt is not None and t.dtype != dt:
        t = t.to(dtype=dt)
    if t.device != dev:
        t = t.to(dev)
    return t


def _unwrap_index(item, device):
    if isinstance(item, Tensor):
        t = item._t
        return t if t.dtype == torch.bool else t.long()
    if isinstance(item, np.ndarray):
        t = torch.as_tensor(item, device=device)
        return t if t.dtype == torch.bool else t.long()
    if isinstance(item, tuple):
        return tuple(_unwrap_index(i, device) for i in item)
    if isinstance(item, list) and any(isinstance(i, (Tensor, np.ndarray))
                                      for i in item):
        return [_unwrap_index(i, device) for i in item]
    return item


class Tensor:
    __slots__ = ("_t", "_meta", "__weakref__")

    def __init__(self, data, dtype=None, stop_gradient: bool = True,
                 name: str = "", place=None):
        t = to_torch(data, dtype, place)
        if not stop_gradient and (t.is_floating_point() or t.is_complex()):
            t = t.requires_grad_(True)
        self._t = t
        self._meta = {"name": name} if name else None

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        obj = object.__new__(Tensor)
        obj._t = t
        obj._meta = None
        return obj

    # ------------------------------------------------------ paddle attrs
    def _get(self, key, default):
        return default if self._meta is None else self._meta.get(key,
                                                                  default)

    def _set(self, key, value):
        if self._meta is None:
            self._meta = {}
        self._meta[key] = value

    name = property(lambda self: self._get("name", ""),
                    lambda self, v: self._set("name", v))
    persistable = property(lambda self: self._get("persistable", False),
                           lambda self, v: self._set("persistable", v))
    process_mesh = property(lambda self: self._get("process_mesh", None),
                            lambda self, v: self._set("process_mesh", v))
    placements = property(lambda self: self._get("placements", None),
                          lambda self, v: self._set("placements", v))

    # -------------------------------------------------------- properties
    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def ndim(self):
        return self._t.dim()

    def dim(self):
        return self._t.dim()

    def rank(self):
        return self._t.dim()

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def size(self) -> int:
        return self._t.numel()

    def numel(self) -> int:
        return self._t.numel()

    def element_size(self) -> int:
        return self._t.element_size()

    @property
    def nbytes(self) -> int:
        return self._t.numel() * self._t.element_size()

    @property
    def place(self):
        return place_of(self._t.device)

    @property
    def is_leaf(self) -> bool:
        return self._t.grad_fn is None

    @property
    def stop_gradient(self) -> bool:
        return not self._t.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        t = self._t
        if value:
            if t.requires_grad:
                if t.grad_fn is None:
                    t.requires_grad_(False)
                else:
                    self._t = t.detach()
        elif not t.requires_grad and (t.is_floating_point()
                                      or t.is_complex()):
            if t.grad_fn is None:
                t.requires_grad_(True)

    @property
    def grad(self):
        g = self._t.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        self._t.grad = None if value is None else unwrap(value)

    @property
    def T(self):
        return apply_op(get_op("transpose"), self,
                        perm=list(range(self.ndim))[::-1])

    @property
    def mT(self):
        return apply_op(get_op("t"), self)

    # -------------------------------------------------------- conversion
    def numpy(self) -> np.ndarray:
        """A numpy copy (bfloat16 as float32: numpy has no bfloat16)."""
        t = self._t.detach().resolve_conj().resolve_neg()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def item(self):
        return self._t.item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        return apply_op(get_op("cast"), self, dtype=dtype)

    def cast(self, dtype):
        return self.astype(dtype)

    def to(self, *args, **kwargs):
        from .place import Place

        out = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, (Place, torch.device)) or (
                    isinstance(a, str) and a.split(":")[0] in (
                        "cpu", "gpu", "cuda")):
                out = Tensor._wrap(out._t.to(torch_device(a)))
            elif a is not None and not isinstance(a, bool):
                out = out.astype(a)
        return out

    def cpu(self):
        return self.to("cpu")

    def cuda(self, device_id=0, blocking=True):
        return self.to(f"cuda:{device_id or 0}")

    def pin_memory(self):
        return self

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    # ---------------------------------------------------------- autograd
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        if not self._t.requires_grad:
            return          # nothing upstream needs a gradient
        tape.backward([self], None if grad_tensor is None
                      else [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self, set_to_zero: bool = False):
        if set_to_zero and self._t.grad is not None:
            self._t.grad.zero_()
        else:
            self._t.grad = None

    clear_gradient = clear_grad

    def zero_grad(self):
        self._t.grad = None

    def detach(self) -> "Tensor":
        out = Tensor._wrap(self._t.detach())
        if self.name:
            out.name = self.name
        return out

    def detach_(self):
        self._t = self._t.detach()
        return self

    def clone(self) -> "Tensor":
        return apply_op(get_op("clone"), self)

    def register_hook(self, hook):
        """`hook(grad)` runs on this tensor's gradient in the backward and
        may return a replacement; returns a handle with `remove()`."""
        def _hook(g):
            r = hook(Tensor._wrap(g))
            return None if r is None else unwrap(r)

        return self._t.register_hook(_hook)

    # ---------------------------------------------------------- indexing
    def __getitem__(self, item):
        return Tensor._wrap(self._t[_unwrap_index(item, self._t.device)])

    def __setitem__(self, item, value):
        idx = _unwrap_index(item, self._t.device)
        v = value._t if isinstance(value, Tensor) else torch.as_tensor(
            np.asarray(value), device=self._t.device)
        v = v.to(self._t.dtype)
        t = self._t
        if (torch.is_grad_enabled() and (t.requires_grad or v.requires_grad)
                or t._is_view()):
            out = t.clone()
            out[idx] = v
            self._t = out
        else:
            with torch.no_grad():
                t[idx] = v

    def __len__(self):
        if self._t.dim() == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._t.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ----------------------------------------------------------- dunders
    def _binary(self, opname, other, reverse=False):
        if isinstance(other, (np.ndarray, list)):
            other = Tensor(other, place=self._t.device)
        a, b = (other, self) if reverse else (self, other)
        return apply_op(get_op(opname), a, b)

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, True)

    def __sub__(self, o):
        return self._binary("subtract", o)

    def __rsub__(self, o):
        return self._binary("subtract", o, True)

    def __mul__(self, o):
        return self._binary("multiply", o)

    def __rmul__(self, o):
        return self._binary("multiply", o, True)

    def __truediv__(self, o):
        return self._binary("divide", o)

    def __rtruediv__(self, o):
        return self._binary("divide", o, True)

    def __floordiv__(self, o):
        return self._binary("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._binary("floor_divide", o, True)

    def __mod__(self, o):
        return self._binary("mod", o)

    def __rmod__(self, o):
        return self._binary("mod", o, True)

    def __pow__(self, o):
        if isinstance(o, (int, float)):
            return apply_op(get_op("pow_scalar"), self, value=o)
        return self._binary("elementwise_pow", o)

    def __rpow__(self, o):
        if isinstance(o, (int, float)):
            return apply_op(get_op("rpow_scalar"), self, value=o)
        return self._binary("elementwise_pow", o, True)

    def __matmul__(self, o):
        return self._binary("matmul", o)

    def __rmatmul__(self, o):
        return self._binary("matmul", o, True)

    def __neg__(self):
        return apply_op(get_op("neg"), self)

    def __abs__(self):
        return apply_op(get_op("abs"), self)

    def __invert__(self):
        op = "logical_not" if self.dtype == torch.bool else "bitwise_not"
        return apply_op(get_op(op), self)

    def __and__(self, o):
        return self._binary("logical_and" if self.dtype == torch.bool
                            else "bitwise_and", o)

    def __or__(self, o):
        return self._binary("logical_or" if self.dtype == torch.bool
                            else "bitwise_or", o)

    def __xor__(self, o):
        return self._binary("logical_xor" if self.dtype == torch.bool
                            else "bitwise_xor", o)

    def __eq__(self, o):
        return self._binary("equal", o)

    def __ne__(self, o):
        return self._binary("not_equal", o)

    def __lt__(self, o):
        return self._binary("less_than", o)

    def __le__(self, o):
        return self._binary("less_equal", o)

    def __gt__(self, o):
        return self._binary("greater_than", o)

    def __ge__(self, o):
        return self._binary("greater_equal", o)

    __hash__ = object.__hash__

    def __float__(self):
        return float(self._t.detach())

    def __int__(self):
        return int(self._t.detach())

    def __bool__(self):
        return bool(self._t.detach())

    def __index__(self):
        return int(self._t.detach())

    def __repr__(self):
        from ..tensor import PRINT_OPTIONS

        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        with np.printoptions(**PRINT_OPTIONS):
            body = repr(self.numpy())
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}"
                f", place={self.place}{grad_info},\n       {body})")

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def __deepcopy__(self, memo):
        t = self._t.detach().clone().requires_grad_(self._t.requires_grad)
        out = Tensor._wrap(t)
        out._meta = copy.deepcopy(self._meta, memo)
        memo[id(self)] = out
        return out

    # ----------------------------------------------------- in-place ops
    def _inplace_from(self, out: torch.Tensor):
        """Take `out` as this tensor's new value (see the module
        docstring): a new graph node where autograd must see it, else a
        write into the tensor's own storage."""
        t = self._t
        if ((torch.is_grad_enabled() and (t.requires_grad
                                          or out.requires_grad))
                or t._is_view() or out.shape != t.shape
                or out.dtype != t.dtype):
            self._t = out
        else:
            with torch.no_grad():
                t.copy_(out)
        return self

    def _inplace_op(self, opname, *args, **kwargs):
        return self._inplace_from(
            apply_op(get_op(opname), self, *args, **kwargs)._t)

    def _write(self, value: torch.Tensor):
        with torch.no_grad():
            self._t.copy_(value)
        return self

    def add_(self, y):
        if isinstance(y, np.ndarray):
            y = Tensor(y, place=self._t.device)
        return self._inplace_op("add", y)

    def subtract_(self, y):
        return self._inplace_op("subtract", y)

    def multiply_(self, y):
        return self._inplace_op("multiply", y)

    def scale_(self, scale=1.0, bias=0.0, bias_after_scale=True):
        return self._inplace_op("scale", scale=scale, bias=bias,
                                bias_after_scale=bias_after_scale)

    def clip_(self, min=None, max=None):
        return self._inplace_op("clip", min=min, max=max)

    def tril_(self, diagonal=0):
        return self._inplace_op("tril", diagonal=diagonal)

    def triu_(self, diagonal=0):
        return self._inplace_op("triu", diagonal=diagonal)

    def remainder_(self, y):
        return self._inplace_op("remainder", y)

    def floor_(self):
        return self._inplace_op("floor")

    def ceil_(self):
        return self._inplace_op("ceil")

    def apply_(self, func):
        """In-place elementwise apply of a Python callable on the host
        (func maps ndarray -> ndarray); refused on a tensor that needs
        grad, as in the reference."""
        if not self.stop_gradient:
            raise RuntimeError(
                "apply_ cannot be used on a tensor that requires grad "
                "(the host callable is outside the autograd graph)")
        return self._write(torch.as_tensor(np.asarray(func(self.numpy())))
                           .reshape(self._t.shape))

    def apply(self, func):
        return Tensor._wrap(torch.as_tensor(
            np.asarray(func(self.numpy())), device=self._t.device).to(
                self._t.dtype))

    def zero_(self):
        with torch.no_grad():
            self._t.zero_()
        return self

    def fill_(self, value):
        with torch.no_grad():
            self._t.fill_(value)
        return self

    def _gen(self):
        from .rng import generator_for

        return generator_for(self._t.device)

    def exponential_(self, lam=1.0):
        with torch.no_grad():
            self._t.exponential_(lam, generator=self._gen())
        return self

    def uniform_(self, min=-1.0, max=1.0, seed=0):
        with torch.no_grad():
            self._t.uniform_(min, max, generator=self._gen())
        return self

    def normal_(self, mean=0.0, std=1.0):
        with torch.no_grad():
            self._t.normal_(mean, std, generator=self._gen())
        return self

    def set_value(self, value):
        v = unwrap(value) if isinstance(value, Tensor) else \
            torch.as_tensor(np.asarray(value))
        return self._write(v.to(self._t.dtype).reshape(self._t.shape))

    def copy_(self, other, non_blocking=False):
        return self.set_value(other)

    def reconstruct_from_(self, other):
        self._t = other._t
        return self

    # ------------------------------------------------ special methods
    def topk(self, k, axis=-1, largest=True, sorted=True):
        vals, idx = torch.topk(self._t, k, dim=axis, largest=largest,
                               sorted=True)
        return Tensor._wrap(vals), Tensor._wrap(idx)

    def chunk(self, chunks, axis=0):
        return apply_op(get_op("split"), self, num_or_sections=chunks,
                        axis=axis)

    def unique(self, return_index=False, return_inverse=False,
               return_counts=False, axis=None):
        """On the host (a data-dependent shape), as the reference."""
        res = np.unique(self.numpy(), return_index=return_index,
                        return_inverse=return_inverse,
                        return_counts=return_counts, axis=axis)
        dev = self._t.device
        if isinstance(res, tuple):
            return tuple(Tensor(r, place=dev) for r in res)
        return Tensor(res, place=dev)

    def nonzero(self, as_tuple=False):
        nz = torch.nonzero(self._t)
        if as_tuple:
            return tuple(Tensor._wrap(c) for c in nz.unbind(1))
        return Tensor._wrap(nz)

    def masked_select(self, mask):
        m = unwrap(mask, self._t.device)
        return Tensor._wrap(torch.masked_select(self._t, m.to(torch.bool)))


class ParamBase(torch.nn.Parameter):
    """A torch.nn.Parameter carrying paddle's parameter attributes in its
    own attributes; `copy.deepcopy` copies them (torch's Parameter drops
    them), leaving out the cached Paddle wrapper."""

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = type(self)(self.data.clone(
            memory_format=torch.preserve_format), self.requires_grad)
        memo[id(self)] = result
        for k, v in self.__dict__.items():
            if k != "_paddle":
                setattr(result, k, copy.deepcopy(v, memo))
        return result


_PARAM_DEFAULTS = (("paddle_name", ""), ("trainable", True),
                   ("regularizer", None), ("need_clip", True),
                   ("is_distributed", False))


def _param_attrs(p: torch.Tensor):
    d = p.__dict__
    for k, v in _PARAM_DEFAULTS:
        d.setdefault(k, v)
    d.setdefault("optimize_attr", {"learning_rate": 1.0})


def _delegate(key):
    return property(lambda self: getattr(self._t, key),
                    lambda self, v: setattr(self._t, key, v))


class Parameter(Tensor):
    """Trainable tensor (paddle's Parameter): wraps a ParamBase."""

    __slots__ = ()

    def __init__(self, data, dtype=None, name: str = "", trainable=True,
                 place=None):
        t = to_torch(data, dtype, place)
        p = ParamBase(t.detach().clone(), requires_grad=bool(trainable)
                      and (t.is_floating_point() or t.is_complex()))
        _param_attrs(p)
        p.paddle_name, p.trainable = name, bool(trainable)
        self._t = p
        self._meta = None
        p._paddle = self

    @classmethod
    def _of(cls, p: torch.nn.Parameter) -> "Parameter":
        _param_attrs(p)
        obj = object.__new__(cls)
        obj._t = p
        obj._meta = None
        return obj

    name = _delegate("paddle_name")    # torch's Tensor.name is read-only
    optimize_attr = _delegate("optimize_attr")
    regularizer = _delegate("regularizer")
    need_clip = _delegate("need_clip")
    is_distributed = _delegate("is_distributed")

    @property
    def trainable(self):
        return self._t.trainable

    @trainable.setter
    def trainable(self, value):
        self._t.trainable = bool(value)
        self._t.requires_grad_(bool(value))

    @property
    def persistable(self):
        return True

    @persistable.setter
    def persistable(self, value):
        pass

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()


def wrap_state(t: torch.Tensor) -> Tensor:
    """The Paddle wrapper of a Layer's parameter or buffer, made once and
    kept on the tensor, so `layer.weight is layer.weight`."""
    w = t.__dict__.get("_paddle")
    if w is None or w._t is not t:
        w = Parameter._of(t) if isinstance(t, torch.nn.Parameter) \
            else Tensor._wrap(t)
        t._paddle = w
    return w


def _make_method(opname):
    op = get_op(opname)

    def method(self, *args, **kwargs):
        return apply_op(op, self, *args, **kwargs)

    method.__name__ = opname
    return method


# Tensor methods bound from the op table: method name -> op name (the
# reference's table, core/tensor.py:554-616)
_METHOD_TABLE = {
    # math
    "add": "add", "subtract": "subtract", "multiply": "multiply",
    "divide": "divide", "floor_divide": "floor_divide", "mod": "mod",
    "floor_mod": "mod",
    "remainder": "remainder", "pow": "elementwise_pow", "maximum": "maximum",
    "minimum": "minimum", "fmax": "fmax", "fmin": "fmin", "atan2": "atan2",
    "scale": "scale", "neg": "neg", "abs": "abs", "sqrt": "sqrt",
    "rsqrt": "rsqrt", "exp": "exp", "expm1": "expm1", "log": "log",
    "log2": "log2", "log10": "log10", "log1p": "log1p", "sin": "sin",
    "cos": "cos", "tan": "tan", "asin": "asin", "acos": "acos",
    "atan": "atan", "sinh": "sinh", "cosh": "cosh", "tanh": "tanh",
    "asinh": "asinh", "acosh": "acosh", "atanh": "atanh",
    "sigmoid": "sigmoid", "erf": "erf", "erfinv": "erfinv", "floor": "floor",
    "ceil": "ceil", "round": "round", "trunc": "trunc", "frac": "frac",
    "sign": "sign", "reciprocal": "reciprocal", "square": "square",
    "clip": "clip", "lerp": "lerp", "logit": "logit",
    "nan_to_num": "nan_to_num", "conj": "conj", "angle": "angle",
    "real": "real", "imag": "imag", "digamma": "digamma", "lgamma": "lgamma",
    "i0": "i0", "sinc": "sinc", "deg2rad": "deg2rad", "rad2deg": "rad2deg",
    "heaviside": "heaviside", "hypot": "hypot", "copysign": "copysign",
    "logaddexp": "logaddexp", "stanh": "stanh",
    # reduction
    "sum": "sum", "mean": "mean", "max": "max", "min": "min", "amax": "amax",
    "amin": "amin", "prod": "prod", "all": "all", "any": "any",
    "argmax": "argmax", "argmin": "argmin", "logsumexp": "logsumexp",
    "std": "std", "var": "var", "median": "median", "nanmean": "nanmean",
    "nansum": "nansum", "count_nonzero": "count_nonzero", "cumsum": "cumsum",
    "cumprod": "cumprod", "logcumsumexp": "logcumsumexp",
    # comparison / logical
    "equal": "equal", "not_equal": "not_equal", "less_than": "less_than",
    "less_equal": "less_equal", "greater_than": "greater_than",
    "greater_equal": "greater_equal", "equal_all": "equal_all",
    "isclose": "isclose", "allclose": "allclose", "isnan": "isnan",
    "isinf": "isinf", "isfinite": "isfinite",
    "logical_and": "logical_and", "logical_or": "logical_or",
    "logical_xor": "logical_xor", "logical_not": "logical_not",
    "bitwise_and": "bitwise_and", "bitwise_or": "bitwise_or",
    "bitwise_xor": "bitwise_xor", "bitwise_not": "bitwise_not",
    # manipulation
    "reshape": "reshape", "transpose": "transpose", "flatten": "flatten",
    "squeeze": "squeeze", "unsqueeze": "unsqueeze", "split": "split",
    "unbind": "unbind", "expand": "expand", "broadcast_to": "broadcast_to",
    "expand_as": "expand_as", "tile": "tile", "gather": "gather",
    "gather_nd": "gather_nd", "index_select": "index_select",
    "index_sample": "index_sample", "take_along_axis": "take_along_axis",
    "put_along_axis": "put_along_axis", "scatter": "scatter",
    "scatter_nd_add": "scatter_nd_add", "where": "where", "flip": "flip",
    "roll": "roll", "sort": "sort", "argsort": "argsort", "pad": "pad",
    "repeat_interleave": "repeat_interleave", "tril": "tril", "triu": "triu",
    "diag": "diag", "diagonal": "diagonal", "diag_embed": "diag_embed",
    "kron": "kron", "moveaxis": "moveaxis", "swapaxes": "swapaxes",
    "rot90": "rot90", "masked_fill": "masked_fill", "bincount": "bincount",
    "as_strided": "as_strided",
    # linalg
    "matmul": "matmul", "bmm": "bmm", "mm": "mm", "dot": "dot",
    "outer": "outer", "inner": "inner", "cross": "cross", "t": "t",
    "norm": "norm", "cholesky": "cholesky", "inverse": "inverse",
    "trace": "trace_op", "mv": "mv", "histogram": "histogram",
    # nn
    "relu": "relu", "softmax": "softmax", "log_softmax": "log_softmax",
    "one_hot": "one_hot",
}

_load()
for _m, _op in _METHOD_TABLE.items():
    if not hasattr(Tensor, _m):
        setattr(Tensor, _m, _make_method(_op))
# the ops.yaml methods (each op's own `method` binding)
for _name, _opdef in list(OPS.items()):
    if _opdef.method and not hasattr(Tensor, _opdef.method):
        setattr(Tensor, _opdef.method, _make_method(_name))
del _m, _op, _name, _opdef
