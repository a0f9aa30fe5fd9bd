"""Dygraph autograd over torch autograd (counterpart of
paddle_tpu/core/tape.py and the grad / backward of
paddle_tpu/autograd/__init__.py:19-58).

The reference records a vjp closure per op on its own tape. The port's
Tensor holds a torch tensor whose `requires_grad` is the inverse of
`stop_gradient`, so torch autograd records the graph as the op bodies run
and `backward()` / `grad()` are torch's. Gradients accumulate into a
leaf's `.grad` across backward calls, as the reference's `_accumulate_grad`
does; a second backward through a freed graph raises.

`no_grad`, `enable_grad` and `set_grad_enabled` are torch's grad mode
under paddle's names (each works as a context manager and as a
decorator).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "grad_enabled",
           "is_grad_enabled", "backward", "grad"]


class _GradMode:
    _mode = True

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        mode = self._mode

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with set_grad_enabled(mode):
                return fn(*args, **kwargs)

        return wrapper


class no_grad(_GradMode):
    """Context manager / decorator: ops record no graph (paddle.no_grad)."""

    _mode = False


class enable_grad(_GradMode):
    _mode = True


class set_grad_enabled(_GradMode):
    """Grad mode `mode` inside the `with` block (the reference's guard:
    calling it changes nothing until the block is entered)."""

    def __init__(self, mode: bool):
        self._mode = bool(mode)


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


is_grad_enabled = grad_enabled


def _torch_list(xs):
    from .tensor import Tensor

    if xs is None:
        return None
    if isinstance(xs, (Tensor, torch.Tensor)):
        xs = [xs]
    return [x._t if isinstance(x, Tensor) else x for x in xs]


def backward(tensors, grad_tensors=None, retain_graph: bool = False):
    """paddle.autograd.backward: gradients of `tensors` (each of one
    element, unless its `grad_tensors` entry is given) accumulate into the
    `.grad` of every leaf that needs one."""
    outs = _torch_list(tensors)
    grads = _torch_list(grad_tensors)
    if grads is None:
        for t in outs:
            if t.numel() != 1:
                raise RuntimeError(
                    "backward() on a non-scalar tensor requires "
                    "grad_tensors")
    torch.autograd.backward(outs, grads, retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: the gradients of `outputs` with respect to `inputs`,
    leaving every `.grad` as it was. An input the outputs do not reach
    raises unless `allow_unused`, which gives None for it; with
    `create_graph` the results are differentiable."""
    from .tensor import Tensor

    outs = _torch_list(outputs)
    ins = _torch_list(inputs)
    gos = _torch_list(grad_outputs)
    retain = create_graph if retain_graph is None else bool(retain_graph)
    try:
        res = torch.autograd.grad(outs, ins, gos, retain_graph=retain,
                                  create_graph=create_graph,
                                  allow_unused=True)
    except RuntimeError as e:
        if "does not require grad" in str(e) and not allow_unused:
            raise RuntimeError(
                "one of the inputs received no gradient; pass "
                "allow_unused=True to get None instead") from e
        raise
    if not allow_unused and any(g is None for g in res):
        raise RuntimeError("one of the inputs received no gradient; pass "
                           "allow_unused=True to get None instead")
    return [None if g is None else Tensor._wrap(g) for g in res]
