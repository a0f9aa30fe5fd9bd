"""paddle.autograd for the port (counterpart of
paddle_tpu/autograd/__init__.py:19-58): `backward`, `grad` and the grad
modes, over torch autograd (`core.tape`). PyLayer, jacobian, hessian, jvp
and vjp are queue 1 item 6d (ROADMAP)."""
from ..core.tape import (backward, enable_grad, grad, is_grad_enabled,
                         no_grad, set_grad_enabled)

__all__ = ["backward", "enable_grad", "grad", "is_grad_enabled", "no_grad",
           "set_grad_enabled"]
