"""paddle.nn's layers for the port (counterpart of paddle_tpu/nn/layer/):
the Layer base, the common layers, the containers, the norms, the
activations, the losses and the transformer encoder."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .layers import Layer, ParamAttr, make_parameter
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = (["Layer", "ParamAttr", "make_parameter"] + _activation + _common
           + _container + _loss + _norm + _transformer)
