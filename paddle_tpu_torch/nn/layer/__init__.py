"""paddle.nn's layers for the port (counterpart of paddle_tpu/nn/layer/):
the Layer base, the common layers, the containers, the convolutions, the
pools, the norms, the activations, the losses, the recurrent layers and
the transformer."""
from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import *  # noqa: F401,F403
from .common import __all__ as _common
from .container import *  # noqa: F401,F403
from .container import __all__ as _container
from .conv import *  # noqa: F401,F403
from .conv import __all__ as _conv
from .layers import Layer, ParamAttr, make_parameter
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .norm import *  # noqa: F401,F403
from .norm import __all__ as _norm
from .pooling import *  # noqa: F401,F403
from .pooling import __all__ as _pooling
from .rnn import *  # noqa: F401,F403
from .rnn import __all__ as _rnn
from .transformer import *  # noqa: F401,F403
from .transformer import __all__ as _transformer

__all__ = (["Layer", "ParamAttr", "make_parameter"] + _activation + _common
           + _container + _conv + _loss + _norm + _pooling + _rnn
           + _transformer)
