from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer.layers import Layer  # noqa: F401
from .layer import *  # noqa: F401,F403
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .initializer import ParamAttr  # noqa: F401
from .layer.layers import ParamBase as Parameter  # noqa: F401
from . import utils  # noqa: F401
from .utils import clip_grad_norm_, clip_grad_value_  # noqa: F401
