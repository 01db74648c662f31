from . import functional  # noqa: F401
from .layer import Embedding, Linear, RMSNorm  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
