from . import functional  # noqa: F401
from .layer import Embedding, Linear, RMSNorm  # noqa: F401
