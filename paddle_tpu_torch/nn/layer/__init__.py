from .common import Embedding, Linear  # noqa: F401
from .norm import RMSNorm  # noqa: F401
