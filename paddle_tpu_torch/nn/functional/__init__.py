from .activation import silu  # noqa: F401
from .common import embedding, linear  # noqa: F401
from .norm import rms_norm  # noqa: F401
