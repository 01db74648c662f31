from .activation import silu  # noqa: F401
from .common import embedding, linear  # noqa: F401
from .norm import rms_norm  # noqa: F401
from .attention import (flash_sdpa, scaled_dot_product_attention,  # noqa: F401
                        sdpa)
from .loss import cross_entropy  # noqa: F401
