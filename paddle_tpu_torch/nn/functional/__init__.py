from .activation import silu  # noqa: F401
from .common import embedding, linear  # noqa: F401
from .norm import rms_norm  # noqa: F401
from .attention import (flash_attention, flash_attn_unpadded,  # noqa: F401
                        flash_sdpa, scaled_dot_product_attention, sdp_kernel,
                        sdpa)
from .loss import cross_entropy  # noqa: F401
