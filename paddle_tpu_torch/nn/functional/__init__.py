from .activation import silu  # noqa: F401
from .common import embedding, linear  # noqa: F401
from .norm import rms_norm  # noqa: F401
from .attention import (ROUTE_COUNTS, flash_attention,  # noqa: F401
                        flash_attn_unpadded, flash_sdpa, reset_route_counts,
                        scaled_dot_product_attention, sdp_kernel, sdpa)
from .loss import cross_entropy  # noqa: F401
