"""Hand-written Hopper kernels (CUDA C++ for sm_90a, sources in ``csrc/``)
and their plain PyTorch versions.  Kernels build at their first launch."""

from .attention import (  # noqa: F401
    LAUNCH_COUNTS, ragged_paged_attention_decode,
    ragged_paged_attention_decode_ref, reset_launch_counts)
from .flash_attention import (  # noqa: F401
    flash_attention_bwd, flash_attention_bwd_ref, flash_attention_dkv,
    flash_attention_dkv_ref, flash_attention_dq, flash_attention_dq_ref,
    flash_attention_fwd, flash_attention_fwd_ref,
    flash_attention_ragged_bhsd, flash_attention_ragged_bhsd_ref,
    varlen_flash_bwd, varlen_flash_bwd_ref, varlen_flash_dkv,
    varlen_flash_dkv_ref, varlen_flash_dq, varlen_flash_dq_ref,
    varlen_flash_fwd, varlen_flash_fwd_ref)
from .quant_matmul import (  # noqa: F401
    qmm_route, quant_matmul, quant_matmul_ref, use_quant_kernel)
