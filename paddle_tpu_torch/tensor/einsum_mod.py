"""einsum re-export (counterpart of ``paddle_tpu/tensor/einsum_mod.py``)."""

from .attribute import einsum

__all__ = ["einsum"]
