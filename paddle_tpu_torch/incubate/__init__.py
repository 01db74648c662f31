"""paddle_tpu_torch.incubate (counterpart of ``paddle_tpu/incubate``): the
optimizer wrappers ``LookAhead`` and ``ModelAverage``.  The rest of the
reference's ``incubate`` (its nn layers, ASP, MoE, autotune, the
distributed fused Lamb) comes with the parts of the port they build on."""

from .lookahead import LookAhead, ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage"]
