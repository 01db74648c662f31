"""paddle_tpu_torch.framework: ``save`` and ``load`` in the reference's
checkpoint format."""

from .io_utils import load, save  # noqa: F401
