"""paddle_tpu_torch.quantization (counterpart of
``paddle_tpu/quantization``): QAT and PTQ with observers and fake
quanters over the port's Linear, and ``fake_quant_dequant`` with its
straight-through gradient.  Quantisation is simulated in float32, as in
the reference; ``paddle_tpu_torch.quantize`` holds the int8/int4
inference path.
"""

from .config import QuantConfig  # noqa: F401
from .functional import fake_quant_dequant  # noqa: F401
from .observers import (AbsmaxObserver, AbsMaxChannelWiseWeightObserver,  # noqa: F401
                        BaseObserver, EMAObserver)
from .ptq import PTQ  # noqa: F401
from .qat import QAT  # noqa: F401
from .quanters import (FakeQuanterChannelWiseAbsMax,  # noqa: F401
                       FakeQuanterWithAbsMaxObserver)

__all__ = ["QuantConfig", "QAT", "PTQ", "BaseObserver",
           "BaseQuanter", "quanter", "AbsmaxObserver",
           "AbsMaxChannelWiseWeightObserver", "EMAObserver",
           "FakeQuanterWithAbsMaxObserver", "FakeQuanterChannelWiseAbsMax",
           "fake_quant_dequant"]

# the reference's factory surface
BaseQuanter = FakeQuanterWithAbsMaxObserver


def quanter(name):
    """The reference's ``@quanter`` registration decorator: returns the
    class unchanged and records it on this module under ``name``."""
    def deco(cls):
        globals()[name] = cls
        return cls
    return deco
