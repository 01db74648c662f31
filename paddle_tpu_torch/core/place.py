"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/place.py``.  The port runs on the card:
``None`` means ``"cuda"``, and a CUDA request on a machine without a CUDA
device raises instead of carrying on on the CPU.  Callers that want the CPU
(the tests) say ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested"
                f"{' (the default)' if device is None else ''} but no CUDA "
                f"device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: expected "
                         f"'cuda', 'cuda:N' or 'cpu'")
    return dev
