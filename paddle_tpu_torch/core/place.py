"""Device resolution for the port's entry points.

Counterpart of ``paddle_tpu/core/place.py``.  The port runs on the card:
``None`` means the current device (``set_device``), which is ``"cuda"``
unless set, and a CUDA request on a machine without a CUDA device raises
instead of carrying on on the CPU.  Callers that want the CPU (the tests)
say ``device="cpu"`` or ``set_device("cpu")``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "set_device", "get_device"]

_current: Optional[str] = None


def set_device(device: Union[str, torch.device]) -> torch.device:
    """paddle.set_device: where creation functions put tensors by default
    ("cpu", "gpu", "gpu:N", "cuda", "cuda:N")."""
    global _current
    name = str(device)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    dev = resolve_device(name)
    _current = str(dev)
    return dev


def get_device() -> str:
    """paddle.get_device: "cpu" or "gpu:N"."""
    dev = resolve_device(None)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    explicit = device is not None or _current is not None
    dev = torch.device(device if device is not None
                       else (_current or "cuda"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested"
                f"{'' if explicit else ' (the default)'} but no CUDA "
                f"device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: expected "
                         f"'cuda', 'cuda:N' or 'cpu'")
    return dev
