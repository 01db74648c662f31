"""Framework error taxonomy and the enforce helper (counterpart of
``paddle_tpu/core/errors.py``, after Paddle's ``paddle/common/errors.h``
classes and ``enforce.h`` PADDLE_ENFORCE): shape and argument failures
raise typed errors that name what went wrong."""

from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
           "PreconditionNotMetError", "PermissionDeniedError",
           "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
           "FatalError", "ExternalError", "enforce"]


class EnforceNotMet(RuntimeError):
    """Base of all framework-raised errors."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    pass


class NotFoundError(EnforceNotMet, LookupError):
    pass


class OutOfRangeError(EnforceNotMet, IndexError):
    pass


class AlreadyExistsError(EnforceNotMet):
    pass


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    pass


class PreconditionNotMetError(EnforceNotMet):
    pass


class PermissionDeniedError(EnforceNotMet):
    pass


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    pass


class UnimplementedError(EnforceNotMet, NotImplementedError):
    pass


class UnavailableError(EnforceNotMet):
    pass


class FatalError(EnforceNotMet):
    pass


class ExternalError(EnforceNotMet):
    pass


def enforce(condition, message: str = "",
            exc: type = InvalidArgumentError) -> None:
    """PADDLE_ENFORCE: raise ``exc`` with ``message`` unless condition."""
    if not condition:
        raise exc(message or "enforce failed")
