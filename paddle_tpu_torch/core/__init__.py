from .dtype import to_torch_dtype  # noqa: F401
from .place import resolve_device  # noqa: F401
