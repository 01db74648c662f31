"""Host-side utilities (counterpart of ``paddle_tpu/utils``): the
failpoint registry and the retry policy."""

from . import failpoint, retry  # noqa: F401
