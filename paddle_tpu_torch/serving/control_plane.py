"""Request classes and the intake error the scheduler needs (the part of
``paddle_tpu/serving/control_plane.py`` this slice uses)."""

from __future__ import annotations

__all__ = ["INTERACTIVE", "BATCH", "PRIORITY_RANK", "InvalidRequestError"]

INTERACTIVE = "interactive"
BATCH = "batch"
# admission order: lower rank admits first; eviction prefers HIGHER rank
PRIORITY_RANK = {INTERACTIVE: 0, BATCH: 1}


class InvalidRequestError(ValueError):
    """Permanent refusal: this configuration can never serve the request
    (empty prompt, sequence beyond the per-sequence cap, prompt beyond the
    whole pool)."""
