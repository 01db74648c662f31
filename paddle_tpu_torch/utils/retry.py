"""Unified retry/backoff policy for the host-side runtime (counterpart of
``paddle_tpu/utils/retry.py``, a copy of its stdlib-only code; a retry
is not flight-recorded until the port has its telemetry, ROADMAP A5).

Every module used to hand-roll its own sleep/poll loop (store connect,
download, rendezvous waits).  This module is the one shared policy:
exponential backoff with jitter, monotonic-clock deadlines, a max-attempt
budget, and a retryable-exception filter, exposed three ways:

* :class:`RetryPolicy` — the policy object itself
* :func:`call_with_retry` — run a callable under a policy
* :func:`retryable` — decorator form

Injected faults (:class:`~paddle_tpu_torch.utils.failpoint.FailpointError`)
subclass :class:`ConnectionError`, so the default filter retries them like
any real infrastructure error.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field, replace
from random import Random
from typing import Callable, Optional, Tuple, Type

__all__ = ["RetryPolicy", "call_with_retry", "retryable",
           "DEFAULT_RETRYABLE"]

DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, OSError)

# Deterministic jitter source: reproducible runs matter more for a
# fault-injection harness than cross-process desynchronisation.
_jitter_rng = Random(0x5EED)


@dataclass
class RetryPolicy:
    """Backoff schedule + retry filter.

    ``max_attempts=None`` means unbounded attempts — only valid together
    with a ``deadline`` (seconds of total budget, measured on the
    monotonic clock from the moment :func:`call_with_retry` starts).
    """

    max_attempts: Optional[int] = 3
    initial_backoff: float = 0.1
    max_backoff: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.1           # +/- fraction applied to each backoff
    deadline: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def __post_init__(self) -> None:
        if self.max_attempts is None and self.deadline is None:
            raise ValueError(
                "RetryPolicy: unbounded max_attempts requires a deadline")
        if self.max_attempts is not None and self.max_attempts < 1:
            raise ValueError("RetryPolicy: max_attempts must be >= 1")

    def backoff(self, attempt: int) -> float:
        """Pause before attempt ``attempt + 1`` (``attempt`` counts from 1)."""
        base = min(self.initial_backoff * self.multiplier ** (attempt - 1),
                   self.max_backoff)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * _jitter_rng.random() - 1.0)
        return max(base, 0.0)

    def with_(self, **overrides) -> "RetryPolicy":
        """A copy of this policy with fields replaced."""
        return replace(self, **overrides)


def call_with_retry(fn: Callable, *args,
                    policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable[[int, BaseException, float],
                                                None]] = None,
                    **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Non-retryable exceptions propagate immediately; once attempts or the
    deadline are exhausted the LAST retryable exception is re-raised
    unchanged, so call sites keep their native error types.
    ``on_retry(attempt, exc, pause)`` observes each scheduled retry.
    """
    policy = policy or RetryPolicy()
    deadline_t = (None if policy.deadline is None
                  else time.monotonic() + policy.deadline)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except policy.retryable as e:
            now = time.monotonic()
            exhausted = (policy.max_attempts is not None
                         and attempt >= policy.max_attempts)
            if exhausted or (deadline_t is not None and now >= deadline_t):
                raise
            pause = policy.backoff(attempt)
            if deadline_t is not None:
                pause = min(pause, max(deadline_t - now, 0.0))
            if on_retry is not None:
                on_retry(attempt, e, pause)
            if pause > 0:
                policy.sleep(pause)


def retryable(policy: Optional[RetryPolicy] = None, **overrides):
    """Decorator: run the wrapped callable under ``call_with_retry``.

    Either pass a ready :class:`RetryPolicy` or keyword fields for one::

        @retryable(max_attempts=5, initial_backoff=0.05)
        def fetch(): ...
    """
    if policy is None:
        pol = RetryPolicy(**overrides)
    else:
        pol = policy.with_(**overrides) if overrides else policy

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            # partial() keeps the wrapped function's own kwargs (even ones
            # named 'policy'/'on_retry') out of call_with_retry's signature
            return call_with_retry(functools.partial(fn, *args, **kwargs),
                                   policy=pol)

        inner.retry_policy = pol
        return inner

    return deco
