"""Bounded exponential-backoff retry with jitter.

Counterpart of ``deeplearning4j_tpu/resilience/retry.py``, kept as the
port's own copy (the prefetch worker retries its base iterator's pulls
through it).

The repo-wide retry shape: every transient-failure loop (prefetch worker
re-pulling a flaky base iterator, dataset file resolution racing another
process's decompress, a serving client re-dialing) goes through
``retry_call`` instead of a hand-rolled ``while True: ... time.sleep``.
Hand-rolled unbounded loops are what this helper replaces.

Design points:

- **Bounded**: ``max_attempts`` is a hard ceiling — the last exception
  re-raises. Unbounded retry turns a dead dependency into a hung
  process (the serving analogue of a lost Spark task retried forever).
- **Backoff with jitter**: delay grows ``base_delay * multiplier**n``
  capped at ``max_delay``, then shrinks by a random fraction up to
  ``jitter`` (decorrelates a fleet of workers hammering a recovering
  dependency in lockstep). Pass an ``rng`` for deterministic tests.
- **Observable**: retries and exhaustions land in the metrics registry
  (``dl4jtpu_retries_total`` / ``dl4jtpu_retry_exhausted_total``,
  labeled by operation).

Pure Python (like monitoring.metrics): importable from failure paths
and pure-host tooling.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

RETRIES = "dl4jtpu_retries_total"
RETRY_EXHAUSTED = "dl4jtpu_retry_exhausted_total"

log = logging.getLogger(__name__)

__all__ = ["RETRIES", "RETRY_EXHAUSTED", "RestartBudget", "RetryPolicy",
           "retry_call", "retryable"]


@dataclass(frozen=True)
class RetryPolicy:
    """How to retry: which exceptions, how many times, how long between.

    ``delay(attempt)`` for attempt=1.. grows geometrically and is capped,
    so the worst-case total stall is bounded and computable:
    ``sum(delay(i) for i in range(1, max_attempts))``.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    #: fraction of each delay randomized away (0 = deterministic)
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (
        OSError, ConnectionError, TimeoutError)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1 (backoff must not shrink), "
                f"got {self.multiplier}")

    def delay(self, attempt: int,
              rng: Optional[random.Random] = None) -> float:
        """Seconds to sleep before retry `attempt` (1-based)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            d *= 1.0 - self.jitter * (rng or random).random()
        return d


def retry_call(fn: Callable, *args,
               policy: Optional[RetryPolicy] = None,
               op: Optional[str] = None,
               sleep: Callable[[float], None] = time.sleep,
               rng: Optional[random.Random] = None,
               registry: Optional[MetricsRegistry] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying ``policy.retry_on``
    exceptions with bounded exponential backoff; the final failure
    re-raises. ``op`` labels the retry metrics (defaults to the
    function's name); ``sleep``/``rng`` are injectable for tests."""
    p = policy or RetryPolicy()
    name = op or getattr(fn, "__name__", "call")
    r = registry or global_registry()
    for attempt in range(1, p.max_attempts + 1):
        try:
            return fn(*args, **kwargs)
        except p.retry_on as e:
            if attempt >= p.max_attempts:
                r.counter(RETRY_EXHAUSTED,
                          "Operations that failed every retry attempt",
                          ("op",)).inc(op=name)
                log.warning("%s: giving up after %d attempts (%r)",
                            name, attempt, e)
                raise
            d = p.delay(attempt, rng)
            r.counter(RETRIES, "Transient failures retried with backoff",
                      ("op",)).inc(op=name)
            log.info("%s: attempt %d/%d failed (%r); retrying in %.3fs",
                     name, attempt, p.max_attempts, e, d)
            sleep(d)
    raise AssertionError("unreachable")  # pragma: no cover


class RestartBudget:
    """Sliding-window restart budget: at most ``max_restarts``
    acquisitions per ``window_s`` seconds.

    The windowed sibling of :class:`RetryPolicy`'s attempt bound, for
    *whole-component* restarts (a serving-engine arena rebuild, a
    trainer re-mesh) where what must be bounded is the restart RATE,
    not a per-operation attempt count: a single fault burst should be
    ridden out, but a component restarting forever is a crash loop that
    must escalate to its terminal failure mode instead of masking a
    persistent fault. Old acquisitions age out, so an incident per hour
    never exhausts a per-minute budget. ``clock`` is injectable for
    deterministic tests. ``try_acquire`` callers serialize (the engine
    holds its step lock across recovery), but ``remaining()`` is read
    from lock-free health/metrics probes and therefore never mutates:
    only ``try_acquire`` prunes, so a concurrent probe cannot drop a
    just-recorded restart and leak the budget."""

    def __init__(self, max_restarts: int = 3, window_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        if max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {max_restarts}")
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self._clock = clock
        self._acquired: list = []

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        self._acquired = [t for t in self._acquired if t > cut]

    def remaining(self) -> int:
        """Restarts still allowed in the current window. Non-mutating:
        counts live entries against a snapshot of the list."""
        cut = self._clock() - self.window_s
        live = sum(1 for t in list(self._acquired) if t > cut)
        return self.max_restarts - live

    def try_acquire(self) -> bool:
        """Consume one restart if the window has room; False means the
        budget is exhausted and the caller must escalate."""
        now = self._clock()
        self._prune(now)
        if len(self._acquired) >= self.max_restarts:
            return False
        self._acquired.append(now)
        return True


def retryable(policy: Optional[RetryPolicy] = None,
              op: Optional[str] = None):
    """Decorator form of ``retry_call``. Retry options are bound at
    decoration time; the wrapped function's own kwargs pass through
    untouched (a caller kwarg named ``rng``/``sleep``/``policy`` must
    reach the function, not the retry machinery)."""
    def deco(fn):
        def wrapped(*args, **kwargs):
            return retry_call(lambda: fn(*args, **kwargs),
                              policy=policy, op=op or fn.__name__)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        wrapped.__doc__ = fn.__doc__
        return wrapped
    return deco
