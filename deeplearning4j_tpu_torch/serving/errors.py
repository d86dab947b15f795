"""Serving error types.

Counterpart of ``deeplearning4j_tpu/serving/errors.py``: the same names
for the same conditions. ``NoReplicaAvailable``, the fleet router's
error, comes with the fleet (ROADMAP.md A10).
"""

from __future__ import annotations

__all__ = ["EngineShutdown", "InferenceTimeout", "RequestCancelled",
           "ServingOverloaded", "ServingQueueFull"]


class InferenceTimeout(TimeoutError):
    """A per-request deadline expired before a result was ready."""


class ServingQueueFull(RuntimeError):
    """fail_fast admission control rejected a request (queue at limit)."""


class RequestCancelled(RuntimeError):
    """The caller cancelled a request before it finished."""


class EngineShutdown(RuntimeError):
    """The serving component stopped before this request finished."""


class ServingOverloaded(RuntimeError):
    """Overload control refused this request: shed from the queue under
    a sustained latency-SLO breach, or rejected at submit because its
    deadline cannot be met given the queue estimate. Retryable against a
    less-loaded replica, or later with backoff."""
