"""Serving error types.

Counterpart of ``deeplearning4j_tpu/serving/errors.py``: the same names
for the same conditions. The overload and fleet errors come with those
layers (ROADMAP.md A7, A10).
"""

from __future__ import annotations

__all__ = ["EngineShutdown", "InferenceTimeout", "RequestCancelled",
           "ServingQueueFull"]


class InferenceTimeout(TimeoutError):
    """A per-request deadline expired before a result was ready."""


class ServingQueueFull(RuntimeError):
    """fail_fast admission control rejected a request (queue at limit)."""


class RequestCancelled(RuntimeError):
    """The caller cancelled a request before it finished."""


class EngineShutdown(RuntimeError):
    """The serving component stopped before this request finished."""
