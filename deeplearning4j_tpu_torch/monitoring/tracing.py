"""Nestable span tracing bridged to the metrics registry and the profiler.

Counterpart of ``deeplearning4j_tpu/monitoring/tracing.py``:

    with span("forward"):
        ...

records the host wall time of the region into the
``dl4jtpu_span_seconds{span=...}`` histogram of the global registry and
opens a ``torch.profiler.record_function`` range of the same name, so
the region lines up with the traces ``optimize.profiler.
ProfilerListener`` captures. A span measures the host: it sets no device
barrier, so on the card it times the enqueue of its region, as the JAX
package's spans time the dispatch.

Spans nest via a thread-local stack (``current_path()`` returns e.g.
"iteration/forward"); the histogram label stays the leaf name so the
series' cardinality is bounded by the set of span names, not call paths.

``set_enabled(False)`` turns spans into no-ops. ``set_phase_detail(True)``
makes the eager fit step open its ``forward``, ``backward`` and
``update`` spans (the JAX package's split steps); by default the step is
one ``step`` span.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

SPAN_HISTOGRAM = "dl4jtpu_span_seconds"
SPAN_ERRORS = "dl4jtpu_span_errors_total"

#: the phase names the fit loops emit; declared eagerly so the /metrics
#: exposition always carries all per-phase series (etl/forward/backward/
#: update populate per the phase-detail mode, "step" is the whole step)
DEFAULT_SPANS = ("etl", "forward", "backward", "update", "step", "listener")

_tls = threading.local()
_enabled = True
_phase_detail = os.environ.get(
    "DL4JTPU_PHASE_DETAIL", "0").strip().lower() not in (
    "0", "", "false", "no", "off")


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


def is_enabled() -> bool:
    return _enabled


def set_phase_detail(flag: bool) -> None:
    """True: the eager fit step opens ``forward``, ``backward`` and
    ``update`` spans around its three parts. False (default): one
    ``step`` span."""
    global _phase_detail
    _phase_detail = bool(flag)


def phase_detail() -> bool:
    return _phase_detail


def current_path() -> str:
    """Slash-joined stack of open spans on this thread ("" outside any)."""
    return "/".join(getattr(_tls, "stack", ()))


def span_histogram(registry: Optional[MetricsRegistry] = None):
    r = registry or global_registry()
    return r.histogram(
        SPAN_HISTOGRAM,
        "Wall-clock seconds of named training-loop spans "
        "(host-side; aligns with XPlane TraceAnnotations)", ("span",))


def record_span(name: str, seconds: float,
                registry: Optional[MetricsRegistry] = None) -> None:
    """Directly record a span observation (a timer that measured the
    interval itself)."""
    span_histogram(registry).observe(seconds, span=name)


def declare_default_spans(registry: Optional[MetricsRegistry] = None) -> None:
    h = span_histogram(registry)
    for name in DEFAULT_SPANS:
        h.labels(span=name)


def _record_function(name: str):
    """A ``torch.profiler.record_function`` range, or None where the
    profiler cannot open one (the span still times)."""
    try:
        from torch.profiler import record_function
        return record_function(name)
    except Exception:  # noqa: BLE001 — the range is best-effort
        return None


class span:
    """Context manager: time a region into the registry and name it in
    the profiler's trace."""

    __slots__ = ("name", "registry", "_t0", "_ann")

    def __init__(self, name: str,
                 registry: Optional[MetricsRegistry] = None):
        self.name = name
        self.registry = registry

    def __enter__(self):
        if not _enabled:
            self._t0 = None
            return self
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.name)
        self._ann = _record_function(self.name)
        if self._ann is not None:
            try:
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 — the range is best-effort
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        dt = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        _tls.stack.pop()
        r = self.registry or global_registry()
        span_histogram(r).observe(dt, span=self.name)
        if exc_type is not None:
            r.counter(SPAN_ERRORS,
                      "Spans that exited via an exception",
                      ("span",)).inc(span=self.name)
        return False
