"""Unified telemetry subsystem.

Counterpart of ``deeplearning4j_tpu/monitoring/``. One shared model for
everything the port observes:

    registry (metrics.py)  <-  spans (tracing.py)
                           <-  device/host gauges + step-capture counter
                               (runtime.py)
                           <-  fit loops / MetricsListener (listener.py)
                           <-  prefetch stage (pipeline/prefetch.py)
                           <-  non-finite sentinel (resilience/sentinel.py)
                           <-  kernel-crossover store (tuning/crossover.py)
    registry  ->  Prometheus text exposition / JSONL sink (exporters.py)

``ensure_started()`` is the one switch: idempotent, called at the top of
``fit``, it declares the series of the modules the port has (spans,
events, step captures, prefetch, sentinel, checkpoints, autotune), so a
scrape taken before the first iteration already shows the full schema.
The JAX package also declares its elastic-membership series here; those
come with their module (ROADMAP.md A9).
"""

from __future__ import annotations

import threading

from deeplearning4j_tpu_torch.monitoring.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.monitoring.events import (  # noqa: F401
    Event, EventLog, emit, events_enabled, global_event_log,
    set_events_enabled)
from deeplearning4j_tpu_torch.monitoring.tracing import (  # noqa: F401
    current_path, declare_default_spans, is_enabled, phase_detail,
    record_span, set_enabled, set_phase_detail, span)
from deeplearning4j_tpu_torch.monitoring.exporters import (  # noqa: F401
    CONTENT_TYPE, JsonlSink, metrics_snapshot, render_prometheus)
from deeplearning4j_tpu_torch.monitoring.listener import (  # noqa: F401
    MetricsListener, finalize_fit_telemetry, maybe_record_fit_iteration,
    record_fit_iteration, set_score_publish_interval)

_started = False
_start_lock = threading.Lock()


def ensure_started() -> None:
    """Idempotently turn on the process-wide default telemetry: the
    declared series of spans, events, step captures, the prefetch stage,
    the sentinel and the crossover store."""
    global _started
    if _started:
        return
    with _start_lock:
        if _started:
            return
        from deeplearning4j_tpu_torch.monitoring import runtime
        from deeplearning4j_tpu_torch.monitoring.events import (
            declare_event_series)
        from deeplearning4j_tpu_torch.pipeline.prefetch import (
            declare_prefetch_series)
        from deeplearning4j_tpu_torch.resilience.durable import (
            declare_checkpoint_series)
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            declare_sentinel_series)
        from deeplearning4j_tpu_torch.tuning.crossover import (
            declare_autotune_series)
        runtime.install_recompile_watcher()
        declare_default_spans()
        declare_event_series()
        declare_prefetch_series()
        declare_sentinel_series()
        declare_checkpoint_series()
        declare_autotune_series()
        _started = True
