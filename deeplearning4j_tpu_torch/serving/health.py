"""Shared serving telemetry registration.

Counterpart of ``deeplearning4j_tpu/serving/health.py``: the same
``dl4jtpu_serving_*`` series names, help strings and label sets. Every
serving component registers through this one path: the request, error,
deadline and rejection counters with their handles resolved once (the
decode loop must not enter the registry's get-or-create lock per
token), and scrape-time health gauges holding a WEAK reference (a
registry series must not keep a shut-down engine, and its device
tensors, alive; a collected engine scrapes as down). The fleet's
``dl4jtpu_fleet_*`` names come with the fleet (ROADMAP.md A10).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

SERVING_HEALTHY = "dl4jtpu_serving_healthy"
SERVING_READY = "dl4jtpu_serving_ready"
SERVING_QUEUE_DEPTH = "dl4jtpu_serving_queue_depth"
SERVING_REQUESTS = "dl4jtpu_serving_requests_total"
SERVING_ERRORS = "dl4jtpu_serving_errors_total"
SERVING_DEADLINE_EXCEEDED = "dl4jtpu_serving_deadline_exceeded_total"
SERVING_QUEUE_REJECTED = "dl4jtpu_serving_queue_rejected_total"

#: continuous-batching engine extras (engine.py registers these)
SERVING_ACTIVE_SLOTS = "dl4jtpu_serving_active_slots"
SERVING_TOKENS = "dl4jtpu_serving_tokens_total"
SERVING_TTFT = "dl4jtpu_serving_ttft_seconds"
SERVING_TPOT = "dl4jtpu_serving_tpot_seconds"
SERVING_QUEUE_WAIT = "dl4jtpu_serving_queue_wait_seconds"

#: block-paged KV arena + prefix cache + in-engine speculation (engine
#: registers these only in the matching mode)
SERVING_KV_PAGES_TOTAL = "dl4jtpu_serving_kv_pages_total"
SERVING_KV_PAGES_USED = "dl4jtpu_serving_kv_pages_used"
SERVING_PREFIX_HITS = "dl4jtpu_serving_prefix_cache_hits_total"
SERVING_PREFIX_MISSES = "dl4jtpu_serving_prefix_cache_misses_total"
SERVING_PREFIX_REUSED_TOKENS = \
    "dl4jtpu_serving_prefix_cache_reused_tokens_total"
SERVING_SPEC_ACCEPTANCE = "dl4jtpu_serving_spec_acceptance_ratio"

#: KV-traffic accounting for the paged decode (engine registers these
#: in paged mode): the bytes the KV path moves per dispatch, modeled on
#: the host from the path in use (the port has one on the card, the
#: paged kernel's direct read: live pages read plus the appended
#: tokens), and the per-step decode dispatch latency.
SERVING_KV_BYTES_MOVED = "dl4jtpu_serving_kv_bytes_moved_total"
SERVING_DISPATCH_LATENCY = "dl4jtpu_serving_decode_dispatch_seconds"

#: survivability layer (supervisor.py / overload.py register these)
SERVING_ENGINE_REBUILDS = "dl4jtpu_serving_engine_rebuilds_total"
SERVING_ENGINE_ESCALATIONS = \
    "dl4jtpu_serving_engine_escalations_total"
SERVING_RECOVERED_REQUESTS = \
    "dl4jtpu_serving_recovered_requests_total"
SERVING_SHED = "dl4jtpu_serving_shed_total"
SERVING_EARLY_REJECTED = "dl4jtpu_serving_early_rejected_total"
SERVING_BROWNOUT_LEVEL = "dl4jtpu_serving_brownout_level"
SERVING_DRAINING = "dl4jtpu_serving_draining"

_COUNTERS = (
    (SERVING_REQUESTS, "Serving requests received"),
    (SERVING_ERRORS, "Serving requests failed by model errors"),
    (SERVING_DEADLINE_EXCEEDED, "Requests that outlived their deadline"),
    (SERVING_QUEUE_REJECTED, "Requests rejected by fail_fast admission"),
)


def scrape_probe(component, fn, default: float = 0.0):
    """Scrape-time gauge callback over a WEAK reference to `component`:
    reads ``fn(component)`` at collection time, `default` once the
    component is collected. The one probe shape every serving gauge
    uses — fix it here, every component's gauges follow."""
    ref = weakref.ref(component)

    def read():
        inst = ref()
        return default if inst is None else float(fn(inst))
    return read


def register_serving_metrics(component, model: str,
                             registry: Optional[MetricsRegistry] = None
                             ) -> Dict[str, object]:
    """Register the shared serving series for `component` and return its
    resolved counter handles ``{metric name: handle}``.

    `component` must expose ``is_healthy()`` / ``is_ready()`` /
    ``queue_depth()``; the healthy/ready/queue-depth gauges are
    scrape-time callbacks over a weakref to it, so a crashed worker
    flips them on the next scrape with no event having fired. One
    serving stack per `model` label value per registry; a newer
    instance takes over the series.
    """
    r = registry or global_registry()
    handles = {
        metric: r.counter(metric, help, ("model",)).labels(model=model)
        for metric, help in _COUNTERS}
    r.gauge(SERVING_HEALTHY, "Serving loop alive (1) or down (0)",
            ("model",)).set_function(
        scrape_probe(component,
                     lambda s: 1.0 if s.is_healthy() else 0.0),
        model=model)
    r.gauge(SERVING_READY, "Serving admitting requests (1) or not (0)",
            ("model",)).set_function(
        scrape_probe(component,
                     lambda s: 1.0 if s.is_ready() else 0.0),
        model=model)
    r.gauge(SERVING_QUEUE_DEPTH,
            "Requests waiting in the admission queue",
            ("model",)).set_function(
        scrape_probe(component, lambda s: s.queue_depth()), model=model)
    return handles
