"""MetricsListener + the default fit-loop telemetry hook.

Counterpart of ``deeplearning4j_tpu/monitoring/listener.py``.

The fit loops publish score/throughput/iteration counters into the global
registry by default via `maybe_record_fit_iteration` — zero configuration,
near-zero cost (a handful of locked float adds per batch). Attaching a
`MetricsListener` explicitly takes over that publishing (the auto-hook
steps aside so nothing double-counts), which is how you point a model at
a NON-global registry or change the cadence.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

SCORE_GAUGE = "dl4jtpu_score"
ITERATIONS = "dl4jtpu_iterations_total"
EXAMPLES = "dl4jtpu_examples_total"
SAMPLES_PER_SEC = "dl4jtpu_samples_per_sec"
BATCHES_PER_SEC = "dl4jtpu_batches_per_sec"
EPOCHS = "dl4jtpu_epochs_total"


def record_fit_iteration(model, n_examples: int, score: float,
                         seconds: Optional[float] = None,
                         registry: Optional[MetricsRegistry] = None,
                         n_batches: int = 1) -> None:
    """Publish one training-iteration interval's telemetry (`n_batches`
    iterations and `n_examples` examples over `seconds` wall-clock)."""
    r = registry or global_registry()
    name = type(model).__name__
    r.counter(ITERATIONS, "Completed training iterations",
              ("model",)).inc(n_batches, model=name)
    if n_examples:
        r.counter(EXAMPLES, "Examples consumed by training",
                  ("model",)).inc(n_examples, model=name)
    if score is not None and not math.isnan(score):
        r.gauge(SCORE_GAUGE, "Latest training loss/score",
                ("model",)).set(float(score), model=name)
    if seconds is not None and seconds > 0:
        r.gauge(BATCHES_PER_SEC, "Training iterations per second",
                ("model",)).set(n_batches / seconds, model=name)
        if n_examples:
            r.gauge(SAMPLES_PER_SEC, "Training examples per second",
                    ("model",)).set(n_examples / seconds, model=name)


#: cadence (in iterations) of score-gauge publication by the auto-hook.
#: Reading `model.score_value` forces a device->host sync, so doing it
#: every batch would serialize dispatch (tpulint: host-sync-in-hot-loop);
#: counters/throughput stay per-batch (host floats, free), the score
#: lands every Nth iteration and once more at the end of fit.
_SCORE_PUBLISH_EVERY = 25


def set_score_publish_interval(n: int) -> int:
    """Set the auto-hook's score cadence; returns the previous value."""
    global _SCORE_PUBLISH_EVERY
    prev, _SCORE_PUBLISH_EVERY = _SCORE_PUBLISH_EVERY, max(1, int(n))
    return prev


def maybe_record_fit_iteration(model, n_examples: int,
                               seconds: Optional[float],
                               n_batches: int = 1) -> None:
    """Default fit-loop hook: records into the global registry unless the
    model carries an explicit MetricsListener (which then owns publishing).
    The score is read (= synced) only on the publish cadence; other
    gauges cost nothing."""
    if any(isinstance(l, MetricsListener)
           for l in getattr(model, "listeners", ())):
        return
    it = getattr(model, "iteration_count", 0)
    score = None
    if it == 1 or it % _SCORE_PUBLISH_EVERY == 0:
        score = getattr(model, "score_value", None)
    record_fit_iteration(model, n_examples, score, seconds,
                         n_batches=n_batches)


def finalize_fit_telemetry(model) -> None:
    """End-of-fit barrier: ONE deliberate host sync after the last batch.

    ``torch.cuda.synchronize`` on the net's device (so an error of a
    queued kernel surfaces inside fit, not at some later read), then the
    sentinel's pending flags settled, then the terminal score gauge that
    the lazy per-batch path skipped. This is the 'final batch' sync the
    fit loops are allowed to keep."""
    import torch

    device = getattr(model, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    # settle the non-finite sentinel's pending flags (resilience/): the
    # bad/skipped-step counters must be current once fit returns
    from deeplearning4j_tpu_torch.resilience.sentinel import flush_accounting
    flush_accounting(model)
    if any(isinstance(l, MetricsListener)
           for l in getattr(model, "listeners", ())):
        return  # explicit listener owns publishing
    # terminal score gauge via the shared publish path (0 batches/examples:
    # only the nan-guarded score gauge actually lands)
    record_fit_iteration(model, 0, getattr(model, "score_value", None),
                         None, n_batches=0)


class MetricsListener(TrainingListener):
    """TrainingListener that publishes score, samples/sec and batches/sec
    into a metrics registry (the telemetry-era PerformanceListener)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 frequency: int = 1):
        self.registry = registry or global_registry()
        self.frequency = max(1, frequency)
        self._samples = 0
        self._batches = 0
        self._last_time: Optional[float] = None

    def record_batch(self, num_examples: int) -> None:
        self._samples += num_examples

    def iteration_done(self, model, iteration: int, score: float) -> None:
        self._batches += 1
        if iteration % self.frequency != 0:
            return
        now = time.perf_counter()
        dt = None if self._last_time is None else now - self._last_time
        self._last_time = now
        record_fit_iteration(model, self._samples, score, dt,
                             self.registry, n_batches=self._batches)
        self._samples = 0
        self._batches = 0

    def on_epoch_end(self, model, epoch: int) -> None:
        self.registry.counter(EPOCHS, "Completed training epochs",
                              ("model",)).inc(model=type(model).__name__)
