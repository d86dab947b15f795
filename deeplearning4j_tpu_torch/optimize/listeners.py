"""Training listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``: the
TrainingListener protocol and the listener zoo (ScoreIterationListener,
PerformanceListener, CollectScoresIterationListener,
TimeIterationListener, ComposableIterationListener,
ParamAndGradientIterationListener, SleepyTrainingListener) and
``EvaluativeListener`` over the networks' ``evaluate``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)


class TrainingListener:
    """Observer of the training loop (ref: optimize/api/TrainingListener.java).

    `score` may arrive as a RAW device scalar, not a Python float: the fit
    loops never sync on the loss (under ``steps_per_dispatch=K`` it is
    an element of the group's [K] device loss vector). `float(score)`
    works either way — call it only at your reporting cadence, because
    on a device value it is a host sync."""

    def iteration_done(self, model, iteration: int, score: float):
        pass

    def on_epoch_start(self, model, epoch: int):
        pass

    def on_epoch_end(self, model, epoch: int):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_backward_pass(self, model):
        pass

    def close(self):
        """Release held resources (open traces, files). Invoked from the
        fit loops' finally — i.e. also when fit() raises — and must be
        safe to call repeatedly."""
        pass


def close_listeners(listeners) -> None:
    """Best-effort close() of every listener — the fit loops call this
    from their finally so a fit that raises (or ends inside a profiler
    window) never leaks listener resources like an open profiler trace."""
    for lst in listeners:
        close = getattr(lst, "close", None)
        if callable(close):
            try:
                close()
            except Exception:  # noqa: BLE001 — cleanup best-effort
                log.warning("listener close() failed", exc_info=True)


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (ref: ScoreIterationListener.java)."""

    def __init__(self, print_iterations: int = 10, printer: Callable = None):
        self.print_iterations = max(1, print_iterations)
        self.printer = printer or (lambda s: log.info(s))

    def iteration_done(self, model, iteration, score):
        if iteration % self.print_iterations == 0:
            self.printer(f"Score at iteration {iteration} is {float(score)}")


class PerformanceListener(TrainingListener):
    """Throughput tracking: samples/sec, batches/sec
    (ref: PerformanceListener.java)."""

    def __init__(self, frequency: int = 1, report: Callable = None):
        self.frequency = max(1, frequency)
        self.report = report or (lambda s: log.info(s))
        self._last_time = None
        self._last_iter = None
        self._samples = 0
        self.samples_per_sec = 0.0
        self.batches_per_sec = 0.0

    def record_batch(self, num_examples: int):
        self._samples += num_examples

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = now - self._last_time
            iters = iteration - (self._last_iter or 0)
            if dt > 0 and iters > 0:
                self.batches_per_sec = iters / dt
                self.samples_per_sec = self._samples / dt
                self.report(
                    f"iteration {iteration}: {self.samples_per_sec:.1f} samples/sec, "
                    f"{self.batches_per_sec:.2f} batches/sec, "
                    f"score={float(score):.5f}")
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0
        elif self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            self._samples = 0


class CollectScoresIterationListener(TrainingListener):
    """Collect (iteration, score) pairs (ref: CollectScoresIterationListener.java)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class TimeIterationListener(TrainingListener):
    """Estimate remaining time (ref: TimeIterationListener.java).

    The clock starts LAZILY on the first iteration_done, not at
    construction: any setup time between building the listener and
    calling fit() (data download, jit compile of unrelated models) must
    not inflate the per-iteration estimate."""

    def __init__(self, total_iterations: int):
        self.total = total_iterations
        self.start: Optional[float] = None
        self._first_iteration: Optional[int] = None

    def iteration_done(self, model, iteration, score):
        now = time.perf_counter()
        if self.start is None:
            self.start = now
            self._first_iteration = iteration
            return
        done = iteration - self._first_iteration
        if done > 0:
            remaining = (now - self.start) / done * (self.total - iteration)
            log.info("Remaining time estimate: %.1fs", remaining)


class EvaluativeListener(TrainingListener):
    """Periodically evaluate on a held-out iterator (ref:
    EvaluativeListener.java): ``model.evaluate(iterator)`` every
    ``frequency`` iterations (never at iteration 0), or every
    ``frequency`` epochs with ``on_epoch``, each result appended to
    ``evaluations``.

    Under ``fit(steps_per_dispatch=K)`` the fit loop fires the listeners
    once per logical step after the group's replay, so an evaluation at
    any step of a group sees the group's final parameters, as under the
    JAX package's scan. The evaluation runs ``output(train=False)``: it
    draws nothing (the training generator and a step graph's generators
    keep their offsets), leaves the BN running statistics and the step
    graph's static trees as they were, and reads the parameters the
    replay wrote in place through a fresh compute-dtype copy."""

    def __init__(self, iterator, frequency: int = 1, on_epoch: bool = False):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.on_epoch = on_epoch
        self.evaluations: List = []

    def _eval(self, model):
        e = model.evaluate(self.iterator)
        self.evaluations.append(e)
        log.info("\n%s", e.stats())

    def iteration_done(self, model, iteration, score):
        if not self.on_epoch and iteration > 0 and \
                iteration % self.frequency == 0:
            self._eval(model)

    def on_epoch_end(self, model, epoch):
        if self.on_epoch and (epoch + 1) % self.frequency == 0:
            self._eval(model)


class ComposableIterationListener(TrainingListener):
    """Fan-out to child listeners (ref: ComposableIterationListener.java)."""

    def __init__(self, *listeners: TrainingListener):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration, score):
        for l in self.listeners:
            l.iteration_done(model, iteration, score)


class ParamAndGradientIterationListener(TrainingListener):
    """Per-iteration parameter/update statistics to the log or a
    tab-separated file (ref: ParamAndGradientIterationListener.java —
    the reference logs mean-magnitude of params and gradients; gradients
    are internal to the training step here, so the per-iteration param
    DELTA, i.e. the applied update, fills that column)."""

    def __init__(self, frequency: int = 1, output_file: str = None,
                 log_stats: bool = True):
        self.frequency = max(1, frequency)
        self.output_file = output_file
        self.log_stats = log_stats
        self._prev = None
        if output_file:
            with open(output_file, "w") as f:
                f.write("iteration\tscore\tparam_mean_mag\tupdate_mean_mag\n")

    @staticmethod
    def _leaves(tree, path=""):
        import numpy as np
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from ParamAndGradientIterationListener._leaves(
                    tree[k], path + "/" + str(k))
        elif tree is not None:
            # a copy on the host: the K-step graph updates the
            # parameters in place, so a view would change underneath
            yield path, np.array(tree.detach().cpu() if hasattr(
                tree, "detach") else tree)

    @classmethod
    def _mean_mag(cls, leaves):
        import numpy as np
        total = sum(float(np.abs(a).sum()) for _, a in leaves)
        count = sum(a.size for _, a in leaves)
        return total / max(1, count)

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency:
            return  # keep _prev: the update column spans the report interval
        leaves = list(self._leaves(model.params))
        pm = self._mean_mag(leaves)
        um = float("nan")
        if self._prev is not None and len(self._prev) == len(leaves):
            um = self._mean_mag([(p, a - b)
                                 for (p, a), (_, b)
                                 in zip(leaves, self._prev)])
        # host copies (_leaves): no later step can change them
        self._prev = leaves
        if self.log_stats:
            log.info("iter %d: score %.5f, |param| %.3e, |update| %.3e",
                     iteration, float(score), pm, um)
        if self.output_file:
            with open(self.output_file, "a") as f:
                f.write(f"{iteration}\t{float(score):.6f}\t{pm:.6e}\t"
                        f"{um:.6e}\n")


class SleepyTrainingListener(TrainingListener):
    """Inject sleeps into the training loop for debugging/throttling
    (ref: SleepyTrainingListener.java timerIteration/timerEpoch)."""

    def __init__(self, sleep_iteration_ms: float = 0.0,
                 sleep_epoch_ms: float = 0.0):
        self.sleep_iteration_ms = sleep_iteration_ms
        self.sleep_epoch_ms = sleep_epoch_ms

    def iteration_done(self, model, iteration, score):
        if self.sleep_iteration_ms > 0:
            time.sleep(self.sleep_iteration_ms / 1000.0)

    def on_epoch_end(self, model, epoch):
        if self.sleep_epoch_ms > 0:
            time.sleep(self.sleep_epoch_ms / 1000.0)
