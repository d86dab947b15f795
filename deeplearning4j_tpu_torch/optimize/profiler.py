"""Profiling/tracing listeners.

Counterpart of ``deeplearning4j_tpu/optimize/profiler.py``, on
``torch.profiler`` where the JAX package has ``jax.profiler``:

- ProfilerListener: captures a trace of the CPU and (on the card) the
  CUDA activity for a window of training iterations, written under
  ``log_dir`` as a Chrome trace (``trace.json``, viewable in
  ``chrome://tracing`` or Perfetto).
- TimingListener: wall-clock iteration timing without any trace
  overhead, mirroring PerformanceListener's lastEtlTime idea.
- ``annotate(name)``: a named range in the trace
  (``torch.profiler.record_function``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener

log = logging.getLogger(__name__)

__all__ = ["ProfilerListener", "TimingListener", "annotate"]


class ProfilerListener(TrainingListener):
    """Capture a ``torch.profiler`` trace for iterations
    [start_iteration, start_iteration + num_iterations); the trace goes
    to ``log_dir/trace.json``."""

    def __init__(self, log_dir: str, start_iteration: int = 2,
                 num_iterations: int = 3):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self._active = False
        self._done = False
        self._prof = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration: int, score: float):
        if self._done:
            return
        if not self._active and iteration >= self.start_iteration:
            self._start()
            self._stop_at = iteration + self.num_iterations
            return
        if self._active and iteration >= self._stop_at:
            self._stop()

    def on_epoch_end(self, model, epoch: int):
        # never leave a trace open across epochs
        self._stop()

    def close(self):
        """Invoked from the fit loops' finally: a fit() that raises or
        ends before _stop_at must not leak an open trace. Idempotent."""
        self._stop()

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._active = True

    def _stop(self):
        if not self._active:
            return
        self._active = False
        self._done = True
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.log_dir, exist_ok=True)
            self.trace_path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(self.trace_path)
            log.info("profiler trace written to %s", self.trace_path)
        except Exception:  # noqa: BLE001 — closing a dead trace must not
            log.warning("profiler stop failed", exc_info=True)  # mask fit
        finally:
            self._prof = None


class TimingListener(TrainingListener):
    """Wall-clock iteration timing with simple section accounting
    (ref: PerformanceListener ETL-time measurement,
    MultiLayerNetwork.java:1203-1209). The fit loops do not wait for
    the card between iterations, so on the card it times the host's
    enqueue, and under ``steps_per_dispatch=K`` the K iterations of a
    group arrive together after their one dispatch."""

    def __init__(self, window: int = 50):
        self.window = window
        self.iteration_ms: List[float] = []
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int, score: float):
        now = time.perf_counter()
        if self._last is not None:
            self.iteration_ms.append((now - self._last) * 1000.0)
            if len(self.iteration_ms) > self.window:
                self.iteration_ms.pop(0)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.iteration_ms:
            return {}
        arr = sorted(self.iteration_ms)
        n = len(arr)
        return {
            "mean_ms": sum(arr) / n,
            "p50_ms": arr[n // 2],
            "p95_ms": arr[min(n - 1, int(n * 0.95))],
            "iterations": n,
        }


def annotate(name: str):
    """Named trace range for host-side code (shows up in the profiler's
    trace):

        with annotate("etl"):
            batch = next(it)
    """
    from torch.profiler import record_function
    return record_function(name)
