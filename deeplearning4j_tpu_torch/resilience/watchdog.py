"""The divergence watchdog: a training collapse becomes an exception a
recovery loop can catch.

Counterpart of ``deeplearning4j_tpu/resilience/watchdog.py``. The
sentinel (``sentinel.py``) makes one poisoned batch harmless; two
failures survive it: a lasting source of bad steps (every batch NaN, so
skipping freezes the parameters for good) and a divergence whose loss
stays finite. ``DivergenceWatchdog`` is a listener that checks both at
its own cadence, ``check_every`` iterations (its one host read: the
sentinel's accounting settled, then the score), and raises
:class:`DivergenceError`, which ``util.recovery.FaultTolerantTrainer``
answers with a rollback to the last good checkpoint:

- ``consecutive_bad >= max_consecutive_bad`` in the sentinel's
  accounting;
- a blow-up: the score above ``median + blowup_factor * max(|median|,
  abs_floor)`` of the last ``window`` finite scores taken at the
  cadence (once there are ``min_history`` of them).

Its window is durable state: a checkpoint carries it
(``durable_state`` / ``restore_durable_state``).
"""

from __future__ import annotations

import logging
from collections import deque
from statistics import median
from typing import Optional

from deeplearning4j_tpu_torch.monitoring import flightrecorder
from deeplearning4j_tpu_torch.monitoring.events import emit as emit_event
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.resilience import sentinel

log = logging.getLogger(__name__)

__all__ = ["DivergenceError", "DivergenceWatchdog"]


class DivergenceError(RuntimeError):
    """Training diverged (a run of bad steps, or a blow-up). ``limit``
    (a blow-up only) is the score limit that fired: a rollback skips
    checkpoints whose saved score was already past it."""

    def __init__(self, message: str, iteration: Optional[int] = None,
                 limit: Optional[float] = None):
        super().__init__(message)
        self.iteration = iteration
        self.limit = limit


class DivergenceWatchdog(TrainingListener):
    def __init__(self, max_consecutive_bad: int = 5,
                 blowup_factor: float = 25.0, window: int = 20,
                 min_history: int = 5, check_every: int = 10,
                 abs_floor: float = 0.1):
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        if blowup_factor <= 1.0:
            raise ValueError("blowup_factor must be > 1")
        if abs_floor <= 0.0:
            raise ValueError("abs_floor must be > 0")
        self.max_consecutive_bad = max_consecutive_bad
        self.blowup_factor = blowup_factor
        self.abs_floor = abs_floor
        self.min_history = max(2, min_history)
        self.check_every = max(1, check_every)
        self._scores = deque(maxlen=max(self.min_history, window))
        self._ticks = 0

    def reset(self) -> None:
        """Forget the history (after a rollback restored a good state)."""
        self._scores.clear()
        self._ticks = 0

    def durable_state(self) -> dict:
        """The score window and the cadence's phase, so a resumed run
        checks against the history a straight run holds."""
        return {"scores": [float(s) for s in self._scores],
                "ticks": int(self._ticks)}

    def restore_durable_state(self, state: dict) -> None:
        self._scores = deque((float(s) for s in state.get("scores", ())),
                             maxlen=self._scores.maxlen)
        self._ticks = int(state.get("ticks", 0))

    def iteration_done(self, model, iteration: int, score) -> None:
        self._ticks += 1
        if self._ticks % self.check_every:
            return
        acct = sentinel.flush_accounting(model)
        if acct is not None and \
                acct.consecutive_bad >= self.max_consecutive_bad:
            err = DivergenceError(
                f"{acct.consecutive_bad} consecutive non-finite train "
                f"steps (threshold {self.max_consecutive_bad}) — the "
                f"input or the step size is persistently poisoned",
                iteration=iteration)
            self._flight(err, iteration, kind="bad_steps")
            raise err
        s = float(score)    # a device scalar until here
        if s != s or s in (float("inf"), float("-inf")):
            return  # the sentinel's counts see non-finite scores
        if len(self._scores) >= self.min_history:
            base = median(self._scores)
            # around the median: live for losses near zero or negative
            limit = base + self.blowup_factor * max(abs(base),
                                                    self.abs_floor)
            if s > limit:
                err = DivergenceError(
                    f"loss {s:.4g} blew past the divergence limit "
                    f"{limit:.4g} (trailing-window median {base:.4g}, "
                    f"factor {self.blowup_factor:g})",
                    iteration=iteration, limit=limit)
                self._flight(err, iteration, kind="blowup",
                             score=s, limit=limit)
                raise err
        self._scores.append(s)

    def _flight(self, err: DivergenceError, iteration: Optional[int],
                **extra) -> None:
        """An event and a flight record where it fires: the rollback
        that follows erases the trajectory they keep."""
        emit_event("resilience", "divergence", iteration=iteration,
                   error=str(err), **extra)
        flightrecorder.maybe_dump(
            "divergence", error=err,
            extra={"iteration": iteration,
                   "score_window": [float(s) for s in self._scores],
                   **extra})
