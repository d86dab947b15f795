"""Fault-tolerant training: restart from checkpoints, roll back a
divergence.

Counterpart of ``deeplearning4j_tpu/util/recovery.py``::

    trainer = FaultTolerantTrainer(net, checkpoint_dir,
                                   save_every_n_iterations=100)
    trainer.fit(iterator, epochs=10)        # resumes by itself

- On entry the newest intact checkpoint is restored (trees, counters,
  the training generator, the data cursor) and the fit goes on from
  there; a ``CheckpointListener`` saves during it.
- A failure of a ``retry_on`` type restarts from the newest checkpoint,
  at most ``max_restarts`` times.
- A :class:`DivergenceError` (with ``watch_divergence=True`` a
  ``DivergenceWatchdog`` rides along) rolls back to the newest good
  checkpoint that predates it (tagged good by the sentinel and, for a
  blow-up, saved under the limit that fired; else any good one, else
  any), deletes the saves after it, multiplies the learning rate by
  ``lr_backoff`` and drops the step graph (the rate is a number its
  steps baked in), and resets the watchdog's and the sentinel's
  windows.
- The fit ends with a durable terminal save.

A resume is exact at epoch boundaries, and mid-epoch where the iterator
has the durable cursor (``state()`` / ``restore_state()``:
``ArrayDataSetIterator``, ``DevicePrefetchIterator`` over one); every
restore verifies the checkpoint's bytes and skips a corrupt one. This
trainer runs ``fit`` as the JAX one does, one step a batch.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple, Type

from deeplearning4j_tpu_torch.monitoring.events import emit as emit_event
from deeplearning4j_tpu_torch.monitoring.metrics import global_registry
from deeplearning4j_tpu_torch.resilience.durable import (
    CorruptCheckpointError, declare_checkpoint_series)
from deeplearning4j_tpu_torch.resilience.watchdog import (
    DivergenceError, DivergenceWatchdog)
from deeplearning4j_tpu_torch.util.checkpoint import (
    CheckpointListener, checkpoint_status, delete_checkpoint,
    list_checkpoints, list_good_checkpoints, restore_checkpoint)

__all__ = ["FaultTolerantTrainer", "RESTARTS"]

RESTARTS = "dl4jtpu_training_restarts_total"

log = logging.getLogger(__name__)


class FaultTolerantTrainer:
    def __init__(self, net, checkpoint_dir: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_epoch: bool = True, keep_last: int = 3,
                 max_restarts: int = 2,
                 retry_on: Tuple[Type[BaseException], ...] = (RuntimeError,),
                 watch_divergence: bool = False,
                 watchdog: Optional[DivergenceWatchdog] = None,
                 lr_backoff: Optional[float] = None,
                 async_save: bool = False):
        if lr_backoff is not None and not 0.0 < lr_backoff < 1.0:
            raise ValueError(f"lr_backoff must be in (0, 1), "
                             f"got {lr_backoff}")
        self.net = net
        self.dir = checkpoint_dir
        self.max_restarts = max_restarts
        self.retry_on = retry_on
        self.lr_backoff = lr_backoff
        self.watchdog = watchdog if watchdog is not None else (
            DivergenceWatchdog() if watch_divergence else None)
        self._listener = CheckpointListener(
            checkpoint_dir, save_every_n_iterations=save_every_n_iterations,
            save_every_epoch=save_every_epoch, keep_last=keep_last,
            async_save=async_save)
        if not save_every_epoch:
            log.warning(
                "iteration-only checkpoints: exact mid-epoch resume "
                "needs an iterator with the state()/restore_state() "
                "cursor protocol; others replay the interrupted epoch's "
                "consumed batches (approximate continuation)")

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until queued saves are durable: every recovery decision
        reads the disk, not a save in flight."""
        return self._listener.flush(timeout)

    def health(self) -> dict:
        return {"checkpoint_writer": self._listener.health(),
                "checkpoint_dir": self.dir,
                "max_restarts": self.max_restarts}

    # -- recovery ---------------------------------------------------------
    def _try_restore(self, step: int) -> bool:
        """Restore one candidate; a corrupt one is skipped (a warning and
        the counter), never raised in the middle of a recovery."""
        try:
            restore_checkpoint(self.net, self.dir, step=step)
            return True
        except CorruptCheckpointError as e:
            log.warning("checkpoint step %d failed integrity "
                        "verification (%s); skipping it for recovery",
                        step, e)
            declare_checkpoint_series()[4].inc()
            return False

    def resume_if_possible(self, only_good: bool = False) -> Optional[int]:
        """Restore the newest intact checkpoint (with ``only_good``, the
        newest the sentinel tagged good); returns its step, or None (a
        fresh start)."""
        self.flush()
        steps = (list_good_checkpoints(self.dir) if only_good
                 else list_checkpoints(self.dir))
        for step in reversed(steps):
            if self._try_restore(step):
                log.info("resumed from checkpoint step %d (epoch %d)%s",
                         step, self.net.epoch_count,
                         " [last good]" if only_good else "")
                return step
        return None

    def _rollback_candidates(self, cause: BaseException) -> list:
        """Newest first within each tier: good saves whose score is under
        the blow-up's limit, then any good save, then any save (a finite
        state on disk beats the diverged one in memory)."""
        good = list_good_checkpoints(self.dir)
        limit = getattr(cause, "limit", None)
        ordered: list = []
        if limit is not None:
            def saved_score(s):
                v = checkpoint_status(self.dir, s).get("score")
                return -float("inf") if v is None else v
            ordered += [s for s in reversed(good) if saved_score(s) <= limit]
        ordered += [s for s in reversed(good) if s not in ordered]
        ordered += [s for s in reversed(list_checkpoints(self.dir))
                    if s not in ordered]
        return ordered

    def _rollback(self, cause: BaseException) -> Optional[int]:
        """Restore the best intact state from before the divergence,
        delete the saves after it, back the learning rate off and reset
        the windows."""
        self.flush()
        step = None
        for cand in self._rollback_candidates(cause):
            if self._try_restore(cand):
                step = cand
                break
        if step is not None:
            emit_event("resilience", "rollback", step=step,
                       cause=repr(cause))
            log.info("rolled back to checkpoint step %d (epoch %d)",
                     step, self.net.epoch_count)
            # left on disk, a later restart would restore a diverged
            # save, and keep-last pruning would keep them over the new
            for stale in list_checkpoints(self.dir):
                if stale > step:
                    delete_checkpoint(self.dir, stale)
                    log.info("pruned post-divergence checkpoint step %d",
                             stale)
        if self.lr_backoff is not None:
            upd = self.net.conf.updater
            upd.learning_rate *= self.lr_backoff
            # a step graph baked the old rate in
            self.net._drop_step_graph()
            log.warning("divergence (%s): learning rate backed off to %g",
                        cause, upd.learning_rate)
        self._reset_windows()
        return step

    def _reset_windows(self) -> None:
        """Forget the watchdog's and the sentinel's history after any
        restore: an older, higher loss against the window of the run
        that diverged would trip the check again."""
        acct = getattr(self.net, "_sentinel_accounting", None)
        if acct is not None:
            acct.reset_window()
        if self.watchdog is not None:
            self.watchdog.reset()

    # -- training ---------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, batch_size: int = 32):
        """Train to ``epochs`` epochs in all (the restored state's
        included), restarting from the newest checkpoint on a transient
        failure and from the last good one on a divergence, at most
        ``max_restarts`` times."""
        listeners = getattr(self.net, "listeners", [])
        if self._listener not in listeners:
            self.net.add_listener(self._listener)
        if self.watchdog is not None and self.watchdog not in listeners:
            self.net.add_listener(self.watchdog)
        self.resume_if_possible()
        catch = (DivergenceError,) + tuple(self.retry_on)
        attempts = 0
        while True:
            remaining = epochs - self.net.epoch_count
            if remaining <= 0:
                log.info("target of %d epochs already reached", epochs)
                return self.net
            try:
                self.net.fit(data, labels=labels, epochs=remaining,
                             batch_size=batch_size)
                # a terminal save, durable before fit returns (unless the
                # epoch-end save just wrote this step)
                self.flush()
                steps = list_checkpoints(self.dir)
                if not steps or steps[-1] != self.net.iteration_count:
                    self._listener._save(self.net,
                                         self.net.iteration_count)
                    self.flush()
                return self.net
            except catch as e:
                attempts += 1
                if attempts > self.max_restarts:
                    log.error("giving up after %d restarts", attempts - 1)
                    raise
                cause = "divergence" if isinstance(e, DivergenceError) \
                    else "transient"
                global_registry().counter(
                    RESTARTS, "In-process training restarts from checkpoint",
                    ("cause",)).inc(cause=cause)
                emit_event("resilience", "restart", attempt=attempts,
                           cause=cause, error=repr(e))
                log.warning("training failed (%s); restart %d/%d from "
                            "latest checkpoint", e, attempts,
                            self.max_restarts)
                if isinstance(e, DivergenceError):
                    restored = self._rollback(e)
                    if restored is None and self.lr_backoff is None:
                        # nothing to rewind to and nothing changed: every
                        # restart would diverge again
                        log.error("divergence with no checkpoint to "
                                  "roll back to and no lr_backoff "
                                  "configured — not retrying")
                        raise
                else:
                    restored = self.resume_if_possible()
                    self._reset_windows()
                if restored is None:
                    log.warning("no checkpoint yet — restarting from "
                                "current in-memory state")
