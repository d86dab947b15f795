"""Deterministic fault injection for resilience tests: the training
injectors.

Counterpart of ``deeplearning4j_tpu/resilience/chaos.py``. Each injector
wraps a ``DataSetIterator`` (or sits under a
``pipeline.DevicePrefetchIterator``, where it fires in the worker
thread). Faults count batches in global order across passes, so "kill
at batch 7" is the eighth batch the run ever pulls, wherever the epoch
boundary falls; with ``once=True`` (the default) a fault fires once and
the stream then goes on normally. Injectors are plain iterator objects,
not generators: a raise out of ``__next__`` does not end the stream, so
a retry layer can call ``next()`` again and get the batch the failed
pull would have given.

- ``RaiseOnBatch``: raise before global batch n (flaky input, a dead
  shard); ``FaultBurstInjector``: exactly k faults from batch n on;
- ``NaNPoisonIterator``: batch n's features (or labels) made non-finite
  (the sentinel's adversary);
- ``LatencyIterator``: a sleep before chosen batches;
- ``PreemptionIterator``: ``SimulatedPreemption`` before batch n;
- ``ProcessKillInjector``: a real signal (SIGKILL by default) to this
  process before batch n: nothing runs after it, so it proves what a
  checkpoint already put on disk;
- :func:`fire` drives an injector outside an iterator.

The serving engine's seams (``prefill_chaos``, ``decode_chaos``,
``seat_chaos``) take any of them through :func:`fire`, one event per
admission or dispatch; two injectors are the engine's own:

- ``RequestFaultInjector``: a fault aimed at requests chosen by content
  (the admission seams pass the request as the event's context);
- ``PageExhaustionInjector``: seizes the paged engine's free KV pages.

The multi-host and fleet injectors refuse at construction, naming their
ROADMAP.md items: ``HostLossInjector`` (A9), ``LeaseStallInjector`` and
the ``MailboxInjector`` family (A10).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterator, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

__all__ = ["ChaosIterator", "DelayedDeliveryInjector",
           "DuplicateDeliveryInjector", "FaultBurstInjector",
           "HostLossInjector", "InjectedFault", "LatencyIterator",
           "LeaseStallInjector", "MailboxInjector",
           "NaNPoisonIterator", "PageExhaustionInjector",
           "PreemptionIterator", "ProcessKillInjector", "RaiseOnBatch",
           "RequestFaultInjector", "SimulatedPreemption",
           "TornCommandInjector", "fire"]


def fire(injector, index: int, ctx=None) -> None:
    """Drive an injector outside an iterator: its ``before_batch(index)``
    (``before_event(index, ctx)`` where it has one), which may raise or
    sleep, as ``_Cursor`` calls it for a wrapped iterator; the global
    count moves past ``index`` on success. A bare callable is called
    with the index; None does nothing."""
    if injector is None:
        return
    if not hasattr(injector, "before_batch"):
        injector(index)
        return
    if hasattr(injector, "before_event"):
        injector.before_event(index, ctx)
    else:
        injector.before_batch(index)
    injector.batches_seen = max(injector.batches_seen, index + 1)


class InjectedFault(RuntimeError):
    """The exception ``RaiseOnBatch`` raises by default."""


class SimulatedPreemption(RuntimeError):
    """A SIGTERM-style kill in the middle of an epoch."""


class ChaosIterator(DataSetIterator):
    """The base injector: global batch counting, the once latch, reset
    passed through. Subclasses override ``before_batch`` (may raise;
    the base batch is not consumed, so a retry gets it) and / or
    ``transform`` (rewrites the batch about to be yielded). ``base`` may
    be None where :func:`fire` drives it."""

    def __init__(self, base: Optional[DataSetIterator], once: bool = True):
        self.base = base
        self.once = once
        self.batches_seen = 0
        self.faults_fired = 0

    def reset(self):
        self.base.reset()

    def before_batch(self, index: int) -> None:
        """Called with the global index of the batch about to be
        pulled."""

    def transform(self, ds: DataSet, index: int) -> DataSet:
        return ds

    def _fire(self) -> bool:
        """The latch: whether a fault may fire now (``once``)."""
        if self.once and self.faults_fired:
            return False
        self.faults_fired += 1
        return True

    def __iter__(self) -> Iterator[DataSet]:
        return _Cursor(self)


class _Cursor:
    """An iterator object, not a generator, so an injected raise does
    not end the pass."""

    def __init__(self, chaos: ChaosIterator):
        self._chaos = chaos
        self._it = iter(chaos.base)

    def __iter__(self):
        return self

    def __next__(self) -> DataSet:
        c = self._chaos
        c.before_batch(c.batches_seen)  # may raise; nothing consumed yet
        ds = next(self._it)
        out = c.transform(ds, c.batches_seen)
        c.batches_seen += 1
        return out


class RaiseOnBatch(ChaosIterator):
    """Raise ``exc()`` before global batch ``n`` (0-based); with
    ``once=False`` every pull of batch ``n + k * period`` fails (period
    0: the same index every time, for proving a bounded retry gives
    up)."""

    def __init__(self, base: DataSetIterator, n: int,
                 exc: Callable[[], BaseException] = InjectedFault,
                 once: bool = True, period: int = 0):
        super().__init__(base, once=once)
        self.n = int(n)
        self.exc = exc
        self.period = int(period)

    def before_batch(self, index: int) -> None:
        hit = index == self.n or (
            self.period > 0 and index > self.n
            and (index - self.n) % self.period == 0)
        if hit and self._fire():
            raise self.exc()


class FaultBurstInjector(ChaosIterator):
    """Exactly ``k`` faults from event ``n`` on (only inside ``[n, n +
    window)`` when ``window`` is set), then a clean stream. It counts
    faults fired, not indices: a seam whose index moves only on success
    presents the same index again after each fault."""

    def __init__(self, base: Optional[DataSetIterator] = None,
                 n: int = 0, k: int = 3,
                 exc: Callable[[], BaseException] = InjectedFault,
                 window: Optional[int] = None):
        super().__init__(base, once=False)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.n = int(n)
        self.k = int(k)
        self.exc = exc
        self.window = None if window is None else int(window)

    def before_batch(self, index: int) -> None:
        if index < self.n:
            return
        if self.window is not None and index >= self.n + self.window:
            return
        if self.faults_fired < self.k:
            self.faults_fired += 1
            raise self.exc()


class NaNPoisonIterator(ChaosIterator):
    """Batch ``n``'s (or each of ``n``'s) features, or labels, replaced
    by ``value``. The batch keeps its shapes and masks, so a K-step
    group takes it like any other: the sentinel must skip it inside the
    group."""

    def __init__(self, base: DataSetIterator,
                 n: Union[int, Sequence[int]] = 0,
                 field: str = "features", value: float = np.nan):
        super().__init__(base, once=False)
        if field not in ("features", "labels"):
            raise ValueError(f"field must be features|labels, got {field!r}")
        self.targets = {int(n)} if isinstance(n, (int, np.integer)) \
            else {int(i) for i in n}
        self.field = field
        self.value = value

    def _poison(self, arr):
        if arr is None:
            return None
        if isinstance(arr, dict):
            return {k: self._poison(v) for k, v in arr.items()}
        out = np.array(arr, dtype=np.asarray(arr).dtype, copy=True)
        out[...] = self.value
        return out

    def transform(self, ds: DataSet, index: int) -> DataSet:
        if index not in self.targets:
            return ds
        f, lab = ds.features, ds.labels
        if self.field == "features":
            f = self._poison(f)
        else:
            lab = self._poison(lab)
        out = DataSet(f, lab, ds.features_mask, ds.labels_mask)
        real = getattr(ds, "real_examples", None)
        if real is not None:
            out.real_examples = real
        return out


class LatencyIterator(ChaosIterator):
    """A sleep of ``seconds`` before every ``every``-th batch from
    ``start`` on (an input stall)."""

    def __init__(self, base: DataSetIterator, seconds: float,
                 every: int = 1, start: int = 0):
        super().__init__(base, once=False)
        self.seconds = float(seconds)
        self.every = max(1, int(every))
        self.start = int(start)

    def before_batch(self, index: int) -> None:
        if index >= self.start and (index - self.start) % self.every == 0:
            time.sleep(self.seconds)


class PreemptionIterator(RaiseOnBatch):
    """``SimulatedPreemption`` before global batch ``n``, once: a rerun
    of the fit (a ``FaultTolerantTrainer`` restart) goes on from its
    checkpoint."""

    def __init__(self, base: DataSetIterator, n: int):
        super().__init__(base, n, exc=SimulatedPreemption, once=True)


class ProcessKillInjector(ChaosIterator):
    """A real signal (default SIGKILL: no handler, no ``finally``, no
    ``atexit``) to this process before global batch ``n``, ``delay``
    seconds after reaching it. Run a fit in a subprocess with it, then
    prove from the parent that what was committed is intact and that a
    resume finishes the run."""

    def __init__(self, base: DataSetIterator, n: int,
                 sig: int = 9, delay: float = 0.0):
        super().__init__(base, once=True)
        self.n = int(n)
        self.sig = int(sig)
        self.delay = float(delay)

    def before_batch(self, index: int) -> None:
        if index >= self.n and self._fire():
            if self.delay:
                time.sleep(self.delay)
            os.kill(os.getpid(), self.sig)
            # SIGKILL never returns; a catchable signal's handler gets a
            # moment before the stream goes on
            time.sleep(0.5)


def _refuse(name: str, item: str, what: str):
    raise NotImplementedError(f"{name}: {what} is not ported yet "
                              f"(ROADMAP.md {item})")


class RequestFaultInjector(ChaosIterator):
    """A fault aimed at REQUESTS rather than event indices: the serving
    seams (prefill admission, the pop-to-seat window) pass the
    ``GenerationRequest`` being processed as the event context, and
    ``match(request)`` picks the victims (by prompt, priority, deadline,
    identity), wherever in the admission order they land. ``once=True``
    (the default) faults the first match only."""

    def __init__(self, match: Callable[[object], bool],
                 exc: Callable[[], BaseException] = InjectedFault,
                 base: Optional[DataSetIterator] = None,
                 once: bool = True):
        super().__init__(base, once=once)
        self.match = match
        self.exc = exc

    def before_event(self, index: int, ctx) -> None:
        if ctx is None:
            return
        if self.match(ctx) and self._fire():
            raise self.exc()


class PageExhaustionInjector(ChaosIterator):
    """Force the serving engine's free KV-page pool down to
    ``free_target`` pages before dispatch ``n`` (pass it as the engine's
    ``decode_chaos``: one event per decode dispatch).

    ``pool`` is the paged engine's ``PagePool`` (``engine.page_pool``):
    the injector SEIZES free pages and never touches allocated ones, so
    active requests keep their pages and complete as an unperturbed run
    does, while new admissions head-block (or time out, or fail fast)
    until ``release()`` returns the seized pages. Seizure is host-side
    page-id accounting, so an int8 pool's bytes and scale rows never
    move. A supervisor's rebuild replaces the pool, and the seizure dies
    with the old one."""

    def __init__(self, pool, n: int, free_target: int = 0,
                 once: bool = True):
        super().__init__(None, once=once)
        self.pool = pool
        self.n = int(n)
        self.free_target = int(free_target)

    def before_batch(self, index: int) -> None:
        if index >= self.n and self._fire():
            self.pool.seize(self.pool.free_count() - self.free_target)

    def release(self) -> None:
        """Return every seized page to the pool (the incident ends)."""
        self.pool.restore()


class HostLossInjector(ProcessKillInjector):
    """Kills one rank of a multi-host run: comes with the elastic
    trainer (ROADMAP.md A9)."""

    def __init__(self, *args, **kwargs):
        _refuse(type(self).__name__, "A9", "elastic multi-host training")


class LeaseStallInjector(ChaosIterator):
    """Freezes a host's lease heartbeats: comes with the serving fleet's
    membership (ROADMAP.md A10)."""

    def __init__(self, *args, **kwargs):
        _refuse(type(self).__name__, "A10", "the serving fleet's leases")


class MailboxInjector:
    """Faults on the serving fleet's command transport: come with the
    fleet (ROADMAP.md A10)."""

    def __init__(self, *args, **kwargs):
        _refuse(type(self).__name__, "A10",
                "the serving fleet's command transport")


class TornCommandInjector(MailboxInjector):
    """A torn command file (ROADMAP.md A10)."""


class DuplicateDeliveryInjector(MailboxInjector):
    """A command delivered twice (ROADMAP.md A10)."""


class DelayedDeliveryInjector(MailboxInjector):
    """Commands withheld until released (ROADMAP.md A10)."""
