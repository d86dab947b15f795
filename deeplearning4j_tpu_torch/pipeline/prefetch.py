"""Device-side input pipeline: H2D prefetch ahead of the consumer.

Counterpart of ``deeplearning4j_tpu/pipeline/prefetch.py``. The fit
loop's per-batch copy from pageable host memory stages the transfer on
the consumer thread while the card waits for it.
``DevicePrefetchIterator`` moves the copy into a bounded background
stage that runs ``prefetch`` batches ahead of the consumer, so the
transfer of batches N+1..N+depth overlaps the compute of batch N.

On the card the stage is a pinned staging ring with a copy stream, where
the JAX package calls ``jax.device_put``:

- the worker thread binds the consumer's device and owns one
  ``torch.cuda.Stream``;
- it copies each array into a page-locked host buffer of its ring slot,
  then into a new device tensor with ``non_blocking=True`` on that
  stream, and records a CUDA event after the batch's copies;
- a slot's pinned buffer is written again only after the event of the
  copy that read it (the worker waits on it);
- before the consumer first uses a batch, its current stream waits on
  the batch's event, and each tensor handed over is marked
  ``record_stream(consumer stream)``, so the caching allocator does not
  recycle its memory (allocated on the copy stream) while the step
  still reads it.

On the CPU the stage makes host tensors, with no pinning and no
streams. The stop/sentinel/error protocol is the JAX module's: a
bounded ``put`` with a stop check so an abandoned consumer cannot pin
the worker, a sentinel that carries end-of-stream, and a worker error
(a base-iterator failure, optionally retried through
``resilience.retry``) re-raised in the consumer.

Telemetry (global metrics registry, monitoring/), the JAX series:

- ``dl4jtpu_prefetch_queue_depth`` (gauge): batches staged ahead of the
  consumer.
- ``dl4jtpu_prefetch_h2d_bytes_total`` (counter): host bytes handed to
  the stage's transfers.
- ``dl4jtpu_prefetch_batches_total`` (counter): batches transferred.

torch's CUDA state is touched only in the worker and at the hand-over,
so constructing the iterator initialises nothing.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.pipeline.padding import (
    num_real_examples, pad_batch)
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call

log = logging.getLogger(__name__)

PREFETCH_DEPTH = "dl4jtpu_prefetch_queue_depth"
PREFETCH_BYTES = "dl4jtpu_prefetch_h2d_bytes_total"
PREFETCH_BATCHES = "dl4jtpu_prefetch_batches_total"

__all__ = ["DevicePrefetchIterator", "PREFETCH_BATCHES", "PREFETCH_BYTES",
           "PREFETCH_DEPTH", "batch_arrays", "declare_prefetch_series",
           "handover", "map_batch", "prefetch_bytes_total"]


def _series(registry: Optional[MetricsRegistry] = None):
    r = registry or global_registry()
    return (r.gauge(PREFETCH_DEPTH,
                    "Batches staged on device ahead of the consumer"),
            r.counter(PREFETCH_BYTES,
                      "Host->device bytes moved by prefetch stages"),
            r.counter(PREFETCH_BATCHES,
                      "Batches transferred by prefetch stages"))


def declare_prefetch_series(registry: Optional[MetricsRegistry] = None
                            ) -> None:
    """Declare the stage's series (``monitoring.ensure_started``)."""
    _series(registry)


def batch_arrays(ds: DataSet):
    """The arrays of a batch, dicts flattened, in a fixed order."""
    out = []
    for x in (ds.features, ds.labels, ds.features_mask, ds.labels_mask):
        if isinstance(x, dict):
            out += [x[k] for k in sorted(x)]
        elif x is not None:
            out.append(x)
    return out


def map_batch(fn, ds: DataSet) -> DataSet:
    """The batch with ``fn`` applied to each of its arrays, in
    :func:`batch_arrays`' order (dicts keep their keys, sorted)."""
    def tree(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: tree(x[k]) for k in sorted(x)}
        return fn(x)
    return DataSet(tree(ds.features), tree(ds.labels),
                   tree(ds.features_mask), tree(ds.labels_mask))


def _host(x) -> np.ndarray:
    """A batch array as the contiguous numpy array the network takes
    (float64 becomes float32, the network's input dtype)."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.astype(np.float32) if a.dtype == np.float64 else a


def handover(ds: DataSet, stream=None) -> DataSet:
    """Make a staged batch safe to use on ``stream`` (default: the
    current stream of its device): the stream waits on the batch's copy
    event, and each tensor is marked as used there. A batch of host
    tensors passes through."""
    ev = getattr(ds, "copy_event", None)
    if ev is None:
        return ds
    tensors = [t for t in batch_arrays(ds) if torch.is_tensor(t)]
    s = stream or torch.cuda.current_stream(tensors[0].device)
    s.wait_event(ev)
    for t in tensors:
        t.record_stream(s)
    return ds


class _BaseIteratorDead(Exception):
    """A generator-backed base died on an error: retrying can never
    succeed. Deliberately NOT a typical retry_on type, so the retry
    layer propagates it immediately instead of burning its backoff
    budget on a corpse."""

    def __init__(self, original: BaseException):
        super().__init__(repr(original))
        self.original = original


def _nbytes(x) -> int:
    if x is None:
        return 0
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    n = getattr(x, "nbytes", None)
    return int(n) if n is not None else 0


def prefetch_bytes_total(registry: Optional[MetricsRegistry] = None) -> float:
    """Total H2D bytes moved by prefetch stages this process (0.0 before
    any ran). Pure registry read — safe on bench failure paths."""
    r = registry or global_registry()
    c = r.get(PREFETCH_BYTES)
    if c is None:
        return 0.0
    try:
        return float(c.value())
    except Exception:  # noqa: BLE001 — a metrics read must never raise here
        return 0.0


class DevicePrefetchIterator(DataSetIterator):
    """Background device-transfer stage over a base DataSetIterator.

    Args:
        base: the host-side iterator to consume.
        prefetch: queue depth — how many batches may sit transferred (or
            in flight) ahead of the consumer. 2 = double buffering.
        mesh / data_axis: placing batches on a device mesh is not
            ported yet (ROADMAP.md A9): either given raises.
        transform: optional host-side ``DataSet -> DataSet`` hook run in
            the worker before the transfer.
        pad_to: tail-batch bucketing in the pipeline stage: an int pads
            every smaller batch to that row count (``pipeline.padding``
            mask semantics); ``"auto"`` uses the first batch of each
            pass as the canonical size. Padding here — BEFORE the
            transfer — keeps the fit loop from ever padding
            device-resident arrays (a D2H round-trip).
        pad_when: optional host-side predicate gating `pad_to` per
            batch (e.g. ComputationGraph's mask-shadowing exemption);
            batches it rejects pass through ragged.
        retry: optional ``resilience.retry.RetryPolicy`` — the worker
            retries a failed base-iterator pull (``policy.retry_on``
            exceptions only) with bounded backoff before surfacing the
            error, so a transiently flaky input source (remote FS
            hiccup, a lock-contended reader) doesn't kill the epoch.
        device: where the batches land (the network's device; default
            the CPU, where the stage makes host tensors).
    """

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2,
                 mesh=None, data_axis: Optional[str] = None,
                 transform: Optional[Callable[[DataSet], DataSet]] = None,
                 pad_to: Union[int, str, None] = None,
                 pad_when: Optional[Callable[[DataSet], bool]] = None,
                 retry: Optional[RetryPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device=None):
        if mesh is not None or data_axis is not None:
            raise NotImplementedError("a prefetch stage placing batches on "
                                      "a device mesh is not ported yet "
                                      "(ROADMAP.md A9)")
        if prefetch < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {prefetch}")
        if pad_to is not None and pad_to != "auto" and int(pad_to) < 1:
            raise ValueError(f"pad_to must be >= 1 or 'auto', got {pad_to}")
        self.base = base
        self.prefetch = prefetch
        self.device = torch.device("cpu" if device is None else device)
        self.transform = transform
        self.pad_to = pad_to
        self.pad_when = pad_when
        self.retry = retry
        self._registry = registry
        self._last_thread: Optional[threading.Thread] = None
        # most recent worker error of the most recent pass (a list cell so
        # the worker thread appends instead of assigning shared state);
        # consult it when a pass ended early after an abandoned consumer
        self._err_holder: List[BaseException] = []
        # durable-cursor bookkeeping: CONSUMER-side position (the worker
        # pulls ahead of the fit loop, so the base iterator's own
        # counters overstate what training actually consumed)
        self._pass_index = 0
        self._consumed = 0
        self._resume_pos = 0
        self._resume_armed = False
        self._in_pass = False

    @property
    def last_worker_error(self) -> Optional[BaseException]:
        """Error that killed the most recent pass's worker, if any —
        ALSO set when the consumer was already gone, so an error can
        never vanish silently (worker-shutdown audit)."""
        return self._err_holder[0] if self._err_holder else None

    def reset(self):
        self.base.reset()

    # -- durable cursor (see datasets.iterators.DataSetIterator) --------
    def state(self):
        """Consumer-visible cursor: batches the FIT LOOP pulled, not the
        (further ahead) batches the worker staged — the difference is
        exactly the prefetch depth, which must be re-transferred on
        resume, not skipped."""
        if self._resume_armed:
            return {"epoch": self._pass_index, "pos": self._resume_pos}
        if self._in_pass:
            return {"epoch": self._pass_index - 1, "pos": self._consumed}
        # between (or before any) passes: the BASE owns the pass index —
        # a fresh wrapper's local counter is 0 even when the base was
        # aligned/advanced to a later epoch, and the next pass seeds its
        # shuffle from the base's counter (see __iter__)
        state_fn = getattr(self.base, "state", None)
        if state_fn is not None:
            try:
                return {"epoch": int(state_fn()["epoch"]), "pos": 0}
            except Exception:  # noqa: BLE001 — cursor read is best-effort
                pass
        return {"epoch": self._pass_index, "pos": 0}

    def restore_state(self, state):
        """Delegates to the base iterator (the stage is a 1:1 per-batch
        transform, so consumer position == base position); requires the
        base to support the cursor protocol."""
        restore = getattr(self.base, "restore_state", None)
        if restore is None:
            raise NotImplementedError(
                f"prefetch base {type(self.base).__name__} has no "
                f"restore_state(): cannot fast-forward exactly")
        restore(state)
        self._pass_index = int(state.get("epoch", 0))
        self._resume_pos = int(state.get("pos", 0))
        self._resume_armed = True
        self._in_pass = False

    # ------------------------------------------------------------------
    def _stage(self, ds: DataSet, ring, slot: int) -> DataSet:
        """The batch as tensors on the stage's device. On the card: the
        i-th array of the batch through pinned buffer i of slot ``slot``
        of ``ring`` (written only once the slot's last copies finished)
        into a new device tensor on the current (copy) stream, then the
        batch's copy event recorded; on the CPU: host tensors."""
        cuda = self.device.type == "cuda"
        if cuda:
            bufs, ev = ring[slot]
            if ev is not None:
                ev.synchronize()
        index = [0]

        def put(x):
            a = _host(x)
            if not cuda:
                return torch.from_numpy(a.copy())
            key = (index[0], a.shape, a.dtype.str)
            index[0] += 1
            pinned = bufs.get(key)
            if pinned is None:
                pinned = bufs[key] = torch.from_numpy(a).pin_memory()
            else:
                pinned.numpy()[...] = a
            dev = torch.empty(a.shape, dtype=pinned.dtype,
                              device=self.device)
            dev.copy_(pinned, non_blocking=True)
            return dev

        out = map_batch(put, ds)
        out.real_examples = num_real_examples(ds)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            ring[slot] = (bufs, ev)
            out.copy_event = ev
        return out

    # ------------------------------------------------------------------
    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        self._err_holder = err  # publish THIS pass's error slot
        # cursor bookkeeping: a restored pass starts mid-stream; an
        # UNRESTORED pass takes its index from the BASE iterator's own
        # cursor when it exposes one — the base drives the shuffle seed,
        # and its passes need not start at 0 (fit aligns internal
        # iterators to the absolute epoch count)
        if self._resume_armed:
            self._resume_armed = False
            start_pass = self._pass_index
        else:
            start_pass = self._pass_index
            state_fn = getattr(self.base, "state", None)
            if state_fn is not None:
                try:
                    start_pass = int(state_fn()["epoch"])
                except Exception:  # noqa: BLE001 — labeling is best-effort
                    pass
        self._consumed = self._resume_pos
        self._resume_pos = 0
        self._pass_index = start_pass + 1
        self._in_pass = True
        stop = threading.Event()
        depth, h2d_bytes, batches = _series(self._registry)
        # canonical row count for this pass ("auto" resolves per pass so
        # a re-iterated epoch re-locks onto its own first batch)
        target = [self.pad_to if isinstance(self.pad_to, int) else None]
        _done = object()

        def worker():
            delivered = False  # sentinel actually enqueued
            try:
                import types
                import contextlib

                ring = [({}, None) for _ in range(self.prefetch + 1)]
                staged = [0]
                stream_ctx = contextlib.nullcontext()
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                    stream_ctx = torch.cuda.stream(
                        torch.cuda.Stream(self.device))

                it = iter(self.base)
                # only GENERATORS die on their first error; an object
                # iterator that raised can legitimately continue — or
                # legitimately end — on the next pull
                gen_backed = isinstance(it, types.GeneratorType)
                failed: List[BaseException] = []

                def pull():
                    # StopIteration must not hit the retry layer (a
                    # retry_on of Exception would "retry" end-of-stream)
                    try:
                        ds = next(it)
                    except StopIteration:
                        if failed and gen_backed:
                            # a generator-backed base dies on its first
                            # error: this StopIteration is the corpse,
                            # not a clean end-of-stream — surface the
                            # original failure (non-retryably: further
                            # attempts can never succeed) instead of
                            # silently truncating the epoch
                            raise _BaseIteratorDead(failed[0]) from None
                        return _done
                    except BaseException as e:
                        failed.append(e)
                        raise
                    failed.clear()
                    return ds

                while True:
                    if self.retry is None:
                        ds = pull()
                    else:
                        try:
                            ds = retry_call(pull, policy=self.retry,
                                            op="prefetch-pull")
                        except _BaseIteratorDead as e:
                            raise e.original from None
                    if ds is _done:
                        break
                    if self.transform is not None:
                        ds = self.transform(ds)
                    if self.pad_to is not None:
                        if target[0] is None:
                            target[0] = ds.num_examples()
                        if ds.num_examples() < target[0] and (
                                self.pad_when is None or self.pad_when(ds)):
                            ds = pad_batch(ds, target[0])
                    n = _nbytes(ds.features) + _nbytes(ds.labels) + \
                        _nbytes(ds.features_mask) + _nbytes(ds.labels_mask)
                    with stream_ctx:
                        dev = self._stage(ds, ring,
                                          staged[0] % len(ring))
                    staged[0] += 1
                    h2d_bytes.inc(n)
                    batches.inc()
                    # bounded put with a stop check so an abandoned
                    # consumer (early break) can't pin the worker forever
                    while not stop.is_set():
                        try:
                            q.put(dev, timeout=0.1)
                            depth.set(q.qsize())
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface worker errors to consumer
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        q.put(self._SENTINEL, timeout=0.1)
                        delivered = True
                        break
                    except queue.Full:
                        continue
                if err and not delivered:
                    # consumer left before the error could be handed over
                    # (stop beat the sentinel put): the guarantee is that
                    # no worker error ever vanishes — it stays readable on
                    # last_worker_error and lands in the log
                    log.warning("prefetch worker error after consumer "
                                "detached: %r", err[0])

        t = threading.Thread(target=worker, daemon=True,
                             name="device-prefetch")
        self._last_thread = t
        t.start()
        try:
            while True:
                try:
                    # bounded get + liveness check: if the worker died in
                    # a way that lost its sentinel (full queue + abandoned
                    # pass), the consumer must not block forever
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    if not t.is_alive():
                        # worker exited between our timeout and this
                        # check — it may have staged tail batches (and
                        # the sentinel) in that gap; drain them before
                        # settling, or the epoch silently loses batches
                        drained = []
                        while True:
                            try:
                                tail = q.get_nowait()
                            except queue.Empty:
                                break
                            if tail is self._SENTINEL:
                                break
                            drained.append(tail)
                        for tail in drained:
                            self._consumed += 1
                            yield handover(tail)
                        if err:
                            raise err[0]
                        self._in_pass = False
                        return  # worker gone, stream fully drained
                    continue
                depth.set(q.qsize())
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    self._in_pass = False
                    return
                self._consumed += 1
                yield handover(item)
        finally:
            # generator closed (break/GC): release the worker thread
            stop.set()
