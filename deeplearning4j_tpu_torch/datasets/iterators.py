"""DataSet iterators.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py``, each
iterator yielding the JAX package's batches in the same order for the
same seed: ``ArrayDataSetIterator`` (the in-memory iterator ``fit``
builds; a pass ``e`` shuffles with ``np.random.default_rng(seed + e)``)
with the durable cursor (``state()`` / ``restore_state()``, which a
checkpoint's data cursor resumes exactly), ``ExistingDataSetIterator``,
``AsyncDataSetIterator`` (a host thread and a bounded queue),
``BenchmarkDataSetIterator``, ``MultipleEpochsIterator``,
``EarlyTerminationDataSetIterator``, ``SamplingDataSetIterator``,
``JointParallelDataSetIterator`` and
``FileSplitParallelDataSetIterator``. The device prefetch stage is
``pipeline/prefetch.py``; the fault injectors are
``resilience/chaos.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, _sel

__all__ = ["ArrayDataSetIterator", "AsyncDataSetIterator",
           "BenchmarkDataSetIterator", "DataSetIterator",
           "EarlyTerminationDataSetIterator", "ExistingDataSetIterator",
           "FileSplitParallelDataSetIterator", "JointParallelDataSetIterator",
           "MultipleEpochsIterator", "SamplingDataSetIterator"]


class DataSetIterator:
    """Iterator protocol: ``reset`` and iteration.

    The durable cursor (optional; ``resilience/durable.py``): an
    iterator that can resume a pass exactly has

    - ``state() -> {"epoch": int, "pos": int}``: the pass index and the
      batches already handed out in it;
    - ``restore_state(state)``: the next ``__iter__`` runs pass
      ``state["epoch"]`` (the same shuffle as an uninterrupted run) and
      skips its first ``state["pos"]`` batches.

    A checkpoint resumes a fit killed mid-pass through it bit for bit;
    iterators without it replay the interrupted pass."""

    def reset(self):
        pass

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError


def _as_arrays(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: np.asarray(v) for k, v in x.items()}
    return np.asarray(x)


def _num_examples(x):
    if isinstance(x, dict):
        return next(iter(x.values())).shape[0]
    return x.shape[0]


class ArrayDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays (or dicts of arrays keyed by input /
    output name)."""

    def __init__(self, features, labels=None, batch_size: int = 32,
                 features_mask=None, labels_mask=None, shuffle: bool = False,
                 seed: int = 0):
        self.features = _as_arrays(features)
        self.labels = _as_arrays(labels)
        self.features_mask = _as_arrays(features_mask)
        self.labels_mask = _as_arrays(labels_mask)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pos = 0           # batches handed out in the current pass
        self._in_pass = False
        self._resume = None     # (epoch, pos) pending from restore_state

    def state(self):
        """The cursor: a pending restore until a pass takes it, the
        position of a running pass, else the start of the next pass."""
        if self._resume is not None:
            return {"epoch": self._resume[0], "pos": self._resume[1]}
        if self._in_pass:
            return {"epoch": self._epoch - 1, "pos": self._pos}
        return {"epoch": self._epoch, "pos": 0}

    def restore_state(self, state):
        """The next pass runs pass ``state["epoch"]`` (its shuffle) and
        skips its first ``state["pos"]`` batches."""
        self._resume = (int(state.get("epoch", 0)), int(state.get("pos", 0)))

    def __iter__(self):
        if self._resume is not None:
            epoch, start = self._resume
            self._resume = None
        else:
            epoch, start = self._epoch, 0
        n = _num_examples(self.features)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self._seed + epoch).shuffle(idx)
        self._epoch = epoch + 1
        self._in_pass = True
        self._pos = start
        for bi, s in enumerate(range(start * self.batch_size, n,
                                     self.batch_size), start):
            sel = idx[s:s + self.batch_size]
            # counted before the yield: while the fit holds batch bi the
            # cursor already counts it as handed out
            self._pos = bi + 1
            yield DataSet(_sel(self.features, sel), _sel(self.labels, sel),
                          _sel(self.features_mask, sel),
                          _sel(self.labels_mask, sel))
        self._in_pass = False


class ExistingDataSetIterator(DataSetIterator):
    """A list (or iterable) of DataSets."""

    def __init__(self, datasets: Sequence[DataSet]):
        self.datasets = list(datasets)

    def __iter__(self):
        return iter(self.datasets)


class AsyncDataSetIterator(DataSetIterator):
    """Pulls the base iterator on a host thread, ``prefetch`` batches
    ahead through a bounded queue; the batches stay host arrays (the
    device stage is ``pipeline.DevicePrefetchIterator``). A worker error
    is raised to the consumer; a consumer that stops early releases the
    worker."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, prefetch: int = 2):
        self.base = base
        self.prefetch = prefetch

    def reset(self):
        self.base.reset()

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for ds in self.base:
                    if not put(ds):
                        return
            except BaseException as e:  # raised to the consumer
                err.append(e)
            finally:
                put(self._SENTINEL)

        threading.Thread(target=worker, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            stop.set()


class BenchmarkDataSetIterator(DataSetIterator):
    """One seeded synthetic batch (standard-normal features, one-hot
    labels), yielded ``total_batches`` times: a harness measures the
    training loop, not data generation."""

    def __init__(self, features_shape, num_labels: int, total_batches: int,
                 seed: int = 42):
        rng = np.random.default_rng(seed)
        n = features_shape[0]
        x = rng.standard_normal(features_shape).astype(np.float32)
        y = np.zeros((n, num_labels), np.float32)
        y[np.arange(n), rng.integers(0, num_labels, n)] = 1.0
        self.batch = DataSet(x, y)
        self.total_batches = total_batches

    def __iter__(self):
        for _ in range(self.total_batches):
            yield self.batch


class MultipleEpochsIterator(DataSetIterator):
    """The base iterator's passes, ``epochs`` times (reset before each)."""

    def __init__(self, epochs: int, base: DataSetIterator):
        self.epochs = epochs
        self.base = base

    def __iter__(self):
        for _ in range(self.epochs):
            self.base.reset()
            yield from self.base


class EarlyTerminationDataSetIterator(DataSetIterator):
    """At most ``max_batches`` batches of the base iterator a pass."""

    def __init__(self, base: DataSetIterator, max_batches: int):
        self.base = base
        self.max_batches = max_batches

    def reset(self):
        self.base.reset()

    def __iter__(self):
        for i, ds in enumerate(self.base):
            if i >= self.max_batches:
                return
            yield ds


class SamplingDataSetIterator(DataSetIterator):
    """``total_batches`` batches of ``batch_size`` rows drawn with
    replacement from a whole DataSet, from ``np.random.default_rng(seed)``
    each pass."""

    def __init__(self, full: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        self.full = full
        self.batch_size = batch_size
        self.total_batches = total_batches
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        n = self.full.num_examples()
        for _ in range(self.total_batches):
            sel = rng.integers(0, n, self.batch_size)
            yield DataSet(
                self.full.features[sel],
                None if self.full.labels is None else self.full.labels[sel])


class JointParallelDataSetIterator(DataSetIterator):
    """Several iterators interleaved batch by batch; stops at the first
    exhausted one, or with ``stop_on_first_exhausted=False`` goes on
    through the longest."""

    def __init__(self, *iterators, stop_on_first_exhausted: bool = True):
        if not iterators:
            raise ValueError("need at least one iterator")
        self.iterators = list(iterators)
        self.stop_on_first_exhausted = stop_on_first_exhausted

    def reset(self):
        for it in self.iterators:
            it.reset()

    def __iter__(self):
        its = [iter(i) for i in self.iterators]
        alive = [True] * len(its)
        while any(alive):
            for k, it in enumerate(its):
                if not alive[k]:
                    continue
                try:
                    yield next(it)
                except StopIteration:
                    alive[k] = False
                    if self.stop_on_first_exhausted:
                        return


class FileSplitParallelDataSetIterator(DataSetIterator):
    """Batches from a directory of ``.npy`` / ``.npz`` files (in name
    order), each decoded by a thread pool up to ``2 * num_threads``
    files ahead. An ``.npz`` holds ``features`` and optionally
    ``labels``; an ``.npy`` features only."""

    def __init__(self, root_dir: str, pattern: str = "*.np[yz]",
                 batch_size: int = 32, num_threads: int = 2):
        import fnmatch
        self.paths = sorted(
            os.path.join(root_dir, f) for f in os.listdir(root_dir)
            if fnmatch.fnmatch(f, pattern))
        if not self.paths:
            raise FileNotFoundError(
                f"no files matching {pattern!r} under {root_dir!r}")
        self.batch_size = batch_size
        self.num_threads = max(1, num_threads)

    @staticmethod
    def _load(path):
        if path.endswith(".npz"):
            with np.load(path) as z:
                return z["features"], (z["labels"] if "labels" in z.files
                                       else None)
        return np.load(path), None

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        window = self.num_threads * 2
        with ThreadPoolExecutor(self.num_threads) as pool:
            paths = iter(self.paths)
            pending = deque(pool.submit(self._load, p)
                            for _, p in zip(range(window), paths))
            while pending:
                feats, labels = pending.popleft().result()
                nxt = next(paths, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                for s in range(0, feats.shape[0], self.batch_size):
                    yield DataSet(
                        feats[s:s + self.batch_size],
                        None if labels is None
                        else labels[s:s + self.batch_size])
