"""DataSet iterators.

Counterpart of ``deeplearning4j_tpu/datasets/iterators.py`` for the
in-memory iterator ``fit`` builds: ``ArrayDataSetIterator`` gives the
JAX package's batches in the same order, shuffled or not (a pass ``e``
shuffles with ``np.random.default_rng(seed + e)``); ``restore_state``
picks the next pass's index and first batch, as the JAX iterator's
does. The device prefetch stage is ``pipeline/prefetch.py``; the
iterator's ``state()`` half (durable checkpoints) and the asynchronous
and chaos iterators are ROADMAP.md A5.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, _sel

__all__ = ["ArrayDataSetIterator", "DataSetIterator"]


class DataSetIterator:
    """Iterator protocol: ``reset`` and iteration."""

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
        self._resume = None     # (epoch, pos) pending from restore_state

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
        for s in range(start * self.batch_size, n, self.batch_size):
            sel = idx[s:s + self.batch_size]
            yield DataSet(_sel(self.features, sel), _sel(self.labels, sel),
                          _sel(self.features_mask, sel),
                          _sel(self.labels_mask, sel))
