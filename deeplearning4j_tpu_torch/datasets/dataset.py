"""DataSet: one minibatch of (features, labels, masks).

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``: ``DataSet``, a
plain container of numpy arrays (or dicts of them, keyed by input /
output name, for multi-input graphs); ``MultiDataSet`` (positional
inputs and outputs, the record readers' multi-input batches) and
``one_hot``.
Conversion to device tensors happens at the network's boundary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["DataSet", "MultiDataSet", "one_hot"]


def _sel(x, idx):
    """Index rows; dict-aware."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v[idx] for k, v in x.items()}
    return x[idx]


@dataclass
class DataSet:
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        f = self.features
        if isinstance(f, dict):
            f = next(iter(f.values()))
        return int(f.shape[0])


@dataclass
class MultiDataSet:
    """Positional inputs and outputs (the record readers' multi-input
    batches)."""
    features: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0]) if self.features else 0


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """One-hot encode integer class labels, validating the range: negative
    or >= num_classes labels raise instead of silently wrapping."""
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
        bad = labels[(labels < 0) | (labels >= num_classes)][0]
        raise ValueError(f"label {int(bad)} outside [0, {num_classes})")
    out = np.zeros((labels.shape[0], num_classes), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out
