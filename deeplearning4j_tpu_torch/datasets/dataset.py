"""DataSet: one minibatch of (features, labels, masks).

Counterpart of ``deeplearning4j_tpu/datasets/dataset.py``'s ``DataSet``:
a plain container of numpy arrays (or dicts of them, keyed by input /
output name, for multi-input graphs). Conversion to device tensors
happens at the network's boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["DataSet"]


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
