"""ROC / AUC evaluation.

Counterpart of ``deeplearning4j_tpu/eval/roc.py``, host-side numpy copied
as it is (the reference's eval/ROC.java, ROCBinary.java,
ROCMultiClass.java). Uses exact (sorted-score) ROC computation rather than the reference's
fixed-threshold-step approximation — strictly more accurate, same API shape
(`thresholdSteps=0` in later DL4J means exact too).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.eval.base import EvalJsonMixin


def _auc_from_scores(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic."""
    pos = scores[labels > 0.5]
    neg = scores[labels <= 0.5]
    if len(pos) == 0 or len(neg) == 0:
        return 0.0
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    # average ranks for ties
    allscores = np.concatenate([pos, neg])
    sorted_scores = allscores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j + 2) / 2.0
            for k in range(i, j + 1):
                ranks[order[k]] = avg
        i = j + 1
    r_pos = ranks[:len(pos)].sum()
    auc = (r_pos - len(pos) * (len(pos) + 1) / 2.0) / (len(pos) * len(neg))
    return float(auc)


class ROC(EvalJsonMixin):
    """Binary ROC: single-column probabilities or 2-column softmax
    (ref: eval/ROC.java)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._labels: List[np.ndarray] = []
        self._scores: List[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        if labels.ndim == 3:
            n, c, t = labels.shape
            labels = labels.transpose(0, 2, 1).reshape(n * t, c)
            predictions = predictions.transpose(0, 2, 1).reshape(n * t, c)
            if mask is not None:
                keep = np.asarray(mask).astype(bool).reshape(-1)
                labels, predictions = labels[keep], predictions[keep]
        if labels.ndim == 2 and labels.shape[1] == 2:
            lab = labels[:, 1]
            sc = predictions[:, 1]
        else:
            lab = labels.reshape(-1)
            sc = predictions.reshape(-1)
        self._labels.append(lab)
        self._scores.append(sc)

    def calculate_auc(self) -> float:
        labels = np.concatenate(self._labels)
        scores = np.concatenate(self._scores)
        return _auc_from_scores(labels, scores)

    def get_roc_curve(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (thresholds, fpr, tpr)."""
        labels = np.concatenate(self._labels)
        scores = np.concatenate(self._scores)
        order = np.argsort(-scores, kind="mergesort")
        labels = labels[order]
        scores = scores[order]
        tps = np.cumsum(labels > 0.5)
        fps = np.cumsum(labels <= 0.5)
        p = max(1, (labels > 0.5).sum())
        n = max(1, (labels <= 0.5).sum())
        return scores, fps / n, tps / p

    def calculate_auprc(self) -> float:
        labels = np.concatenate(self._labels)
        scores = np.concatenate(self._scores)
        order = np.argsort(-scores, kind="mergesort")
        labels = labels[order]
        tps = np.cumsum(labels > 0.5)
        denom = np.arange(1, len(labels) + 1)
        precision = tps / denom
        recall = tps / max(1, (labels > 0.5).sum())
        return float(np.trapezoid(precision, recall))


class ROCBinary(EvalJsonMixin):
    """Per-output-column binary ROC (ref: eval/ROCBinary.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        n_cols = labels.shape[1] if labels.ndim >= 2 else 1
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n_cols)]
        for c in range(n_cols):
            self._rocs[c].eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, col: int = 0) -> float:
        return self._rocs[col].calculate_auc()


class ROCMultiClass(EvalJsonMixin):
    """One-vs-all ROC per class (ref: eval/ROCMultiClass.java)."""

    def __init__(self):
        self._rocs: Optional[List[ROC]] = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            n, c, t = labels.shape
            labels = labels.transpose(0, 2, 1).reshape(n * t, c)
            predictions = predictions.transpose(0, 2, 1).reshape(n * t, c)
        n_cls = labels.shape[1]
        if self._rocs is None:
            self._rocs = [ROC() for _ in range(n_cls)]
        for c in range(n_cls):
            self._rocs[c].eval(labels[:, c], predictions[:, c])

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))
