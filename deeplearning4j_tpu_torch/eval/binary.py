"""Per-output binary classification evaluation.

Counterpart of ``deeplearning4j_tpu/eval/binary.py``, host-side numpy
copied as it is (the reference's eval/EvaluationBinary.java): independent
binary metrics (accuracy/precision/recall/f1) for each output column at
threshold 0.5.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.base import EvalJsonMixin


class EvaluationBinary(EvalJsonMixin):
    def __init__(self, decision_threshold: float = 0.5):
        self.threshold = decision_threshold
        self._tp = None
        self._fp = None
        self._tn = None
        self._fn = None

    def _ensure(self, n):
        if self._tp is None:
            z = np.zeros(n, dtype=np.int64)
            self._tp, self._fp, self._tn, self._fn = z.copy(), z.copy(), z.copy(), z.copy()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            n, c, t = labels.shape
            labels = labels.transpose(0, 2, 1).reshape(n * t, c)
            predictions = predictions.transpose(0, 2, 1).reshape(n * t, c)
            if mask is not None:
                keep = np.asarray(mask).astype(bool).reshape(-1)
                labels, predictions = labels[keep], predictions[keep]
        self._ensure(labels.shape[1])
        pred = predictions >= self.threshold
        actual = labels > 0.5
        self._tp += (pred & actual).sum(axis=0)
        self._fp += (pred & ~actual).sum(axis=0)
        self._tn += (~pred & ~actual).sum(axis=0)
        self._fn += (~pred & actual).sum(axis=0)

    def accuracy(self, col: int = 0) -> float:
        total = self._tp[col] + self._fp[col] + self._tn[col] + self._fn[col]
        return float(self._tp[col] + self._tn[col]) / total if total else 0.0

    def precision(self, col: int = 0) -> float:
        d = self._tp[col] + self._fp[col]
        return float(self._tp[col]) / d if d else 0.0

    def recall(self, col: int = 0) -> float:
        d = self._tp[col] + self._fn[col]
        return float(self._tp[col]) / d if d else 0.0

    def f1(self, col: int = 0) -> float:
        p, r = self.precision(col), self.recall(col)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def stats(self) -> str:
        n = len(self._tp)
        lines = ["EvaluationBinary:"]
        for c in range(n):
            lines.append(f"  col {c}: acc={self.accuracy(c):.4f} "
                         f"prec={self.precision(c):.4f} rec={self.recall(c):.4f} "
                         f"f1={self.f1(c):.4f}")
        return "\n".join(lines)
