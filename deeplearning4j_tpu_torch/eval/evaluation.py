"""Classification + regression evaluation.

Counterpart of ``deeplearning4j_tpu/eval/evaluation.py``, host-side numpy
copied as it is. The reference is deeplearning4j-nn/.../eval/
Evaluation.java (1627 LoC: eval :285, stats :499, precision :664, recall
:803, f1 :1031, accuracy :1138, ConfusionMatrix) and
RegressionEvaluation.java. Accumulation is host-side numpy (cheap vs the
device forward pass: the networks' ``evaluate`` hands it host copies of
the f32 heads); metrics formulas match the reference, including
macro-averaging behavior.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.base import EvalJsonMixin


class ConfusionMatrix(EvalJsonMixin):
    """Counts of (actual, predicted) pairs (ref: eval/ConfusionMatrix.java)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.matrix = np.zeros((num_classes, num_classes), dtype=np.int64)

    def add(self, actual: int, predicted: int, count: int = 1):
        self.matrix[actual, predicted] += count

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def actual_total(self, cls: int) -> int:
        return int(self.matrix[cls].sum())

    def predicted_total(self, cls: int) -> int:
        return int(self.matrix[:, cls].sum())

    def __str__(self):
        return str(self.matrix)


def _flatten_time(labels: np.ndarray, preds: np.ndarray, mask):
    """[N,C,T] -> [N*T, C] with mask [N,T] -> [N*T] (ref: Evaluation
    evalTimeSeries path)."""
    if labels.ndim == 3:
        n, c, t = labels.shape
        labels = labels.transpose(0, 2, 1).reshape(n * t, c)
        preds = preds.transpose(0, 2, 1).reshape(n * t, c)
        if mask is not None:
            mask = np.asarray(mask).reshape(n * t)
    return labels, preds, mask


class Evaluation(EvalJsonMixin):
    """Multiclass classification metrics (ref: eval/Evaluation.java)."""

    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.label_names = labels
        self.num_classes = num_classes or (len(labels) if labels else None)
        self.confusion: Optional[ConfusionMatrix] = None
        # top-N accuracy (ref: Evaluation(List, int) constructor :130-138;
        # an example counts correct when the true class probability is
        # among the N highest outputs, :440-450)
        self.top_n = max(1, int(top_n))
        self.top_n_correct_count = 0
        self.top_n_total_count = 0

    def _ensure(self, n):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = ConfusionMatrix(self.num_classes)

    def eval(self, labels, predictions, mask=None):
        """Accumulate a batch (ref: eval :285). labels/predictions are
        one-hot/probability arrays [N,C] or time series [N,C,T]."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        labels, predictions, mask = _flatten_time(labels, predictions, mask)
        self._ensure(labels.shape[-1])
        actual = labels.argmax(axis=-1)
        pred = predictions.argmax(axis=-1)
        if mask is not None:
            keep = np.asarray(mask).astype(bool).reshape(-1)
            actual, pred = actual[keep], pred[keep]
            predictions = predictions[keep]
        np.add.at(self.confusion.matrix, (actual, pred), 1)
        if self.top_n > 1:
            n = min(self.top_n, predictions.shape[-1])
            # true-class prob among the n highest (ref eval :440-450)
            topn = np.argpartition(-predictions, n - 1, axis=-1)[..., :n]
            self.top_n_correct_count += int(
                (topn == actual[..., None]).any(axis=-1).sum())
            self.top_n_total_count += int(actual.size)

    # ---- metrics ----
    def _tp(self, c):
        return self.confusion.get_count(c, c)

    def _fp(self, c):
        return self.confusion.predicted_total(c) - self._tp(c)

    def _fn(self, c):
        return self.confusion.actual_total(c) - self._tp(c)

    def accuracy(self) -> float:
        m = self.confusion.matrix
        total = m.sum()
        return float(np.trace(m)) / total if total else 0.0

    def top_n_accuracy(self) -> float:
        """Fraction of examples whose true class is among the top_n
        highest-probability outputs (ref: topNAccuracy :1156-1161;
        equals accuracy() when top_n == 1)."""
        if self.top_n <= 1:
            return self.accuracy()
        if not self.top_n_total_count:
            return 0.0
        return self.top_n_correct_count / self.top_n_total_count

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.precision(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0 or self.confusion.predicted_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            denom = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / denom if denom else 0.0
        vals = [self.recall(c) for c in range(self.num_classes)
                if self.confusion.actual_total(c) > 0]
        return float(np.mean(vals)) if vals else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        tn = self.confusion.matrix.sum() - self._tp(cls) - self._fp(cls) - self._fn(cls)
        denom = self._fp(cls) + tn
        return self._fp(cls) / denom if denom else 0.0

    def matthews_correlation(self, cls: int) -> float:
        tp, fp, fn = self._tp(cls), self._fp(cls), self._fn(cls)
        tn = self.confusion.matrix.sum() - tp - fp - fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom else 0.0

    def stats(self) -> str:
        """Human-readable report (ref: stats :499)."""
        name = lambda c: (self.label_names[c] if self.label_names else str(c))
        lines = ["", "========================Evaluation Metrics========================",
                 f" # of classes:    {self.num_classes}",
                 f" Accuracy:        {self.accuracy():.4f}"]
        if self.top_n > 1:  # ref stats :560-567
            lines.append(f" Top {self.top_n} Accuracy:  "
                         f"{self.top_n_accuracy():.4f}")
        lines += [f" Precision:       {self.precision():.4f}",
                  f" Recall:          {self.recall():.4f}",
                  f" F1 Score:        {self.f1():.4f}",
                  "", "=========================Confusion Matrix=========================="]
        lines.append(str(self.confusion))
        lines.append("==================================================================")
        return "\n".join(lines)


class RegressionEvaluation(EvalJsonMixin):
    """Per-column regression metrics (ref: eval/RegressionEvaluation.java):
    MSE, MAE, RMSE, RSE, correlation, R^2."""

    def __init__(self, num_columns: Optional[int] = None):
        self.num_columns = num_columns
        self._sum_sq_err = None
        self._sum_abs_err = None
        self._count = 0
        self._sum_label = None
        self._sum_label_sq = None
        self._sum_pred = None
        self._sum_pred_sq = None
        self._sum_label_pred = None

    def _ensure(self, n):
        if self._sum_sq_err is None:
            self.num_columns = self.num_columns or n
            z = np.zeros(self.num_columns)
            self._sum_sq_err = z.copy()
            self._sum_abs_err = z.copy()
            self._sum_label = z.copy()
            self._sum_label_sq = z.copy()
            self._sum_pred = z.copy()
            self._sum_pred_sq = z.copy()
            self._sum_label_pred = z.copy()

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, dtype=np.float64)
        predictions = np.asarray(predictions, dtype=np.float64)
        labels, predictions, mask = _flatten_time(labels, predictions, mask)
        self._ensure(labels.shape[-1])
        if mask is not None:
            keep = np.asarray(mask).astype(bool).reshape(-1)
            labels, predictions = labels[keep], predictions[keep]
        err = predictions - labels
        self._sum_sq_err += (err ** 2).sum(axis=0)
        self._sum_abs_err += np.abs(err).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels ** 2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_pred_sq += (predictions ** 2).sum(axis=0)
        self._sum_label_pred += (labels * predictions).sum(axis=0)
        self._count += labels.shape[0]

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_sq_err[col] / self._count)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs_err[col] / self._count)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def correlation_r2(self, col: int = 0) -> float:
        n = self._count
        num = n * self._sum_label_pred[col] - self._sum_label[col] * self._sum_pred[col]
        den = np.sqrt(n * self._sum_label_sq[col] - self._sum_label[col] ** 2) * \
            np.sqrt(n * self._sum_pred_sq[col] - self._sum_pred[col] ** 2)
        r = num / den if den else 0.0
        return float(r)

    def r_squared(self, col: int = 0) -> float:
        mean_label = self._sum_label[col] / self._count
        ss_tot = self._sum_label_sq[col] - self._count * mean_label ** 2
        ss_res = self._sum_sq_err[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def stats(self) -> str:
        lines = ["", "=================Regression Evaluation================="]
        for c in range(self.num_columns):
            lines.append(
                f" col {c}: MSE={self.mean_squared_error(c):.5f} "
                f"MAE={self.mean_absolute_error(c):.5f} "
                f"RMSE={self.root_mean_squared_error(c):.5f} "
                f"corr={self.correlation_r2(c):.4f} R2={self.r_squared(c):.4f}")
        return "\n".join(lines)
