"""Probability calibration evaluation.

Counterpart of ``deeplearning4j_tpu/eval/calibration.py``, host-side
numpy copied as it is (the reference's eval/EvaluationCalibration.java):
reliability diagram bins + residual plot + probability histogram.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.eval.base import EvalJsonMixin


class EvaluationCalibration(EvalJsonMixin):
    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 10):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._bin_counts = None
        self._bin_pos = None
        self._bin_prob_sum = None

    def _ensure(self, n_cls):
        if self._bin_counts is None:
            shape = (n_cls, self.reliability_bins)
            self._bin_counts = np.zeros(shape, dtype=np.int64)
            self._bin_pos = np.zeros(shape, dtype=np.int64)
            self._bin_prob_sum = np.zeros(shape)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 3:
            n, c, t = labels.shape
            labels = labels.transpose(0, 2, 1).reshape(n * t, c)
            predictions = predictions.transpose(0, 2, 1).reshape(n * t, c)
        n_cls = labels.shape[1]
        self._ensure(n_cls)
        bins = np.clip((predictions * self.reliability_bins).astype(int), 0,
                       self.reliability_bins - 1)
        for c in range(n_cls):
            np.add.at(self._bin_counts[c], bins[:, c], 1)
            np.add.at(self._bin_pos[c], bins[:, c], (labels[:, c] > 0.5).astype(np.int64))
            np.add.at(self._bin_prob_sum[c], bins[:, c], predictions[:, c])

    def reliability_diagram(self, cls: int):
        """Return (mean_predicted_prob, fraction_positive) per bin."""
        counts = np.maximum(self._bin_counts[cls], 1)
        return (self._bin_prob_sum[cls] / counts, self._bin_pos[cls] / counts)

    def expected_calibration_error(self, cls: int = 0) -> float:
        counts = self._bin_counts[cls]
        total = max(1, counts.sum())
        mean_p, frac = self.reliability_diagram(cls)
        return float(np.sum(counts / total * np.abs(mean_p - frac)))
