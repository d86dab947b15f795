"""Evaluation JSON serialization.

Counterpart of ``deeplearning4j_tpu/eval/serde.py``, the same wire form
byte for byte (``tests/fixtures/eval_serde_v1.json`` is the anchor both
packages read). Equivalent of deeplearning4j-nn eval/serde/
(ROCSerializer.java, ROCArraySerializer.java, ConfusionMatrixSerializer.java,
ConfusionMatrixDeserializer.java) + the Jackson round-trip every eval class
supports via BaseEvaluation.toJson/fromJson. Envelope: a JSON object with an
"@class" discriminator (the reference uses Jackson @class type info the same
way), numbers stored as plain JSON (shortest-repr floats round-trip float64
exactly, so metric state survives bit for bit).

Unlike ROCSerializer.java — which drops the raw predictions in exact mode
and keeps only the AUC and curves — the repo's exact ROC stores its
label/score arrays, so a reloaded ROC can keep accumulating via eval();
cached auc/auprc are included for readers that only want the headline.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.eval.evaluation import (
    ConfusionMatrix, Evaluation, RegressionEvaluation,
)
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass


def _opt_list(a) -> Optional[list]:
    return None if a is None else np.asarray(a).tolist()


# -- per-class encoders ------------------------------------------------------

def _cm_to(cm: ConfusionMatrix) -> Dict[str, Any]:
    # ref ConfusionMatrixSerializer.java stores {classes, matrix}; the dense
    # int matrix here carries the same counts without the Multiset encoding
    return {"@class": "ConfusionMatrix",
            "numClasses": cm.num_classes,
            "matrix": cm.matrix.tolist()}


def _cm_from(d: Dict[str, Any]) -> ConfusionMatrix:
    cm = ConfusionMatrix(int(d["numClasses"]))
    cm.matrix = np.asarray(d["matrix"], dtype=np.int64)
    return cm


def _eval_to(e: Evaluation) -> Dict[str, Any]:
    return {"@class": "Evaluation",
            "labelNames": e.label_names,
            "numClasses": e.num_classes,
            "topN": e.top_n,
            "topNCorrectCount": e.top_n_correct_count,
            "topNTotalCount": e.top_n_total_count,
            "confusion": None if e.confusion is None else _cm_to(e.confusion)}


def _eval_from(d: Dict[str, Any]) -> Evaluation:
    e = Evaluation(num_classes=d.get("numClasses"),
                   labels=d.get("labelNames"),
                   top_n=d.get("topN", 1))
    e.top_n_correct_count = int(d.get("topNCorrectCount", 0))
    e.top_n_total_count = int(d.get("topNTotalCount", 0))
    if d.get("confusion") is not None:
        e.confusion = _cm_from(d["confusion"])
        e.num_classes = e.confusion.num_classes
    return e


_REG_FIELDS = ("_sum_sq_err", "_sum_abs_err", "_sum_label", "_sum_label_sq",
               "_sum_pred", "_sum_pred_sq", "_sum_label_pred")


def _reg_to(r: RegressionEvaluation) -> Dict[str, Any]:
    return {"@class": "RegressionEvaluation",
            "numColumns": r.num_columns,
            "count": r._count,
            **{f.lstrip("_"): _opt_list(getattr(r, f))
               for f in _REG_FIELDS}}


def _reg_from(d: Dict[str, Any]) -> RegressionEvaluation:
    r = RegressionEvaluation(num_columns=d.get("numColumns"))
    r._count = int(d.get("count", 0))
    for f in _REG_FIELDS:
        v = d.get(f.lstrip("_"))
        if v is not None:
            setattr(r, f, np.asarray(v, dtype=np.float64))
    return r


def _roc_to(r: ROC) -> Dict[str, Any]:
    has_data = bool(r._labels) and any(len(l) for l in r._labels)
    return {"@class": "ROC",
            "thresholdSteps": r.threshold_steps,      # ref ROCSerializer
            "labels": _opt_list(np.concatenate(r._labels))
            if r._labels else [],
            "scores": _opt_list(np.concatenate(r._scores))
            if r._scores else [],
            # headline numbers up front, like ROCSerializer.java:
            "auc": r.calculate_auc() if has_data else None,
            "auprc": r.calculate_auprc() if has_data else None}


def _roc_from(d: Dict[str, Any]) -> ROC:
    r = ROC(threshold_steps=d.get("thresholdSteps", 0))
    labels = np.asarray(d.get("labels") or [], dtype=np.float64)
    scores = np.asarray(d.get("scores") or [], dtype=np.float64)
    if labels.size:
        r._labels.append(labels)
        r._scores.append(scores)
    return r


def _rocbin_to(r: ROCBinary) -> Dict[str, Any]:
    # ref ROCArraySerializer.java: an array of per-column ROC objects
    return {"@class": "ROCBinary",
            "rocs": None if r._rocs is None else [_roc_to(x)
                                                  for x in r._rocs]}


def _rocbin_from(d: Dict[str, Any]) -> ROCBinary:
    r = ROCBinary()
    if d.get("rocs") is not None:
        r._rocs = [_roc_from(x) for x in d["rocs"]]
    return r


def _rocmc_to(r: ROCMultiClass) -> Dict[str, Any]:
    return {"@class": "ROCMultiClass",
            "rocs": None if r._rocs is None else [_roc_to(x)
                                                  for x in r._rocs]}


def _rocmc_from(d: Dict[str, Any]) -> ROCMultiClass:
    r = ROCMultiClass()
    if d.get("rocs") is not None:
        r._rocs = [_roc_from(x) for x in d["rocs"]]
    return r


def _bin_to(e: EvaluationBinary) -> Dict[str, Any]:
    return {"@class": "EvaluationBinary",
            "threshold": e.threshold,
            "tp": _opt_list(e._tp), "fp": _opt_list(e._fp),
            "tn": _opt_list(e._tn), "fn": _opt_list(e._fn)}


def _bin_from(d: Dict[str, Any]) -> EvaluationBinary:
    e = EvaluationBinary(decision_threshold=d.get("threshold", 0.5))
    for f in ("tp", "fp", "tn", "fn"):
        v = d.get(f)
        if v is not None:
            setattr(e, "_" + f, np.asarray(v, dtype=np.int64))
    return e


def _cal_to(e: EvaluationCalibration) -> Dict[str, Any]:
    return {"@class": "EvaluationCalibration",
            "reliabilityBins": e.reliability_bins,
            "histogramBins": e.histogram_bins,
            "binCounts": _opt_list(e._bin_counts),
            "binPos": _opt_list(e._bin_pos),
            "binProbSum": _opt_list(e._bin_prob_sum)}


def _cal_from(d: Dict[str, Any]) -> EvaluationCalibration:
    e = EvaluationCalibration(reliability_bins=d.get("reliabilityBins", 10),
                              histogram_bins=d.get("histogramBins", 10))
    if d.get("binCounts") is not None:
        e._bin_counts = np.asarray(d["binCounts"], dtype=np.int64)
        e._bin_pos = np.asarray(d["binPos"], dtype=np.int64)
        e._bin_prob_sum = np.asarray(d["binProbSum"], dtype=np.float64)
    return e


_ENCODERS = {
    ConfusionMatrix: _cm_to, Evaluation: _eval_to,
    RegressionEvaluation: _reg_to, ROC: _roc_to, ROCBinary: _rocbin_to,
    ROCMultiClass: _rocmc_to, EvaluationBinary: _bin_to,
    EvaluationCalibration: _cal_to,
}
_DECODERS = {
    "ConfusionMatrix": _cm_from, "Evaluation": _eval_from,
    "RegressionEvaluation": _reg_from, "ROC": _roc_from,
    "ROCBinary": _rocbin_from, "ROCMultiClass": _rocmc_from,
    "EvaluationBinary": _bin_from, "EvaluationCalibration": _cal_from,
}


def to_dict(obj) -> Dict[str, Any]:
    enc = _ENCODERS.get(type(obj))
    if enc is None:   # subclasses serialize as their nearest base
        for klass, fn in _ENCODERS.items():
            if isinstance(obj, klass):
                enc = fn
                break
    if enc is None:
        raise TypeError(f"no eval serde for {type(obj).__name__}")
    return enc(obj)


def from_dict(d: Dict[str, Any]):
    kind = d.get("@class")
    dec = _DECODERS.get(kind)
    if dec is None:
        raise ValueError(f"unknown eval class {kind!r}")
    return dec(d)


def to_json(obj) -> str:
    """ref: BaseEvaluation.toJson."""
    return json.dumps(to_dict(obj))


def from_json(s: str):
    """ref: BaseEvaluation.fromJson."""
    return from_dict(json.loads(s))
