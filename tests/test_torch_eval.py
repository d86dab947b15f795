"""The port's evaluation (deeplearning4j_tpu_torch/eval/, ui/components.py,
the networks' ``evaluate``) against the JAX package on the CPU, with the
same seeded numpy inputs.

- Every eval class, fed the same batches (``[N, C]`` and ``[N, C, T]``
  with a mask, top-N, exact and thresholded ROC): ``stats()`` (where the
  class has one), ``to_json()`` and the headline metrics are the JAX
  class's exactly (the same numpy code on the same arrays).
- ``tests/fixtures/eval_serde_v1.json`` parses to the pinned metrics and
  reserializes identically.
- The HTML exports (``eval/tools.py`` over ``ui/components.py``) are the
  JAX package's byte for byte.
- ``MultiLayerNetwork.evaluate`` / ``evaluate_regression`` and
  ``ComputationGraph.evaluate`` (unfused and on the fused bn -> relu ->
  1x1 plan) on small f32 nets holding the JAX nets' weights: the
  confusion matrices equal the JAX ones, the metrics within 1e-6; the
  text LSTM on ``[N, C, T]`` labels with a labels mask through an
  iterator; a DataSet is batched by 128 with its masks dropped, as in
  the JAX package; ``ComputationGraph.evaluate`` refuses a features mask,
  naming ROADMAP.md A6.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import eval as jeval
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JIter)
from deeplearning4j_tpu.eval import tools as jtools
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
from deeplearning4j_tpu_torch import eval as teval
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.eval import tools as ttools
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

from test_torch_fused import _carried, _data

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "eval_serde_v1.json")
METRIC_ATOL = 1e-6       # f32 heads through two packages' forwards


# ---------------------------------------------------------------------
# the classes, on the same arrays
# ---------------------------------------------------------------------
def _probs(rng, shape, axis=1):
    z = rng.standard_normal(shape)
    e = np.exp(z - z.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _onehot(rng, n, c, t=None):
    if t is None:
        return np.eye(c)[rng.integers(0, c, n)]
    return np.eye(c)[rng.integers(0, c, (n, t))].transpose(0, 2, 1)


def _batches(kind, seed):
    """Two batches of (labels, predictions, mask) for ``kind``."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (7, 5):
        if kind == "classes":
            out.append((_onehot(rng, n, 4), _probs(rng, (n, 4)), None))
        elif kind == "series":
            mask = (rng.random((n, 6)) > 0.3).astype(np.float32)
            out.append((_onehot(rng, n, 4, 6), _probs(rng, (n, 4, 6)),
                        mask))
        elif kind == "binary2":
            out.append((_onehot(rng, n, 2), _probs(rng, (n, 2)), None))
        elif kind == "binary1":
            lab = (rng.random((n, 1)) > 0.5).astype(np.float64)
            out.append((lab, rng.random((n, 1)), None))
        elif kind == "multi":
            out.append(((rng.random((n, 3)) > 0.5).astype(np.float64),
                        rng.random((n, 3)), None))
        elif kind == "multi_series":
            mask = (rng.random((n, 6)) > 0.3).astype(np.float32)
            out.append(((rng.random((n, 3, 6)) > 0.5).astype(np.float64),
                        rng.random((n, 3, 6)), mask))
        else:                                          # regression
            y = rng.standard_normal((n, 3))
            out.append((y, y + 0.3 * rng.standard_normal((n, 3)), None))
    return out


CASES = {
    "evaluation": ("Evaluation", {}, "classes"),
    "evaluation_labels_top3": ("Evaluation", dict(
        labels=["a", "b", "c", "d"], top_n=3), "classes"),
    "evaluation_series_masked": ("Evaluation", dict(top_n=2), "series"),
    "regression": ("RegressionEvaluation", {}, "regression"),
    "regression_series_masked": ("RegressionEvaluation", {}, "series"),
    "roc_exact": ("ROC", {}, "binary2"),
    "roc_one_column": ("ROC", {}, "binary1"),
    "roc_thresholded": ("ROC", dict(threshold_steps=20), "binary2"),
    "roc_series_masked": ("ROC", {}, "series"),
    "roc_binary": ("ROCBinary", {}, "multi"),
    "roc_multiclass": ("ROCMultiClass", {}, "classes"),
    "roc_multiclass_series": ("ROCMultiClass", {}, "series"),
    "binary": ("EvaluationBinary", {}, "multi"),
    "binary_series_masked": ("EvaluationBinary", dict(
        decision_threshold=0.4), "multi_series"),
    "calibration": ("EvaluationCalibration", dict(reliability_bins=7),
                    "classes"),
}


def _metrics(e):
    """The class's headline numbers."""
    name = type(e).__name__
    if name == "Evaluation":
        return [e.accuracy(), e.top_n_accuracy(), e.precision(), e.recall(),
                e.f1()] + [f(c) for c in range(e.num_classes) for f in (
                    e.precision, e.recall, e.f1, e.false_positive_rate,
                    e.matthews_correlation)]
    if name == "RegressionEvaluation":
        return [f(c) for c in range(e.num_columns) for f in (
            e.mean_squared_error, e.mean_absolute_error,
            e.root_mean_squared_error, e.correlation_r2, e.r_squared)]
    if name == "ROC":
        _, fpr, tpr = e.get_roc_curve()
        return [e.calculate_auc(), e.calculate_auprc(), *fpr, *tpr]
    if name == "ROCBinary":
        return [e.calculate_auc(c) for c in range(len(e._rocs))]
    if name == "ROCMultiClass":
        return [e.calculate_auc(c) for c in range(len(e._rocs))] + [
            e.calculate_average_auc()]
    if name == "EvaluationBinary":
        return [f(c) for c in range(len(e._tp)) for f in (
            e.accuracy, e.precision, e.recall, e.f1)]
    return [e.expected_calibration_error(c) for c in range(4)] + [
        v for c in range(4) for a in e.reliability_diagram(c) for v in a]


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_class_is_the_jax_class(case):
    cls, kw, kind = CASES[case]
    got, want = getattr(teval, cls)(**kw), getattr(jeval, cls)(**kw)
    for labels, preds, mask in _batches(kind, seed=len(case)):
        got.eval(labels, preds, mask=mask)
        want.eval(labels, preds, mask=mask)
    assert got.to_json() == want.to_json()
    if hasattr(want, "stats"):
        assert got.stats() == want.stats()
    assert _metrics(got) == _metrics(want)
    # the wire form round-trips in the port, and across the packages
    back = teval.eval_from_json(want.to_json())
    assert type(back) is type(got) and back.to_json() == got.to_json()


def test_the_fixture_parses_and_reserializes_identically():
    with open(FIXTURE) as f:
        fix = json.load(f)
    ev = teval.eval_from_dict(fix["evaluation"])
    assert isinstance(ev, teval.Evaluation)
    assert ev.accuracy() == pytest.approx(fix["expected"]["accuracy"])
    assert ev.f1() == pytest.approx(fix["expected"]["f1"])
    assert teval.eval_from_dict(fix["roc"]).calculate_auc() == \
        pytest.approx(fix["expected"]["auc"])
    assert teval.eval_from_dict(fix["regression"]).mean_squared_error(0) \
        == pytest.approx(fix["expected"]["mse0"])
    for key in ("evaluation", "roc", "regression"):
        obj = teval.eval_from_dict(fix[key])
        assert json.loads(teval.eval_to_json(obj)) == fix[key]
        assert teval.eval_to_json(obj) == jeval.eval_to_json(
            jeval.eval_from_dict(fix[key]))
    with pytest.raises(TypeError):
        teval.ROC.from_json(ev.to_json())
    with pytest.raises(ValueError):
        teval.eval_from_json('{"@class": "Nope"}')


# ---------------------------------------------------------------------
# the HTML exports, byte for byte
# ---------------------------------------------------------------------
def _fitted(pkg):
    ev = pkg.Evaluation()
    roc = pkg.ROCMultiClass()
    for labels, preds, _ in _batches("classes", seed=11):
        ev.eval(labels, preds)
        roc.eval(labels, preds)
    return ev, roc


@pytest.mark.parametrize("export", ["roc", "evaluation", "report"])
def test_the_html_exports_are_the_jax_packages(tmp_path, export):
    outs = []
    for pkg, tools in ((teval, ttools), (jeval, jtools)):
        ev, roc = _fitted(pkg)
        path = str(tmp_path / f"{pkg.__name__}.html")
        if export == "roc":
            tools.export_roc_charts_to_html_file(path, roc._rocs,
                                                 titles=["ant", "bee"])
        elif export == "evaluation":
            tools.export_evaluation_to_html_file(
                path, ev, class_names=["a", "b", "c", "<d>"])
        else:
            tools.export_report_to_html_file(
                path, evaluation=ev, rocs=roc._rocs[:2],
                scores=[(0, 1.5), (1, 1.25), (2, 0.5)])
        with open(path, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1] and len(outs[0]) > 500


# ---------------------------------------------------------------------
# evaluate on both networks
# ---------------------------------------------------------------------
def _mlp_pair(out="softmax"):
    loss = "mcxent" if out == "softmax" else "mse"
    layers = [jl.DenseLayer(n_out=16, activation="tanh"),
              jl.OutputLayer(n_out=4, loss=loss, activation=out)]
    jconf = JMLConf(layers=layers, input_type=JIT.feed_forward(6), seed=5)
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jconf.to_dict()))).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _mlp_data(n=300):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    return x, np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]


def _assert_same(got, want):
    if isinstance(want, jeval.Evaluation):
        np.testing.assert_array_equal(got.confusion.matrix,
                                      want.confusion.matrix)
    np.testing.assert_allclose(_metrics(got), _metrics(want), rtol=0,
                               atol=METRIC_ATOL)


@pytest.mark.parametrize("method", ["evaluate", "evaluate_regression"])
def test_multilayer_evaluate_is_the_jax_networks(method):
    jnet, tnet = _mlp_pair("softmax" if method == "evaluate"
                           else "identity")
    x, y = _mlp_data()
    # a DataSet batches by 128 (two full batches and one of 44)
    got = getattr(tnet, method)(DataSet(x, y))
    want = getattr(jnet, method)(JDataSet(x, y))
    _assert_same(got, want)
    if method == "evaluate":
        assert got.confusion.matrix.sum() == 300
    # an iterator with a labels mask
    mask = (np.arange(300) % 3 != 0).astype(np.float32)
    got = getattr(tnet, method)(ArrayDataSetIterator(
        x, y, 64, labels_mask=mask))
    want = getattr(jnet, method)(JIter(x, y, 64, labels_mask=mask))
    _assert_same(got, want)


def test_a_dataset_drops_its_masks_as_in_the_jax_package():
    jnet, tnet = _mlp_pair()
    x, y = _mlp_data(50)
    mask = np.zeros(50, np.float32)
    got = tnet.evaluate(DataSet(x, y, labels_mask=mask))
    want = jnet.evaluate(JDataSet(x, y, labels_mask=mask))
    assert got.confusion.matrix.sum() == 50
    _assert_same(got, want)


def test_the_text_lstm_evaluates_series_under_a_labels_mask():
    jnet = JaxLSTM(vocab_size=11, hidden=16, layers=2, max_length=5).init()
    tnet = TextGenerationLSTM(vocab_size=11, hidden=16, layers=2,
                              max_length=5).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    rng = np.random.default_rng(3)
    x = np.eye(11, dtype=np.float32)[rng.integers(0, 11, (6, 12))] \
        .transpose(0, 2, 1)
    y = np.roll(x, -1, axis=2)
    mask = (rng.random((6, 12)) > 0.25).astype(np.float32)
    got = tnet.evaluate(ArrayDataSetIterator(x, y, 4, labels_mask=mask))
    want = jnet.evaluate(JIter(x, y, 4, labels_mask=mask))
    _assert_same(got, want)
    assert got.confusion.matrix.sum() == int(mask.sum())


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "fuse_true"])
def test_graph_evaluate_is_the_jax_graphs(fused):
    jnet, tfused, tplain = _carried("NCHW")
    tnet = tfused if fused else tplain
    x, y, _ = _data()
    x = np.concatenate([x] * 40)
    y = np.concatenate([np.roll(y, i, axis=0) for i in range(40)])
    got = tnet.evaluate(DataSet(x, y))
    want = jnet.evaluate(JDataSet(x, y))
    _assert_same(got, want)
    assert got.confusion.matrix.sum() == len(x)
    # the labels mask through an iterator
    mask = (np.arange(len(x)) % 4 != 1).astype(np.float32)
    got = tnet.evaluate(ArrayDataSetIterator(x, y, 48, labels_mask=mask))
    want = jnet.evaluate(JIter(x, y, 48, labels_mask=mask))
    _assert_same(got, want)
    # a features mask reaches the JAX graph's forward; the port refuses
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        tnet.evaluate(ArrayDataSetIterator(
            x, y, 48, features_mask=np.ones((len(x), 1), np.float32)))
