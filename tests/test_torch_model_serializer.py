"""The port's model archives (deeplearning4j_tpu_torch/util/
model_serializer.py and the configurations' JSON) against the JAX
package's, on the CPU.

- The configuration JSON is the JAX package's wire form: for both graph
  fixtures the port's ``from_json(...).to_dict()`` equals the JAX
  package's key for key, and every key of the fixture JSON (the JAX
  package writes four SelfAttentionLayer fields the transformer fixture
  predates, at their defaults; the port writes them too).
- The port restores ``regression_tfm_v1.zip`` and ``regression_cg_v1.zip``
  with no JAX: the parameters hash to ``regression_checksums.json`` under
  the fixture generator's ``params_sha256``, the updater state is the
  archive's leaf for leaf (Adam's step count and moments non-zero; the
  graph fixture's Nesterovs velocity was written before any step, all
  zeros), and the output is within ``OUT_ATOL`` (5e-3, the JAX test's) of
  ``_output.npy`` and within 1e-5 of the JAX package's restored net.
- A small text LSTM goes both ways: the JAX package writes what the port
  restores, the port writes what the JAX package's ``restore_model``
  reads; outputs within 1e-5 and one further tBPTT ``fit`` step within
  ``test_torch_text_lstm.py``'s tolerances (score 1e-5 relative, each
  leaf within 1e-3 of its change).
- ``restore_model`` sniffs the type; a dropout, a per-layer learning
  rate and a bias init (once read only at their defaults) are carried
  as the JAX package carries them, and a field the JAX layer does not
  have is refused; a failed write leaves the old archive whole.
- The sequential fixture ``regression_mln_v1.zip`` (ConvolutionMode
  "same", BN, a pool, a CnnToFeedForwardPreProcessor; refused naming A2
  until the sequential network's breadth was ported) restores in the
  port: parameters on the fixture's checksum, output within ``OUT_ATOL``
  of the stored one and 1e-5 of the JAX package's, its JSON key for
  key. A normalizer archive either package writes restores in the
  other.
"""

import copy
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf.network import (
    ComputationGraphConfiguration as JGraphConf)
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLNConf)
from deeplearning4j_tpu.util import model_serializer as jms
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util import model_serializer as tms
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, updater_state_to_numpy)

from test_torch_text_lstm import V, _batch, _nets, _np_tree

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
OUT_ATOL = 5e-3          # tests/test_regression_formats.py
GRAPHS = ["tfm", "cg"]


def _p(name):
    return os.path.join(FIX, name)


def _params_sha256(params):
    sys.path.insert(0, FIX)
    try:
        from generate_regression_fixtures import params_sha256
    finally:
        sys.path.remove(FIX)
    return params_sha256(params)


def _first(out):
    return out[0] if isinstance(out, (list, tuple)) else out


def _contains(big, small, path=""):
    """Every key of ``small`` is in ``big`` with the same value."""
    if isinstance(small, dict):
        assert isinstance(big, dict), path
        for k, v in small.items():
            assert k in big, f"{path}/{k}"
            _contains(big[k], v, f"{path}/{k}")
    else:
        assert big == small, (path, big, small)


@pytest.mark.parametrize("name", GRAPHS)
def test_graph_json_is_the_jax_wire_form(name):
    text = open(_p(f"regression_{name}_v1.json")).read()
    got = ComputationGraphConfiguration.from_json(text).to_dict()
    assert got == JGraphConf.from_json(text).to_dict()
    _contains(got, json.loads(text))
    if name == "cg":
        assert got == json.loads(text)
    again = ComputationGraphConfiguration.from_json(json.dumps(got))
    assert again.to_dict() == got


@pytest.mark.parametrize("name", GRAPHS)
def test_the_port_restores_the_graph_fixtures(name):
    net = tms.restore_model(_p(f"regression_{name}_v1.zip"), device="cpu")
    assert isinstance(net, ComputationGraph)
    assert _params_sha256(params_to_numpy(net.params)) == json.load(
        open(_p("regression_checksums.json")))[f"{name}_v1_params"]
    # the updater state is the archive's, leaf for leaf: Adam's moments
    # and step count after the transformer fixture's step; the graph
    # fixture was written before any step, so its Nesterovs velocity is
    # all zeros in the archive and restored as such
    upd = updater_state_to_numpy(net.updater_state)
    with zipfile.ZipFile(_p(f"regression_{name}_v1.zip")) as zf:
        entries = [e for e in zf.namelist() if e.startswith("updater/")]
        assert entries
        for e in entries:
            leaf = upd
            for seg in e[len("updater/"):-len(".npy")].split("/"):
                leaf = leaf[seg]
            want = np.load(io.BytesIO(zf.read(e)))
            assert leaf.dtype == want.dtype and np.array_equal(leaf, want)
    if name == "tfm":
        assert int(upd["t"]) > 0
        assert any(np.any(a != 0) for p in upd["m"].values()
                   for a in p.values())
    x = np.load(_p(f"regression_{name}_v1_input.npy"))
    expected = np.load(_p(f"regression_{name}_v1_output.npy"))
    got = _first(net.output(x)).numpy()
    np.testing.assert_allclose(got, expected, atol=OUT_ATOL)
    jnet = jms.restore_computation_graph(_p(f"regression_{name}_v1.zip"))
    np.testing.assert_allclose(got, np.asarray(_first(jnet.output(x))),
                               atol=1e-5)
    assert net.iteration_count == jnet.iteration_count


def _fit_and_compare(tnet, jnet, x, y):
    """One further tBPTT fit on both: the score within 1e-5 relative,
    each leaf within 1e-3 of its change."""
    start = params_to_numpy(tnet.params)
    jnet.fit(JDataSet(x, y), epochs=1)
    tnet.fit(DataSet(x, y), epochs=1)
    assert tnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=1e-5)
    got, want = params_to_numpy(tnet.params), _np_tree(jnet.params)
    for k in want:
        for n in want[k]:
            change = np.abs(want[k][n] - start[k][n]).max()
            err = np.abs(got[k][n] - want[k][n]).max() / change
            assert err <= 1e-3, (k, n, err)


def test_a_text_lstm_goes_between_the_packages(tmp_path):
    jnet, tnet = _nets()
    x, y = _batch(seed=11)
    jnet.fit(JDataSet(x, y), epochs=1)
    tnet.fit(DataSet(x, y), epochs=1)
    # the JAX package writes, the port restores
    jpath, tpath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jms.write_model(jnet, jpath)
    back = tms.restore_model(jpath, device="cpu")
    assert isinstance(back, MultiLayerNetwork)
    assert back.conf.to_dict() == jnet.conf.to_dict()
    np.testing.assert_allclose(back.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-5,
                               rtol=1e-5)
    # the port writes, the JAX package restores
    tms.write_model(tnet, tpath)
    jback = jms.restore_model(tpath)
    assert type(jback).__name__ == "MultiLayerNetwork"
    assert jback.conf.to_dict() == tnet.conf.to_dict()
    np.testing.assert_allclose(np.asarray(jback.output(x)),
                               tnet.output(x).numpy(), atol=1e-5, rtol=1e-5)
    assert jback.iteration_count == tnet.iteration_count
    x2, y2 = _batch(seed=12)
    _fit_and_compare(back, jnet, x2, y2)
    _fit_and_compare(tnet, jback, x2, y2)


def test_a_port_archive_restores_in_the_port(tmp_path):
    """The port's own round trip: the same bits, the updater state and
    counters carried, and ``restore_model`` sniffing each type."""
    _, tnet = _nets()
    x, y = _batch(seed=13)
    tnet.fit(DataSet(x, y), epochs=1)
    path = str(tmp_path / "m.zip")
    tms.write_model(tnet, path)
    back = tms.restore_model(path, device="cpu")
    assert isinstance(back, MultiLayerNetwork)
    assert torch.equal(back.output(x), tnet.output(x))
    for a, b in ((back.updater_state, tnet.updater_state),
                 (back.params, tnet.params)):
        a, b = updater_state_to_numpy(a), updater_state_to_numpy(b)
        assert json.dumps(_shapes(a)) == json.dumps(_shapes(b))
    assert back.iteration_count == tnet.iteration_count
    graph = tms.restore_model(_p("regression_cg_v1.zip"), device="cpu")
    assert isinstance(graph, ComputationGraph)
    gpath = str(tmp_path / "g.zip")
    tms.write_model(graph, gpath)
    assert isinstance(tms.restore_model(gpath, device="cpu"),
                      ComputationGraph)
    assert not tms.restore_model(path, load_updater=False,
                                 device="cpu").updater_state["g2"]["0"][
        "W"].any()


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in sorted(tree.items())}
    return list(np.shape(tree))


@pytest.mark.parametrize("key,value", [("dropout", 0.5),
                                       ("learning_rate", 0.1),
                                       ("bias_init", 0.5)])
def test_a_field_the_port_lacks_is_taken_only_at_its_default(key, value):
    """Once read only at their defaults, these fields are now carried:
    off their defaults they round-trip key for key, as the JAX package
    reads them; a field no JAX layer has is still refused."""
    d = json.load(open(_p("regression_cg_v1.json")))
    changed = copy.deepcopy(d)
    changed["vertices"]["lstm"]["layer"][key] = value
    got = ComputationGraphConfiguration.from_dict(changed)
    assert getattr(got.vertices["lstm"].layer, key) == value
    assert got.to_dict() == JGraphConf.from_dict(
        copy.deepcopy(changed)).to_dict()
    unknown = copy.deepcopy(d)
    unknown["vertices"]["lstm"]["layer"]["no_such_field"] = value
    with pytest.raises(NotImplementedError, match="no_such_field"):
        ComputationGraphConfiguration.from_dict(unknown)


def test_the_sequential_fixture_is_refused_naming_a2():
    """Once refused naming A2 (a ConvolutionMode "same" convolution and a
    CnnToFeedForwardPreProcessor, ported now): ``regression_mln_v1.zip``
    restores in the port with its parameters hashing to the fixture's
    checksum, its output within OUT_ATOL of the stored one and within
    1e-5 of the JAX package's restored net; its JSON round-trips key for
    key; it carries no normalizer."""
    net = tms.restore_model(_p("regression_mln_v1.zip"), device="cpu")
    assert isinstance(net, MultiLayerNetwork)
    assert _params_sha256(params_to_numpy(net.params)) == json.load(
        open(_p("regression_checksums.json")))["mln_v1_params"]
    x = np.load(_p("regression_mln_v1_input.npy"))
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, np.load(_p("regression_mln_v1_output.npy")),
                               atol=OUT_ATOL)
    jnet = jms.restore_multi_layer_network(_p("regression_mln_v1.zip"))
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), atol=1e-5)
    text = open(_p("regression_mln_v1.json")).read()
    conf = MultiLayerConfiguration.from_json(text)
    assert conf.to_dict() == json.loads(text) == JMLNConf.from_json(
        text).to_dict()
    assert MultiLayerConfiguration.from_json(conf.to_json()).to_dict() == \
        conf.to_dict()
    assert tms.restore_normalizer_from_file(_p("regression_cg_v1.zip")) \
        is None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_normalizer_archive_restores_in_the_other_package(tmp_path,
                                                            writer):
    """``add_normalizer_to_model`` / ``restore_normalizer_from_file`` in
    the JAX wire form (``normalizer.json``): an archive either package
    wrote, with the normalizer either package added, restores in the
    other, the network's output and the normalizer's transform equal."""
    from deeplearning4j_tpu.datasets.normalizers import (
        NormalizerStandardize as JStandardize)
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        NormalizerStandardize)
    x = np.load(_p("regression_mln_v1_input.npy"))
    path = str(tmp_path / "mln.zip")
    if writer == "jax":
        src = jms.restore_multi_layer_network(_p("regression_mln_v1.zip"))
        jms.write_model(src, path)
        jms.add_normalizer_to_model(path, JStandardize().fit(x))
        net = tms.restore_model(path, device="cpu")
        norm = tms.restore_normalizer_from_file(path)
        want_out = np.asarray(src.output(x))
        want_tx = JStandardize().fit(x).transform(x)
        with pytest.raises(ValueError, match="already contains"):
            tms.add_normalizer_to_model(path, norm)
        np.testing.assert_allclose(net.output(x).numpy(), want_out,
                                   atol=1e-5)
    else:
        src = tms.restore_model(_p("regression_mln_v1.zip"), device="cpu")
        tms.write_model(src, path)
        tms.add_normalizer_to_model(path, NormalizerStandardize().fit(x))
        net = jms.restore_multi_layer_network(path)
        norm = jms.restore_normalizer_from_file(path)
        want_out = src.output(x).numpy()
        want_tx = NormalizerStandardize().fit(x).transform(x)
        with pytest.raises(ValueError, match="already contains"):
            jms.add_normalizer_to_model(path, norm)
        np.testing.assert_allclose(np.asarray(net.output(x)), want_out,
                                   atol=1e-5)
    assert type(norm).__name__ == "NormalizerStandardize"
    np.testing.assert_array_equal(norm.transform(x), want_tx)


def test_a_failed_write_leaves_the_old_archive_whole(tmp_path, monkeypatch):
    graph = tms.restore_model(_p("regression_cg_v1.zip"), device="cpu")
    path = tmp_path / "m.zip"
    tms.write_model(graph, str(path))
    before = path.read_bytes()

    def fail(_):
        raise OSError("disk full")

    monkeypatch.setattr(tms, "updater_state_to_numpy", fail)
    with pytest.raises(OSError, match="disk full"):
        tms.write_model(graph, str(path))
    assert path.read_bytes() == before
    assert os.listdir(tmp_path) == ["m.zip"]


def test_restore_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tms.restore_model(_p("regression_cg_v1.zip"))


# ---------------------------------------------------------------------
# an archive with every field of A1 off its default
# ---------------------------------------------------------------------
def _a1_nets():
    """A JAX sequential net and a JAX graph with every A1 field set off
    its default (dropout as a float and as objects, weight noise,
    constraints, the distribution init, bias init, per-layer learning
    rates and updaters; a hardsigmoid-gated LSTM, a bias-less 1-D
    convolution and output layer, pnorm and collapse_dimensions, the
    graph's tBPTT lengths), AdaMax / AdaDelta, after one fit step. The
    Gaussian noises sit where the JAX nets stay f32 under the tests'
    x64 mode (``jax.random.normal`` then draws f64): after the
    recurrences, the weight noise on the output layer (which the JAX
    loss path does not perturb)."""
    from deeplearning4j_tpu.nn.conf import constraints as jcon
    from deeplearning4j_tpu.nn.conf import dropout as jdrop
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.network import (
        MultiLayerConfiguration as JMLConf)
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updater import AdaDelta, AdaMax
    common = dict(learning_rate=0.3, bias_init=0.05,
                  updater={"@class": "Sgd", "learning_rate": 0.7})
    layers = [
        jl.GravesLSTM(n_out=6, gate_activation="hardsigmoid",
                      dropout=jdrop.Dropout(0.9),
                      weight_noise=jdrop.DropConnect(0.95),
                      constraints=[jcon.MaxNormConstraint(max_norm=1.5)],
                      weight_init="distribution",
                      dist={"type": "uniform", "lower": -0.3, "upper": 0.3},
                      **common),
        jl.GravesLSTM(n_out=5, weight_init="xavier_uniform", dropout=0.8,
                      weight_noise=jdrop.DropConnect(0.9),
                      constraints=[jcon.UnitNormConstraint(dimensions=(1,))],
                      **common),
        jl.RnnOutputLayer(n_out=V, loss="mcxent", activation="softmax",
                          has_bias=False, bias_init=0.1,
                          dropout=jdrop.GaussianDropout(0.2),
                          weight_noise=jdrop.WeightNoise(0.01),
                          constraints=[jcon.NonNegativeConstraint()])]
    mconf = JMLConf(layers=layers, input_type=JIT.recurrent(V, 12), seed=9,
                    updater=AdaMax(1e-2), tbptt=True, tbptt_fwd_length=6,
                    tbptt_back_length=4)
    mln = JMLN(mconf).init()
    g = (NeuralNetConfiguration.Builder().seed(4).updater(AdaDelta(rho=0.8))
         .graph_builder())
    g.add_inputs("in").set_input_types(JIT.recurrent(V, 12))
    g.add_layer("proj", jl.Convolution1DLayer(
        kernel=1, n_out=8, has_bias=False, dropout=0.7,
        weight_init="lecun_uniform", **common), "in")
    g.add_layer("lstm", jl.LSTM(n_out=6, activation="softsign",
                                dropout=jdrop.AlphaDropout(0.9),
                                weight_noise=jdrop.DropConnect(0.5),
                                constraints=[jcon.MinMaxNormConstraint(
                                    min_norm=0.1, max_norm=0.9)],
                                **common), "proj")
    g.add_layer("pool", jl.GlobalPoolingLayer(pooling_type="pnorm", pnorm=3.0,
                                              collapse_dimensions=False,
                                              dropout=0.9), "lstm")
    g.add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax",
                                      dropout=jdrop.GaussianNoise(0.1),
                                      weight_init="var_scaling_normal_fan_avg",
                                      **common), "pool")
    g.set_outputs("out")
    gconf = g.build()
    gconf.tbptt_fwd_length, gconf.tbptt_back_length = 7, 3
    graph = JGraph(gconf).init()
    x, y = _batch(b=3, t=12, seed=21)
    mln.fit(JDataSet(x, y), epochs=1)
    yg = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    graph.fit(x, yg, batch_size=3)
    return mln, graph, x


def test_a_jax_archive_with_every_a1_field_restores_in_the_port(tmp_path):
    mln, graph, x = _a1_nets()
    for jnet in (mln, graph):
        jpath = str(tmp_path / "jax.zip")
        jms.write_model(jnet, jpath)
        with zipfile.ZipFile(jpath) as zf:
            jjson = json.loads(zf.read("configuration.json"))
        back = tms.restore_model(jpath, device="cpu")
        # the configuration reads and writes key for key
        assert back.conf.to_dict() == jjson == jnet.conf.to_dict()
        np.testing.assert_allclose(_first(back.output(x)).numpy(),
                                   np.asarray(_first(jnet.output(x))),
                                   atol=1e-5, rtol=1e-5)
        # the updater state, key for key
        want = _np_tree(jnet.updater_state)
        got = updater_state_to_numpy(back.updater_state)
        assert json.dumps(_shapes(got)) == json.dumps(_shapes(want))
        if "t" in want:
            assert int(got["t"]) == int(want["t"]) == 2    # two tBPTT chunks
        tpath = str(tmp_path / "port.zip")
        tms.write_model(back, tpath)
        with zipfile.ZipFile(tpath) as zf:
            assert json.loads(zf.read("configuration.json")) == jjson
