"""The port's regularization (deeplearning4j_tpu_torch/nn/conf/dropout.py,
constraints.py, the layers' new fields and the networks' training
generator) against the JAX package's, on the CPU.

Random draws cannot be shared between the packages (their generators
differ), so where a test holds a formula it injects the same draws
into both: ``jax.random.bernoulli`` / ``jax.random.normal`` and the
port's ``dropout.bernoulli`` / ``dropout.normal`` are replaced by
functions returning a mask (or noise) made from a numpy seed derived
from the draw's shape, so each draw site gets the same values in both.

- Each input dropout and weight noise under injected draws equals the
  JAX formula (f32 within 1e-7 of its scale; bf16 bit for bit, the
  Gaussian ones as the JAX f32 result rounded to bf16); with the real
  generator its retain rate (or its noise's moments) within four
  standard errors; identity in inference and without a generator.
- Each constraint equals JAX ``apply_constraints`` within 1e-7 (the
  norms' f32 sums in another order: one ulp).
- A sequential net with constraints on every layer (dropout 0) takes 3
  AdaMax ``fit`` steps as the JAX net does (parameters within 1e-6);
  one with DropConnect and dropout on its layers takes one step as the
  JAX net does under the same injected draws; a graph with dropout
  likewise, and a graph's constraints and weight noise change nothing
  in either package (the JAX graph applies neither).
- Per-layer ``learning_rate`` and ``updater`` change no step in the JAX
  package, nor in the port.
- The LSTM scan route (hardsigmoid gates, softsign cell, both) against
  the JAX ``lstm_scan``: outputs, carries and ``jax.grad`` within 1e-5.
- ``EmbeddingLayer`` and ``DropoutLayer`` against the JAX layers.
- The fused plans leave out a block, a group or a stem with dropout.
- The training generator: the same seed gives the same masks, another
  seed others, each step and each layer its own; inference draws
  nothing; archives carry no generator.
"""

import copy
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import constraints as jcon
from deeplearning4j_tpu.nn.conf import dropout as jdrop
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf)
from deeplearning4j_tpu.nn.conf.network import (
    NeuralNetConfiguration as JNNConf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import AdaMax as JAdaMax
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu_torch.nn.conf import constraints as tcon
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import AdaDelta
from deeplearning4j_tpu_torch.util import model_serializer as tms
from torch_threads import one_thread  # noqa: F401 (autouse)


def _seed(shape, kind):
    return abs(hash((tuple(int(s) for s in shape), kind))) % (2 ** 31)


def _mask(shape, p):
    return np.random.default_rng(_seed(shape, "mask")).random(
        tuple(shape)) < p


def _noise(shape):
    return np.random.default_rng(_seed(shape, "noise")).standard_normal(
        tuple(shape)).astype(np.float32)


@pytest.fixture
def injected(monkeypatch):
    """The same draws in both packages, by the draw's shape."""
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(_mask(shape, p)))
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(_noise(shape)))
    monkeypatch.setattr(tdrop, "bernoulli", lambda p, like, gen: torch.tensor(
        _mask(like.shape, p), device=like.device))
    monkeypatch.setattr(tdrop, "normal", lambda like, gen: torch.tensor(
        _noise(like.shape), device=like.device))


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


DROPOUTS = {
    "Dropout": dict(p=0.7),
    "AlphaDropout": dict(p=0.8),
    "GaussianDropout": dict(rate=0.3),
    "GaussianNoise": dict(stddev=0.2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_dropout_formula_under_the_same_draws(injected, name, dtype):
    x = _x((12, 9), seed=1, scale=2.0)
    jd = getattr(jdrop, name)(**DROPOUTS[name])
    td = tdrop.dropout_from_dict(jd.to_dict())
    assert td.to_dict() == jd.to_dict()
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    with jax.disable_jit():
        want = jd.apply_dropout(jx, jax.random.PRNGKey(0))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    got = td.apply_dropout(tx, torch.Generator())
    assert got.dtype == tx.dtype
    want = np.asarray(want.astype(jx.dtype).astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7,
                                   atol=1e-7 * np.abs(want).max())


def test_the_float_shorthand_and_the_dropout_layer(injected):
    x = _x((10, 7), seed=2)
    for jlayer in (jl.DenseLayer(n_in=7, n_out=7, dropout=0.6),
                   jl.DropoutLayer()):
        tlayer = tl.layer_from_dict(jl.layer_to_dict(jlayer))
        assert tl.layer_to_dict(tlayer) == jl.layer_to_dict(jlayer)
        keep = jlayer.dropout
        want = jlayer.maybe_dropout_input(jnp.asarray(x), True,
                                          jax.random.PRNGKey(0))
        got = tlayer.maybe_dropout_input(torch.tensor(x), True,
                                         torch.Generator())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
        assert ((got != 0).numpy() == _mask(x.shape, keep)).all()
    assert tl.DropoutLayer().dropout == 0.5
    assert tl.DropoutLayer(dropout=0.9).dropout == 0.9
    # the dropout layer forwards through apply, as the JAX layer does
    jd = jl.DropoutLayer(dropout=0.75)
    want, _ = jd.apply({}, jnp.asarray(x), {}, train=True,
                       rng=jax.random.PRNGKey(0))
    got, _ = tl.DropoutLayer(dropout=0.75).apply({}, torch.tensor(x), {},
                                                 train=True,
                                                 gen=torch.Generator())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


NOISES = {"DropConnect": [dict(p=0.6), dict(p=0.8, apply_to_biases=True)],
          "WeightNoise": [dict(stddev=0.05),
                          dict(stddev=0.1, additive=False,
                               apply_to_biases=True)]}


@pytest.mark.parametrize("name,kw", [(n, kw) for n in sorted(NOISES)
                                     for kw in NOISES[n]])
def test_weight_noise_formula_under_the_same_draws(injected, name, kw):
    params = {"W": _x((5, 8), 3), "RW": _x((2, 8), 4), "P": _x((3, 2), 5),
              "b": _x((8,), 6)}
    jn = getattr(jdrop, name)(**kw)
    tn = tdrop.weight_noise_from_dict(jn.to_dict())
    assert tn.to_dict() == jn.to_dict()
    with jax.disable_jit():
        want = jn.apply_to_params({k: jnp.asarray(v)
                                   for k, v in params.items()},
                                  jax.random.PRNGKey(0))
    got = tn.apply_to_params({k: torch.tensor(v) for k, v in params.items()},
                             torch.Generator())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-7, atol=1e-7, err_msg=k)
    if not kw.get("apply_to_biases"):
        assert torch.equal(got["b"], torch.tensor(params["b"]))


def test_retain_rates_and_noise_moments():
    g = torch.Generator().manual_seed(0)
    ones = torch.ones(400, 500)
    n = ones.numel()
    for keep in (0.5, 0.8, 0.95):
        y = tdrop.Dropout(keep).apply_dropout(ones, g)
        kept = float((y != 0).float().mean())
        assert abs(kept - keep) < 4 * np.sqrt(keep * (1 - keep) / n)
        assert torch.allclose(y[y != 0], torch.full((), 1 / keep))
        w = tdrop.DropConnect(keep).apply_to_params(
            {"W": ones, "b": ones}, g)
        assert abs(float((w["W"] != 0).float().mean()) - keep) < \
            4 * np.sqrt(keep * (1 - keep) / n)
        assert torch.equal(w["b"], ones)
    a = tdrop.AlphaDropout(0.9).apply_dropout(torch.zeros(400, 500), g)
    assert len(torch.unique(a)) == 2
    gd = tdrop.GaussianDropout(0.2).apply_dropout(ones, g)
    assert abs(float(gd.mean()) - 1) < 4 * 0.5 / np.sqrt(n)
    assert abs(float(gd.std()) / 0.5 - 1) < 0.02
    gn = tdrop.GaussianNoise(0.3).apply_dropout(torch.zeros(400, 500), g)
    assert abs(float(gn.std()) / 0.3 - 1) < 0.02
    wn = tdrop.WeightNoise(0.01).apply_to_params({"W": ones}, g)["W"]
    assert abs(float((wn - 1).std()) / 0.01 - 1) < 0.02


def test_identity_at_inference():
    x = torch.tensor(_x((6, 5), 7))
    g = torch.Generator()
    for layer in (tl.DenseLayer(n_in=5, n_out=5, dropout=0.5),
                  tl.DenseLayer(n_in=5, n_out=5,
                                dropout=tdrop.GaussianNoise(1.0)),
                  tl.DropoutLayer()):
        assert torch.equal(layer.maybe_dropout_input(x, False, g), x)
        assert torch.equal(layer.maybe_dropout_input(x, True, None), x)
    for d in (0.0, 1.0):
        assert torch.equal(tl.DenseLayer(dropout=d).maybe_dropout_input(
            x, True, g), x)


# ---------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------
CONSTRAINTS = [
    ("MaxNormConstraint", dict(max_norm=0.7)),
    ("MaxNormConstraint", dict(max_norm=0.5, dimensions=(1,),
                               apply_to_biases=True)),
    ("MinMaxNormConstraint", dict(min_norm=0.3, max_norm=0.6, rate=0.5)),
    ("NonNegativeConstraint", dict(apply_to_biases=True)),
    ("UnitNormConstraint", dict(dimensions=(0, 1))),
    ("UnitNormConstraint", dict(dimensions=(5,), apply_to_weights=False,
                                apply_to_biases=True)),
]


@pytest.mark.parametrize("name,kw", CONSTRAINTS)
def test_constraint_against_jax(name, kw):
    jc = getattr(jcon, name)(**kw)
    tc = tcon.constraint_from_dict(jc.to_dict())
    assert tc.to_dict() == jc.to_dict()
    params = {"0": {"W": _x((6, 5), 8), "b": _x((5,), 9)},
              "1": {"W": _x((4, 3, 2), 10, 0.2), "RW": _x((3, 4), 11)},
              "2": {"gamma": _x((4,), 12)}}
    jlayers = [jl.DenseLayer(constraints=[jc]),
               jl.DenseLayer(constraints=[
                   jc, jcon.MaxNormConstraint(max_norm=0.4)]),
               jl.DenseLayer()]
    tlayers = [tl.layer_from_dict(jl.layer_to_dict(x)) for x in jlayers]
    assert [tl.layer_to_dict(x) for x in tlayers] == \
        [jl.layer_to_dict(x) for x in jlayers]
    want = jcon.apply_constraints(jlayers, jax.tree_util.tree_map(
        jnp.asarray, params))
    got = tcon.apply_constraints(tlayers, {k: {n: torch.tensor(v)
                                               for n, v in p.items()}
                                           for k, p in params.items()})
    for k, p in want.items():
        for n, w in p.items():
            np.testing.assert_allclose(got[k][n].numpy(), np.asarray(w),
                                       rtol=1e-7, atol=1e-7,
                                       err_msg=f"{k}/{n}")


# ---------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------
def _mln_pair(layers, updater=None, seed=3):
    """The JAX net and the port's from one configuration (its JSON), the
    JAX parameters loaded into the port's."""
    jconf = JMLConf(layers=layers, input_type=JIT.feed_forward(6),
                    seed=seed, updater=updater or JAdaMax(2e-2))
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jconf.to_dict()))).init(device="cpu")
    assert tnet.conf.to_dict() == jconf.to_dict()
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _data(n=10, seed=4, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _assert_params(tnet, jnet, tol=1e-6):
    for k, p in jnet.params.items():
        for n, w in p.items():
            np.testing.assert_allclose(tnet.params[k][n].numpy(),
                                       np.asarray(w), atol=tol, rtol=tol,
                                       err_msg=f"{k}/{n}")


def test_constraints_over_three_fit_steps_against_jax():
    layers = [
        jl.DenseLayer(n_out=8, activation="tanh",
                      constraints=[jcon.MaxNormConstraint(max_norm=0.5)]),
        jl.DenseLayer(n_out=7, activation="softplus", constraints=[
            jcon.MinMaxNormConstraint(min_norm=0.2, max_norm=0.4, rate=0.5),
            jcon.NonNegativeConstraint(apply_to_biases=True)]),
        jl.OutputLayer(n_out=3, loss="mcxent", activation="softmax",
                       constraints=[jcon.UnitNormConstraint(
                           dimensions=(1,))])]
    jnet, tnet = _mln_pair(layers)
    x, y = _data()
    for _ in range(3):
        jnet.fit(x, y, batch_size=10)
        tnet.fit(x, y, batch_size=10)
        np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                                   rtol=1e-6)
        _assert_params(tnet, jnet)
    for k, v in jnet.updater_state["u"].items():
        for n, w in v.items():
            np.testing.assert_allclose(
                tnet.updater_state["u"][k][n].numpy(), np.asarray(w),
                atol=1e-6, rtol=1e-6)
    assert int(tnet.updater_state["t"]) == int(jnet.updater_state["t"]) == 3


def test_dropout_and_drop_connect_step_against_jax(injected):
    layers = [
        jl.DenseLayer(n_out=8, activation="tanh",
                      weight_noise=jdrop.DropConnect(0.7)),
        jl.DenseLayer(n_out=7, activation="relu", dropout=0.6),
        jl.OutputLayer(n_out=3, loss="mcxent", activation="softmax",
                       dropout=jdrop.AlphaDropout(0.9))]
    jnet, tnet = _mln_pair(layers, updater=JSgd(0.3))
    x, y = _data()
    jnet.fit(x, y, batch_size=10)
    tnet.fit(x, y, batch_size=10)
    np.testing.assert_allclose(tnet.score_value, float(jnet.score_value),
                               rtol=1e-6)
    _assert_params(tnet, jnet)
    # inference draws nothing
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)


def _graph_pair(extra, updater=None):
    """The JAX graph (in -> dense -> output) and the port's from its
    JSON, the JAX parameters loaded into the port's."""
    g = (JNNConf.Builder().seed(5)
         .updater(updater or JSgd(0.2)).graph_builder())
    g.add_inputs("in").set_input_types(JIT.feed_forward(6))
    g.add_layer("d", jl.DenseLayer(n_out=8, activation="tanh", **extra), "in")
    g.add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax", dropout=0.8),
                "d")
    g.set_outputs("out")
    jconf = g.build()
    jnet = JGraph(jconf).init()
    tnet = ComputationGraph(ComputationGraphConfiguration.from_dict(
        copy.deepcopy(jconf.to_dict()))).init(device="cpu")
    assert tnet.conf.to_dict() == jconf.to_dict()
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def test_a_graph_drops_as_the_jax_graph_and_applies_no_noise(injected):
    x, y = _data()
    plain = _graph_pair({"dropout": 0.7})
    extra = _graph_pair({"dropout": 0.7,
                         "weight_noise": jdrop.DropConnect(0.5),
                         "constraints": [
                             jcon.MaxNormConstraint(max_norm=0.1)]})
    for jnet, tnet in (plain, extra):
        jnet.fit(x, y, batch_size=10)
        tnet.fit(x, y, batch_size=10)
        np.testing.assert_allclose(tnet.score_value,
                                   float(jnet.score_value), rtol=1e-6)
        _assert_params(tnet, jnet)
    # the JAX graph applies neither weight noise nor constraints: both
    # graphs took the same step
    for k, p in plain[1].params.items():
        for n, w in p.items():
            assert torch.equal(w, extra[1].params[k][n])


def test_per_layer_learning_rate_and_updater_change_no_step():
    x, y = _data(seed=5)
    runs = []
    for kw in ({}, {"learning_rate": 5.0,
                    "updater": {"@class": "Sgd", "learning_rate": 9.0}}):
        layers = [jl.DenseLayer(n_out=8, activation="tanh", **kw),
                  jl.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax", **kw)]
        jnet, tnet = _mln_pair(layers, updater=JSgd(0.1))
        jnet.fit(x, y, batch_size=10)
        tnet.fit(x, y, batch_size=10)
        _assert_params(tnet, jnet)
        assert tnet.layers[0].learning_rate == kw.get("learning_rate")
        runs.append((jax.tree_util.tree_map(np.asarray, jnet.params),
                     tnet.params))
    (j0, t0), (j1, t1) = runs
    for k in j0:
        for n in j0[k]:
            np.testing.assert_array_equal(j0[k][n], j1[k][n])
            assert torch.equal(t0[k][n], t1[k][n])


# ---------------------------------------------------------------------
# the LSTM scan route
# ---------------------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("gate,cell", [("hardsigmoid", "tanh"),
                                       ("sigmoid", "softsign"),
                                       ("hardsigmoid", "softsign")])
def test_lstm_scan_route_against_jax(gate, cell, reverse):
    rng = np.random.default_rng(6)
    n, c, t, h = 3, 4, 5, 6
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    d = {"x": _x((n, c, t), 13), "w": _x((c, 4 * h), 14, 0.4),
         "rw": _x((h, 4 * h), 15, 0.3), "b": _x((4 * h,), 16, 0.1),
         "h0": _x((n, h), 17, 0.5), "c0": _x((n, h), 18, 0.5),
         "p": _x((3, h), 19, 0.5)}
    kw = dict(gate_act=gate, cell_act=cell, reverse=reverse)

    def jloss(a):
        out, ht, ct = jrec.lstm_scan(a["x"], a["w"], a["rw"], a["b"],
                                     a["h0"], a["c0"], a["p"],
                                     jnp.asarray(mask), **kw)
        return jnp.sum(out * 0.3) + jnp.sum(ht) - jnp.sum(ct * 0.7), \
            (out, ht, ct)

    (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in d.items()})
    a = {k: torch.tensor(v, requires_grad=True) for k, v in d.items()}
    runs = trec.LSTM_SCAN.runs
    out, ht, ct = trec.lstm_scan(a["x"], a["w"], a["rw"], a["b"], a["h0"],
                                 a["c0"], a["p"], torch.tensor(mask), **kw)
    assert trec.LSTM_SCAN.runs == runs + 1
    (out.sum() * 0.3 + ht.sum() - (ct * 0.7).sum()).backward()
    for got, want in zip((out, ht, ct), jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    for k in d:
        np.testing.assert_allclose(a[k].grad.numpy(), np.asarray(jg[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_the_route_follows_the_activations_alone():
    assert trec.lstm_route("sigmoid", "tanh") == "kernel"
    assert trec.lstm_route("Sigmoid", "TANH") == "kernel"
    for g, c in (("hardsigmoid", "tanh"), ("sigmoid", "relu"),
                 ("tanh", "sigmoid")):
        assert trec.lstm_route(g, c) == "scan"


# ---------------------------------------------------------------------
# the embedding and dropout layers, the fused plans
# ---------------------------------------------------------------------
def test_embedding_layer_against_jax():
    for kw in ({}, {"has_bias": False, "bias_init": 0.3},
               {"bias_init": -0.2, "activation": "tanh"}):
        jlayer = jl.EmbeddingLayer(n_in=11, n_out=5, **kw)
        tlayer = tl.layer_from_dict(jl.layer_to_dict(jlayer))
        jp, _ = jlayer.init(jax.random.PRNGKey(0), JIT.feed_forward(11))
        tp, _ = tlayer.init(torch.Generator().manual_seed(0),
                            InputType.feed_forward(11), "cpu")
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        if "b" in jp:
            np.testing.assert_array_equal(tp["b"].numpy(), np.asarray(
                jp["b"]))
        tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        for idx in (np.array([[3.0], [0.0], [10.0], [3.0]], np.float32),
                    np.array([1.0, 7.0], np.float32)):
            want, _ = jlayer.apply(jp, jnp.asarray(idx), {})
            got, _ = tlayer.apply(tp, torch.tensor(idx), {})
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6)
        assert tl.layer_to_dict(tlayer) == jl.layer_to_dict(jlayer)


def test_dist_and_bias_init_reach_the_layers():
    dense = tl.DenseLayer(n_in=4, n_out=3, weight_init="distribution",
                          dist={"type": "constant", "value": 0.5},
                          bias_init=0.1)
    p, _ = dense.init(torch.Generator(), InputType.feed_forward(4), "cpu")
    assert torch.equal(p["W"], torch.full((4, 3), 0.5))
    assert torch.equal(p["b"], torch.full((3,), 0.1))
    rnn_out = tl.RnnOutputLayer(n_in=4, n_out=3, bias_init=-0.25)
    p, _ = rnn_out.init(torch.Generator(), InputType.recurrent(4, 2), "cpu")
    assert torch.equal(p["b"], torch.full((3,), -0.25))
    p, _ = tl.RnnOutputLayer(n_in=4, n_out=3, has_bias=False).init(
        torch.Generator(), InputType.recurrent(4, 2), "cpu")
    assert set(p) == {"W"}
    lstm = tl.GravesLSTM(n_in=3, n_out=2, weight_init="distribution",
                         dist={"type": "uniform", "lower": 2.0,
                               "upper": 3.0})
    p, _ = lstm.init(torch.Generator(), InputType.recurrent(3, 2), "cpu")
    assert float(p["W"].min()) >= 2.0 and float(p["RW"].max()) <= 3.0
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        tl.Convolution1DLayer(kernel=1, stride=2)
    p, _ = tl.Convolution1DLayer(n_in=3, n_out=2, has_bias=False).init(
        torch.Generator(), InputType.recurrent(3, 2), "cpu")
    assert set(p) == {"W"}


def test_fused_plans_leave_out_layers_with_dropout():
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(num_classes=10, height=32, width=32,
                   data_format="NHWC").init(device="cpu")
    conf = net.conf
    groups = sorted(net.set_fusion(True)._conv_plan())
    net.set_fusion("bottleneck", stem=True)
    _, bplan, splan = net._fusion()
    assert len(groups) == 16 and len(bplan) == 16 and len(splan) == 1
    # a dropout on one group's conv, one block's 3x3 and the stem's pad
    conf.vertices[groups[0]].layer.dropout = 0.9
    assert sorted(net.set_fusion(True)._conv_plan()) == groups[1:]
    conf.vertices[groups[0]].layer.dropout = 0.0
    net.set_fusion("bottleneck", stem=True)
    _, bplan, splan = net._fusion()
    block = sorted(bplan)[0]
    member = bplan[block]["conv_b"]
    conf.vertices[member].layer.dropout = tdrop.Dropout(0.9)
    pad = next(m for m in splan["stem_pool"]["members"]
               if isinstance(conf.vertices[m].layer, tl.ZeroPaddingLayer))
    conf.vertices[pad].layer.dropout = 0.5
    net.set_fusion(False)           # a new plan signature drops the cache
    net.set_fusion("bottleneck", stem=True)
    _, bplan2, splan2 = net._fusion()
    assert sorted(bplan2) == sorted(bplan)[1:] and not splan2


# ---------------------------------------------------------------------
# the training generator
# ---------------------------------------------------------------------
def _drop_net(seed=7):
    layers = [tl.DenseLayer(n_in=6, n_out=8, activation="tanh", dropout=0.5),
              tl.DenseLayer(n_out=8, activation="tanh",
                            weight_noise=tdrop.DropConnect(0.6)),
              tl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    conf = MultiLayerConfiguration(layers=layers,
                                   input_type=InputType.feed_forward(6),
                                   seed=seed)
    return MultiLayerNetwork(conf).init(device="cpu")


def test_the_training_generator():
    x, y = _data()
    a, b, c = _drop_net(), _drop_net(), _drop_net()
    c._train_gen.manual_seed(99)
    for net in (a, b, c):
        net.fit(x, y, batch_size=10)
    for k, p in a.params.items():
        for n, w in p.items():
            assert torch.equal(w, b.params[k][n])
    assert not torch.equal(a.params["0"]["W"], c.params["0"]["W"])
    # one generator a drawing layer, each its own stream, each step anew
    state = a._train_gen.get_state()
    g1 = a._step_gens()
    assert sorted(g1) == ["0", "1"]
    g2 = a._step_gens()
    draws = [torch.rand(64, generator=g) for g in (g1["0"], g1["1"],
                                                   g2["0"])]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    a._train_gen.set_state(state)
    assert torch.equal(torch.rand(64, generator=a._step_gens()["0"]),
                       draws[0])
    # inference draws nothing, and gives the same output every time
    state = a._train_gen.get_state()
    out = a.output(x)
    assert torch.equal(a._train_gen.get_state(), state)
    assert torch.equal(a.output(x), out)
    assert not torch.equal(a.output(x, train=True), out)


def test_archives_carry_no_generator_and_every_new_field(tmp_path):
    net = _drop_net()
    net.conf.layers[0].constraints = [tcon.MaxNormConstraint(max_norm=0.5)]
    net.conf.updater = AdaDelta()
    net.updater_state = net.conf.updater.init_state(net.params)
    x, y = _data()
    net.fit(x, y, batch_size=10)
    path = str(tmp_path / "m.zip")
    tms.write_model(net, path)
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        conf = zf.read("configuration.json").decode()
    assert not any("gen" in n for n in names)
    assert sorted(n for n in names if n.startswith("updater/")) == sorted(
        f"updater/{s}/{k}/{p}.npy" for s in ("g2", "dx2")
        for k in ("0", "1", "2") for p in net.params[k])
    back = tms.restore_model(path, device="cpu")
    assert back.conf.to_json() == conf
    assert isinstance(back.conf.layers[1].weight_noise, tdrop.DropConnect)
    for name in ("g2", "dx2"):
        for k, p in net.updater_state[name].items():
            for n, t in p.items():
                assert torch.equal(t, back.updater_state[name][k][n])
