"""The port's non-finite sentinel (``resilience/sentinel.py``) against
the JAX package's (``deeplearning4j_tpu/resilience/sentinel.py``).

The same numpy parameters go into both packages' networks, and one fit
call runs on a batch with one NaN planted in its features. Under the
default policy "skip" both leave the parameters, the updater state
(Adam's ``t`` included) and the layer state (BN statistics, the LSTM's
carried h / c) bit-equal to their values before the step, and count
one bad and one skipped step. Under "record" both apply the step (the
conv weights the NaN reaches turn NaN, Adam counts it) and count no
skip; under "off" both apply it with no accounting. A good step after
a skipped one agrees with JAX's at the tolerances of
``tests/test_torch_training.py`` (rtol 1e-5 on the score; parameters
within 1e-5 absolute of JAX's after one Adam step of lr 1e-2, both
sides summing in other orders) and of ``tests/test_torch_text_lstm.py``
(tBPTT: each parameter within 1e-3 of its own change).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import RmsProp as JRmsProp
from deeplearning4j_tpu.resilience import sentinel as jsentinel
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.updater import Adam, RmsProp
from deeplearning4j_tpu_torch.resilience import sentinel
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from torch_threads import one_thread  # noqa: F401 (autouse)

LR = 1e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_trees(net):
    return {"params": params_to_numpy(net.params),
            "updater": updater_state_to_numpy(net.updater_state),
            "state": state_to_numpy(net.state)}


def _jax_trees(net):
    return {"params": _np(net.params), "updater": _np(net.updater_state),
            "state": _np(net.state)}


def _flat(tree):
    return {"/".join(map(str, (k.key for k in path))): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _counts(net):
    acct = getattr(net, "_sentinel_accounting", None)
    return None if acct is None else (acct.total_steps, acct.bad_steps,
                                      acct.skipped_updates,
                                      acct.consecutive_bad)


def _bn_graphs():
    """A 1x1 conv -> BN (relu) -> average pool -> softmax graph with
    Adam, built by both packages; the port's loads the JAX parameters
    and BN statistics. The conv has no bias: BN cancels it, so its exact
    gradient is zero and Adam would move it by rounding noise."""
    def build(nnc, lib, it, upd):
        return (nnc.Builder().seed(3).updater(upd).graph_builder()
                .add_inputs("in").set_input_types(it.convolutional(6, 6, 4))
                .add_layer("c1", lib.ConvolutionLayer(
                    n_out=8, kernel=(1, 1), activation="identity",
                    has_bias=False), "in")
                .add_layer("bn1", lib.BatchNormalization(activation="relu"),
                           "c1")
                .add_layer("pool", lib.GlobalPoolingLayer(pooling_type="avg"),
                           "bn1")
                .add_layer("out", lib.OutputLayer(
                    n_out=3, loss="mcxent", activation="softmax"), "pool")
                .set_outputs("out").build())

    jnet = JGraph(build(JNNC, jl, JIT, JAdam(LR))).init()
    tnet = ComputationGraph(build(NeuralNetConfiguration, tl, InputType,
                                  Adam(LR))).init(device="cpu")
    tnet.load_numpy_params(_np(jnet.params))
    tnet.load_numpy_state(_np(jnet.state))
    return jnet, tnet


def _bn_batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4, 6, 6)).astype(np.float32)
    if nan:
        x[1, 2, 3, 4] = np.nan
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    return x, y


@pytest.mark.parametrize("policy", ["skip", "record", "off"])
def test_a_nan_batch_under_each_policy_as_in_jax(policy):
    jnet, tnet = _bn_graphs()
    jnet.nonfinite_policy = tnet.nonfinite_policy = policy
    jbefore, tbefore = _jax_trees(jnet), _port_trees(tnet)
    _assert_bit_equal(tbefore["params"], jbefore["params"])
    x, y = _bn_batch(0, nan=True)
    jnet.fit(x, y, batch_size=4)
    tnet.fit(x, y, batch_size=4)
    jafter, tafter = _jax_trees(jnet), _port_trees(tnet)
    assert tnet.iteration_count == jnet.iteration_count == 1
    assert np.isnan(tnet.score_value) and np.isnan(float(jnet.score_value))
    if policy == "skip":
        for key in ("params", "updater", "state"):
            _assert_bit_equal(jafter[key], jbefore[key])
            _assert_bit_equal(tafter[key], tbefore[key])
        assert int(tafter["updater"]["t"]) == int(jafter["updater"]["t"]) \
            == 0
        assert _counts(tnet) == _counts(jnet) == (1, 1, 1, 1)
        # the skipped step leaves a net that trains on: a good step as
        # JAX takes it
        x, y = _bn_batch(1)
        jnet.fit(x, y, batch_size=4)
        tnet.fit(x, y, batch_size=4)
        np.testing.assert_allclose(tnet.score_value,
                                   float(jnet.score_value), rtol=1e-5)
        got, want = _flat(params_to_numpy(tnet.params)), _flat(_np(
            jnet.params))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert _counts(tnet) == _counts(jnet) == (2, 1, 1, 0)
        return
    # record and off apply the step on both sides: the conv weights of
    # the NaN's input channel turn NaN (its gradient x^T dy meets the
    # NaN whatever dy is), and Adam counts the step
    for after in (tafter, jafter):
        w = _flat(after["params"])["c1/W"]
        assert np.isnan(w).any() and int(after["updater"]["t"]) == 1
    want_counts = (1, 1, 0, 1) if policy == "record" else None
    assert _counts(tnet) == _counts(jnet) == want_counts


def _lstm_nets():
    jnet = JaxLSTM(vocab_size=11, hidden=16, layers=2, max_length=5,
                   updater=JRmsProp(0.05)).init()
    tnet = TextGenerationLSTM(vocab_size=11, hidden=16, layers=2,
                              max_length=5,
                              updater=RmsProp(0.05)).init(device="cpu")
    tnet.load_numpy_params(_np(jnet.params))
    return jnet, tnet


def _lstm_batch(t, seed):
    ids = np.random.default_rng(seed).integers(0, 11, (3, t))
    x = np.zeros((3, 11, t), np.float32)
    x[np.arange(3)[:, None], ids, np.arange(t)[None, :]] = 1.0
    y = np.roll(x, -1, axis=2)
    x[2, 4, 1] = np.nan            # in the first tBPTT chunk
    return x, y


def test_a_poisoned_first_tbptt_chunk_carries_zeros_as_in_jax():
    """A MultiLayerNetwork trained with tBPTT (chunks of 5): a batch of
    one chunk with a NaN in it is skipped, and the h / c it would carry
    are zeros, not NaN (the state had none before the chunk); then a
    batch of two chunks whose first is poisoned trains on its second
    from zero carries, as JAX's does."""
    jnet, tnet = _lstm_nets()
    start = _np(jnet.params)
    g2 = updater_state_to_numpy(tnet.updater_state)
    x, y = _lstm_batch(5, seed=1)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    _assert_bit_equal(params_to_numpy(tnet.params), start)
    _assert_bit_equal(_np(jnet.params), start)
    _assert_bit_equal(updater_state_to_numpy(tnet.updater_state), g2)
    for k in ("0", "1"):
        for name in ("h", "c"):
            carry = tnet.state[k][name]
            assert carry.shape == (3, 16)
            assert torch.equal(carry, torch.zeros_like(carry)), (k, name)
            assert not np.asarray(jnet.state[k][name]).any(), (k, name)
    assert _counts(tnet) == _counts(jnet) == (1, 1, 1, 1)

    x, y = _lstm_batch(10, seed=2)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert tnet.iteration_count == jnet.iteration_count == 3
    assert _counts(tnet) == _counts(jnet) == (3, 2, 2, 0)
    assert tnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=1e-5)
    got, want = params_to_numpy(tnet.params), _np(jnet.params)
    for k in want:
        for n in want[k]:
            change = np.abs(want[k][n] - start[k][n]).max()
            assert change > 0, (k, n)
            err = np.abs(got[k][n] - want[k][n]).max() / change
            assert err <= 1e-3, (k, n, err)


@pytest.mark.parametrize("module", [sentinel, jsentinel],
                         ids=["port", "jax"])
def test_the_default_policy_round_trips_and_unknown_ones_raise(module):
    assert module.POLICIES == ("skip", "record", "off")
    assert module.effective_policy(None) == "skip"
    prev = module.set_default_nonfinite_policy("record")
    try:
        assert prev == "skip"
        assert module.effective_policy(None) == "record"
        assert module.set_default_nonfinite_policy("off") == "record"
        with pytest.raises(ValueError, match="policy must be one of"):
            module.set_default_nonfinite_policy("ignore")
        assert module.effective_policy(None) == "off"
    finally:
        module.set_default_nonfinite_policy(prev)
    assert module.effective_policy(None) == "skip"

    class Model:
        nonfinite_policy = "bogus"
    with pytest.raises(ValueError, match="nonfinite_policy must be one of"):
        module.effective_policy(Model())


def test_where_finite_falls_back_to_zeros_for_new_leaves():
    ok = torch.tensor(False)
    old = {"a": {"w": torch.ones(2)}, "b": {"h": torch.ones(3)}}
    new = {"a": {"w": torch.full((2,), float("nan")), "n": torch.ones(2)},
           "b": {"h": torch.full((4,), float("nan"))}, "c": None}
    out = sentinel.where_finite(ok, new, old)
    assert torch.equal(out["a"]["w"], torch.ones(2))
    assert torch.equal(out["a"]["n"], torch.zeros(2))     # new leaf
    assert torch.equal(out["b"]["h"], torch.zeros(4))     # new shape
    assert out["c"] is None
    out = sentinel.where_finite(torch.tensor(True), new, old)
    assert out["a"]["n"] is not None and torch.equal(out["a"]["n"],
                                                     torch.ones(2))
    # the raw gradients are tested, the loss too
    assert not bool(sentinel.tree_finite(torch.tensor(1.0),
                                         {"a": {"w": torch.tensor(
                                             [0.0, float("inf")])}}))
    assert not bool(sentinel.tree_finite(torch.tensor(float("nan")),
                                         {"a": {"w": torch.zeros(2)}}))
    assert bool(sentinel.tree_finite(torch.tensor(1.0),
                                     {"a": {"w": torch.zeros(2)}}))


@pytest.mark.parametrize("ok", [True, False])
def test_guard_updates_selects_whole_trees_bit_for_bit(ok):
    """The skip select over several trees at once: each leaf is exactly
    the new or the old value, Adam's int32 t included; "record" passes
    the new trees through."""
    g = torch.Generator().manual_seed(0)
    new_p = {"a": {"W": torch.randn(3, 5, generator=g),
                   "b": torch.full((7,), float("inf"))}}
    old_p = {"a": {"W": torch.randn(3, 5, generator=g),
                   "b": torch.randn(7, generator=g)}}
    new_u = {"m": new_p, "t": torch.tensor(4, dtype=torch.int32)}
    old_u = {"m": old_p, "t": torch.tensor(3, dtype=torch.int32)}
    flag = torch.tensor(ok)
    p, u = sentinel.guard_updates(flag, "skip", (new_p, old_p),
                                  (new_u, old_u))
    want_p, want_u = (new_p, new_u) if ok else (old_p, old_u)
    for got, want in ((p["a"]["W"], want_p["a"]["W"]),
                      (p["a"]["b"], want_p["a"]["b"]),
                      (u["m"]["a"]["W"], want_u["m"]["a"]["W"]),
                      (u["t"], want_u["t"])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert sentinel.guard_updates(flag, "record", (new_p, old_p))[0] \
        is new_p
