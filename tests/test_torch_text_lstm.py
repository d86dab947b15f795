"""The port's text LSTM on MultiLayerNetwork (deeplearning4j_tpu_torch/
nn/multilayer.py, zoo/text_lstm.py) and its recurrent graph against the
JAX package, on the CPU, where the recurrence kernels' plain versions
run.

- A small TextGenerationLSTM (vocab 11, hidden 16, 2 GravesLSTM layers,
  max_length 5) with the JAX network's parameters carried across (its
  peepholes and biases drawn away from their zero and one inits, so
  that they count):
  - ``output`` and ``output(mask=)`` in f32 within 1e-5 (3e-8 read);
    in bf16 (h and c rounded at each step's end on both sides; JAX's scan
    rounds each gate's pre-activation twice, XLA on the CPU keeps f32
    between some bf16 ops, the sums run in other orders) each position's
    distribution within two bf16 ulps (2^-6) of its largest probability
    (8.4e-3 read) and each 64-position tile within one ulp (2^-8) of its
    summed probability on average (2.5e-3 read);
  - ``rnn_time_step`` over chunks of 5, 1 and 6 steps (h / c carried)
    equal to the JAX network's within 1e-5, and to one-shot ``output``;
  - ``sample_stream`` draws the same ids as JAX's for the same numpy rng;
  - ``fit`` over T = 12 (three tBPTT chunks a batch) with RmsProp(0.05)
    and the element-wise clip, two epochs (six steps): the loss within
    1e-5 relative, and each parameter leaf within 1e-3 of its own update
    (its largest difference over its largest change; RmsProp moves an
    entry by up to ~4.5 lr whatever its gradient's size, so an entry
    whose gradient is a near-cancelling sum, summed in another order,
    moves visibly apart: 6.2e-5 absolute in 6 of RW's 1,024 entries;
    1.6e-4 read) and RmsProp's g2 within 1e-3 of each leaf's
    largest value (2.6e-5 read) against the JAX network's;
  - ``score`` and ``num_params``.
- A sequential net of GravesBidirectionalLSTM -> LSTM -> RnnOutputLayer
  from both packages' list builders: ``output`` with and without a mask
  and one Sgd step's parameters against the JAX network's in f32 (atol
  1e-6, rtol 1e-5; 3.0e-8 read for both).
- The recurrent graph anchor ``tests/fixtures/regression_cg_v1.zip``
  (GravesLSTM + LSTM -> add -> MergeVertex -> RnnOutputLayer), its
  parameters read through the JAX ``restore_computation_graph``:
  ``regression_cg_v1_output.npy`` reproduced within the JAX test's
  ``OUT_ATOL`` of 5e-3 (6.0e-8 read; 1e-6 held), and ``rnn_time_step``
  carrying each LSTM vertex's h / c, chunk by chunk, equal to the JAX
  graph's stream and to one-shot ``output``.
- Entry points default to the card and raise without one; the left-out
  parts raise NotImplementedError naming their ROADMAP.md items; beam
  search returns the JAX package's result.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.updater import RmsProp as JRmsProp
from deeplearning4j_tpu.util.model_serializer import (
    restore_computation_graph)
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JaxLSTM
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseVertex, MergeVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers.flash_attention import agreement
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Nesterovs, RmsProp
from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
from torch_threads import one_thread  # noqa: F401 (autouse)

V, H, LAYERS, MAXLEN = 11, 16, 2, 5
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
OUT_ATOL = 5e-3          # tests/test_regression_formats.py


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _one_hot(ids):
    b, t = ids.shape
    x = np.zeros((b, V, t), np.float32)
    x[np.arange(b)[:, None], ids, np.arange(t)[None, :]] = 1.0
    return x


def _nets(lr=0.05):
    """The JAX network and the port's, the JAX parameters (peepholes and
    biases redrawn) loaded into both."""
    jnet = JaxLSTM(vocab_size=V, hidden=H, layers=LAYERS, max_length=MAXLEN,
                   updater=JRmsProp(lr)).init()
    rng = np.random.default_rng(0)
    params = _np_tree(jnet.params)
    for k in map(str, range(LAYERS)):
        params[k]["P"] = (0.5 * rng.standard_normal(
            params[k]["P"].shape)).astype(np.float32)
        params[k]["b"] = params[k]["b"] + (0.2 * rng.standard_normal(
            params[k]["b"].shape)).astype(np.float32)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = TextGenerationLSTM(vocab_size=V, hidden=H, layers=LAYERS,
                              max_length=MAXLEN,
                              updater=RmsProp(lr)).init(device="cpu")
    tnet.load_numpy_params(params)
    return jnet, tnet


def _batch(b=3, t=12, seed=1):
    ids = np.random.default_rng(seed).integers(0, V, (b, t))
    x = _one_hot(ids)
    return x, np.roll(x, -1, axis=2)


@pytest.fixture(scope="module")
def nets():
    return _nets()


def test_the_port_builds_the_jax_networks_structure(nets):
    jnet, tnet = nets
    assert isinstance(tnet, MultiLayerNetwork)
    assert [type(l).__name__ for l in tnet.layers] == \
        [type(l).__name__ for l in jnet.layers]
    assert tnet.conf.tbptt and tnet.conf.tbptt_fwd_length == MAXLEN
    assert tnet.num_params() == jnet.num_params()
    shapes = {(k, n): tuple(t.shape) for k, p in tnet.params.items()
              for n, t in p.items()}
    assert shapes == {(k, n): tuple(a.shape)
                      for k, p in jnet.params.items() for n, a in p.items()}


def test_output_and_masked_output_match_jax_f32(nets):
    jnet, tnet = nets
    x, _ = _batch()
    mask = (np.random.default_rng(2).random((3, 12)) > 0.3).astype(
        np.float32)
    for m in (None, mask):
        want = np.asarray(jnet.output(x, mask=m))
        got = tnet.output(x, mask=m).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_output_bf16_against_jax():
    jnet, tnet = _nets()
    jnet.conf.dtype = tnet.conf.dtype = "bfloat16"
    x, _ = _batch(seed=3)
    want = np.asarray(jnet.output(x), np.float32)
    got = tnet.output(x)

    def rows(a):       # [N, V, T] -> one row per position
        a = torch.as_tensor(np.array(a, np.float32))
        return a.permute(0, 2, 1).reshape(1, 1, -1, V)

    row_rel, tile_rel = agreement(rows(got), rows(want))
    assert row_rel <= 2 ** -6 and tile_rel <= 2 ** -8, (row_rel, tile_rel)


def test_chunked_rnn_time_step_matches_jax_and_one_shot(nets):
    jnet, tnet = nets
    x, _ = _batch(seed=4)
    jnet.rnn_clear_previous_state()
    tnet.rnn_clear_previous_state()
    cols = []
    for a, b in ((0, 5), (5, 6), (6, 12)):
        want = np.asarray(jnet.rnn_time_step(x[:, :, a:b]))
        got = tnet.rnn_time_step(x[:, :, a:b])
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        cols.append(got)
    assert set(tnet.state["0"]) == {"h", "c"}
    np.testing.assert_allclose(torch.cat(cols, dim=2).numpy(),
                               tnet.output(x).numpy(), atol=1e-6)
    tnet.rnn_clear_previous_state()
    assert tnet.state == {"0": {}, "1": {}, "2": {}}
    # a left-padded chunk leaves the state as the unpadded one does
    np.testing.assert_allclose(
        tnet.rnn_time_step(x[:, :, :5], pad_left=2)[:, :, 2:].numpy(),
        tnet.output(x[:, :, 2:5]).numpy(), atol=1e-6)


def test_sample_stream_draws_the_jax_ids(nets):
    jnet, tnet = nets
    kw = dict(vocab_size=V, hidden=H, layers=LAYERS, max_length=MAXLEN)
    for seed, temp in ((5, 1.0), (6, 0.7)):
        want = JaxLSTM(**kw).sample_stream(
            jnet, [1, 2, 3], 12, rng=np.random.default_rng(seed),
            temperature=temp)
        got = TextGenerationLSTM(**kw).sample_stream(
            tnet, [1, 2, 3], 12, rng=np.random.default_rng(seed),
            temperature=temp)
        assert got == want


def test_tbptt_fit_matches_jax_f32():
    jnet, tnet = _nets()
    x, y = _batch(seed=7)
    assert tnet.score(DataSet(x, y)) == pytest.approx(
        jnet.score(JDataSet(x, y)), rel=1e-6)
    start = _np_tree(jnet.params)
    jnet.fit(JDataSet(x, y), epochs=2)
    tnet.fit(DataSet(x, y), epochs=2)
    assert tnet.iteration_count == jnet.iteration_count == 6
    assert tnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=1e-5)
    got, want = params_to_numpy(tnet.params), _np_tree(jnet.params)
    g2 = updater_state_to_numpy(tnet.updater_state)["g2"]
    jg2 = _np_tree(jnet.updater_state)["g2"]
    for k in want:
        for n in want[k]:
            change = np.abs(want[k][n] - start[k][n]).max()
            err = np.abs(got[k][n] - want[k][n]).max() / change
            assert err <= 1e-3, (k, n, err)
            err = np.abs(g2[k][n] - jg2[k][n]).max() / np.abs(
                jg2[k][n]).max()
            assert err <= 1e-3, ("g2", k, n, err)
    # the carried h / c stay out of autograd between chunks
    assert not any(t.requires_grad for s in tnet.state.values()
                   for t in s.values())


def _bidirectional_nets():
    """A sequential net of GravesBidirectionalLSTM -> LSTM ->
    RnnOutputLayer built by both packages' list builders (Sgd, no tBPTT),
    the JAX parameters (peepholes redrawn) loaded into the port's."""
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.conf import layers as jl
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.updater import Sgd as JSgd
    from deeplearning4j_tpu_torch.nn.updater import Sgd

    def build(nnc, lib, it, upd):
        return (nnc.Builder().seed(9).updater(upd).list()
                .layer(lib.GravesBidirectionalLSTM(n_out=6))
                .layer(lib.LSTM(n_out=5))
                .layer(lib.RnnOutputLayer(n_out=V, loss="mcxent",
                                          activation="softmax"))
                .set_input_type(it.recurrent(V, 7)).build())

    jnet = JMLN(build(JNNC, jl, JIT, JSgd(0.5))).init()
    params = _np_tree(jnet.params)
    rng = np.random.default_rng(10)
    for k in ("PF", "PB"):
        params["0"][k] = (0.5 * rng.standard_normal(
            params["0"][k].shape)).astype(np.float32)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    tnet = MultiLayerNetwork(build(NeuralNetConfiguration, tl, InputType,
                                   Sgd(0.5))).init(device="cpu")
    return jnet, tnet.load_numpy_params(params)


def test_bidirectional_sequential_net_matches_jax_f32():
    jnet, tnet = _bidirectional_nets()
    x, y = _batch(b=4, t=7, seed=11)
    mask = np.ones((4, 7), np.float32)
    mask[1, 5:] = 0.0                       # a shorter row
    for m in (None, mask):
        np.testing.assert_allclose(tnet.output(x, mask=m).numpy(),
                                   np.asarray(jnet.output(x, mask=m)),
                                   atol=1e-5, rtol=1e-5)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    got, want = params_to_numpy(tnet.params), _np_tree(jnet.params)
    for k in want:
        for n in want[k]:
            np.testing.assert_allclose(got[k][n], want[k][n], atol=1e-6,
                                       rtol=1e-5, err_msg=f"{k}/{n}")


# ---------------------------------------------------------------------
# the recurrent graph anchor
# ---------------------------------------------------------------------
def _anchor_graph():
    conf = (NeuralNetConfiguration.Builder()
            .seed(202)
            .updater(Nesterovs(0.01, momentum=0.9))
            .graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.recurrent(5, 7))
            .add_layer("lstm", tl.GravesLSTM(n_out=6, activation="tanh"),
                       "in")
            .add_layer("lstm2", tl.LSTM(n_out=6, activation="tanh"), "in")
            .add_vertex("add", ElementWiseVertex(op="add"), "lstm", "lstm2")
            .add_vertex("mrg", MergeVertex(), "add", "lstm")
            .add_layer("out", tl.RnnOutputLayer(n_out=4, loss="mcxent",
                                                activation="softmax"), "mrg")
            .set_outputs("out")
            .build())
    return ComputationGraph(conf).init(device="cpu")


def test_regression_cg_anchor_reproduced_and_streams():
    jnet = restore_computation_graph(os.path.join(FIX,
                                                  "regression_cg_v1.zip"))
    x = np.load(os.path.join(FIX, "regression_cg_v1_input.npy"))
    expected = np.load(os.path.join(FIX, "regression_cg_v1_output.npy"))
    net = _anchor_graph().load_numpy_params(_np_tree(jnet.params))
    got = net.output(x).numpy()
    assert got.shape == expected.shape == (3, 4, 7)
    np.testing.assert_allclose(got, expected, atol=OUT_ATOL)
    np.testing.assert_allclose(got, expected, atol=1e-6)   # as read
    jnet.rnn_clear_previous_state()
    net.rnn_clear_previous_state()
    cols = []
    for a, b in ((0, 3), (3, 4), (4, 7)):
        want = jnet.rnn_time_step(x[:, :, a:b])
        want = np.asarray(want[0] if isinstance(want, list) else want)
        cols.append(net.rnn_time_step(x[:, :, a:b]))
        np.testing.assert_allclose(cols[-1].numpy(), want, atol=1e-6)
    assert set(net.state["lstm"]) == {"h", "c"} == set(net.state["lstm2"])
    np.testing.assert_allclose(torch.cat(cols, dim=2).numpy(), got,
                               atol=1e-6)
    net.rnn_clear_previous_state()
    assert net.state["lstm"] == {} and net.state["lstm2"] == {}


# ---------------------------------------------------------------------
# devices and refusals
# ---------------------------------------------------------------------
def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextGenerationLSTM(vocab_size=V, hidden=H).init()
    model = TextGenerationLSTM(vocab_size=V, hidden=H)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(model.conf()).init()


def test_left_out_parts_raise(nets):
    jnet, tnet = nets
    model = TextGenerationLSTM(vocab_size=V, hidden=H)
    # the engine serves the LSTM now (tests/test_torch_serving_ledger.py);
    # batched decoding primes under a carried mask (masked streaming)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        model.sample_stream_batch(tnet, [[1]], 2)
    # beam search is ported: the JAX package's result
    # (tests/test_torch_beam_search.py holds it at more cases)
    seq, score = model.beam_search(tnet, [1], 2)
    jseq, jscore = JaxLSTM(vocab_size=V, hidden=H).beam_search(jnet, [1], 2)
    assert seq == jseq and abs(score - jscore) <= 1e-4
    x, y = _batch()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        tnet.fit(DataSet(x, y, features_mask=np.ones((3, 12), np.float32)))
    # K-step dispatch is ported: a tBPTT batch always runs by itself (the
    # JAX _fit_epoch), so K = 2 trains as K = 1 does, loss for loss
    losses = {}
    for k in (1, 2):
        net = MultiLayerNetwork(TextGenerationLSTM(
            vocab_size=V, hidden=H, max_length=MAXLEN).conf()
        ).init(device="cpu")
        net.set_listeners(CollectScoresIterationListener())
        net.fit(np.concatenate([x, x]), np.concatenate([y, y]),
                batch_size=3, steps_per_dispatch=k)
        losses[k] = net.listeners[0].scores
        assert net.fit_dispatch["batch_steps"] == 6
    assert losses[1] == losses[2] and len(losses[1]) == 6
    # evaluation is ported (tests/test_torch_eval.py): every position of
    # the [N, V, T] labels counts
    ev = tnet.evaluate(DataSet(x, y))
    assert ev.confusion.matrix.sum() == x.shape[0] * x.shape[2]
    # layer-wise pretraining trains AutoEncoder / VAE layers (A11)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        tnet.pretrain(DataSet(x, y))
    with pytest.raises(ValueError, match="ComputationGraph"):
        TextGenerationLSTM(vocab_size=V, fuse=True).init(device="cpu")
