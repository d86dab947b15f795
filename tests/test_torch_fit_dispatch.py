"""The port's fit loop against the JAX package's (nn/network_base.py;
the JAX ``nn/multilayer.py`` / ``nn/graph.py`` ``fit``, ``_fit_epoch``,
``_fit_group``), on the CPU, where a K-step group runs its steps one
after another (on the card it is one CUDA graph; ``chip_smoke.py``'s
``fit_graph_*`` phases hold it there).

- ``fit(steps_per_dispatch=3, pad_tail=True)`` over 7 batches with a
  ragged last one (two groups, then the padded tail per batch) on the
  2-layer width-16 transformer and on a small MLP: each step's loss
  within the training tests' f32 ``rtol 1e-5`` of the JAX scan fit's,
  the parameters within ``atol 1e-5``, and the port's dispatch counts;
- listener call sequences equal to the JAX package's: epoch hooks with
  the index before the increment, ``record_batch`` with the real rows of
  a padded tail, iteration indices, two epochs;
- a NaN batch inside a group: the sentinel's counts and the registry's
  ``dl4jtpu_bad_steps_total`` / ``_skipped_updates_total`` as JAX's, the
  skipped step leaving the parameters bit-equal;
- a BN graph (conv -> BN -> pool) with K=3 and a padded tail, BN running
  statistics and parameters against JAX's (padding under BN is the JAX
  approximation, mirrored);
- on the port alone: a K-step group equals K eager steps bit for bit
  (the graph's device select changes nothing on a good step), for a
  drawing network too (dropout and weight noise draw what K eager steps
  draw); ``prefetch=2`` changes no loss bit; ``set_phase_detail`` opens
  the forward / backward / update spans; the default telemetry and
  ``MetricsListener`` count what JAX's count; the step graph's keys.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitoring import metrics as jmetrics
from deeplearning4j_tpu.monitoring.listener import (
    MetricsListener as JMetricsListener)
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JCollect)
from deeplearning4j_tpu.optimize.listeners import (
    TrainingListener as JListener)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.monitoring import metrics as tmetrics
from deeplearning4j_tpu_torch.monitoring import set_phase_detail
from deeplearning4j_tpu_torch.monitoring.listener import MetricsListener
from deeplearning4j_tpu_torch.nn import network_base
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.pipeline import DevicePrefetchIterator
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy)
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, T = 16, 16, 2, 8
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5     # the training tests' f32 limits
K, BATCHES, B = 3, 7, 2                 # two groups, then the padded tail


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}": v for k, sub in tree.items()
                for kk, v in _flat(sub).items()}
    return {"": np.asarray(tree)}


def _assert_trees_close(got, want, atol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _ragged(x, y):
    """The arrays cut to BATCHES batches of B rows, the last one row
    short (a ragged tail)."""
    n = B * BATCHES - 1
    return x[:n], y[:n]


# rope positions: under learned ones the key biases' exact gradient is
# zero and Adam scales each side's round-off up to a step of lr
# (tests/test_torch_training.py)
TFM = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=2,
           max_length=T, block_size=8, positional="rope")


def _tfm():
    return TextGenerationTransformer(updater=Adam(3e-3), **TFM).init(
        device="cpu")


def _tfm_pair():
    jnet = JaxTFM(updater=JAdam(3e-3), **TFM).init()
    tnet = _tfm()
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _tfm_data(seed=0):
    ids = np.random.default_rng(seed).integers(0, V, (B * BATCHES, T))
    x = np.zeros((B * BATCHES, V, T), np.float32)
    x[np.arange(B * BATCHES)[:, None], ids, np.arange(T)[None, :]] = 1.0
    return _ragged(x, np.roll(x, -1, axis=2))


def _mlp_pair(seed=3):
    layers = [jl.DenseLayer(n_out=8, activation="tanh"),
              jl.DenseLayer(n_out=8, activation="relu"),
              jl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    jconf = JMLConf(layers=layers, input_type=JIT.feed_forward(6),
                    seed=seed, updater=JAdam(2e-2))
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jconf.to_dict()))).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _mlp(seed=3):
    layers = [tl.DenseLayer(n_out=8, activation="tanh"),
              tl.DenseLayer(n_out=8, activation="relu"),
              tl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(6), seed=seed,
        updater=Adam(2e-2))).init(device="cpu")


def _mlp_data(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * BATCHES, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B * BATCHES)]
    return _ragged(x, y)


def _bn_pair():
    """A 1x1 conv -> BN (relu) -> average pool -> softmax graph with
    Adam from both packages' builders, the JAX parameters and BN
    statistics loaded into the port's."""
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

    jnet = JGraph(build(JNNC, jl, JIT, JAdam(1e-2))).init()
    tnet = ComputationGraph(build(NeuralNetConfiguration, tl, InputType,
                                  Adam(1e-2))).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    tnet.load_numpy_state(jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet


def _bn_data(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * BATCHES, 4, 6, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, B * BATCHES)]
    return _ragged(x, y)


PAIRS = {"transformer": (_tfm_pair, _tfm_data),
         "mlp": (_mlp_pair, _mlp_data), "bn_graph": (_bn_pair, _bn_data)}
PORT = {"transformer": _tfm, "bn_graph": lambda: _bn_pair()[1]}


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            self.calls = []

        def on_epoch_start(self, model, epoch):
            self.calls.append(("epoch_start", epoch))

        def on_epoch_end(self, model, epoch):
            self.calls.append(("epoch_end", epoch))

        def record_batch(self, n):
            self.calls.append(("record_batch", n))

        def iteration_done(self, model, iteration, score):
            self.calls.append(("iteration", iteration))
    return Recorder()


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_k_step_fit_matches_the_jax_scan_fit(name):
    make, data = PAIRS[name]
    jnet, tnet = make()
    x, y = data()
    jl_, tl_ = JCollect(), CollectScoresIterationListener()
    jrec, trec = _recorder(JListener), _recorder(TrainingListener)
    jnet.set_listeners(jl_, jrec)
    tnet.set_listeners(tl_, trec)
    for _ in range(2):
        jnet.fit(x, y, batch_size=B, steps_per_dispatch=K, pad_tail=True)
        tnet.fit(x, y, batch_size=B, steps_per_dispatch=K, pad_tail=True)
    assert [i for i, _ in tl_.scores] == [i for i, _ in jl_.scores] \
        == list(range(2 * BATCHES))
    np.testing.assert_allclose([s for _, s in tl_.scores],
                               [s for _, s in jl_.scores], rtol=LOSS_RTOL)
    _assert_trees_close(params_to_numpy(tnet.params),
                        jax.tree_util.tree_map(np.asarray, jnet.params),
                        PARAM_ATOL)
    if name == "bn_graph":
        _assert_trees_close(state_to_numpy(tnet.state),
                            jax.tree_util.tree_map(np.asarray, jnet.state),
                            PARAM_ATOL)
    # the listener sequence, the padded tail reporting its one real row
    assert trec.calls == jrec.calls
    assert ("record_batch", B - 1) in trec.calls
    assert tnet.fit_dispatch == {"eager_group_steps": 2 * 2 * K,
                                 "batch_steps": 2}
    assert tnet.iteration_count == jnet.iteration_count == 2 * BATCHES
    assert tnet.epoch_count == jnet.epoch_count == 2


def _bad_steps(registry_module):
    r = registry_module.global_registry()
    return {name: 0.0 if r.get(name) is None else r.get(name).total()
            for name in ("dl4jtpu_bad_steps_total",
                         "dl4jtpu_skipped_updates_total")}


def test_a_nan_batch_inside_a_group_as_in_jax():
    jnet, tnet = _mlp_pair()
    x, y = _mlp_data()
    x = x[:B * K].copy()
    y = y[:B * K]
    x[B + 1, 2] = np.nan           # the second step of the one group
    jb, tb = _bad_steps(jmetrics), _bad_steps(tmetrics)
    jl_, tl_ = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jl_)
    tnet.set_listeners(tl_)
    before = params_to_numpy(tnet.params)
    trees = []

    class Snap(TrainingListener):
        def iteration_done(self, model, iteration, score):
            trees.append(params_to_numpy(model.params))
    # the group hands its listeners the params after all K steps; the
    # per-step effect is read from the losses and the counts
    tnet.add_listener(Snap())
    jnet.fit(x, y, batch_size=B, steps_per_dispatch=K)
    tnet.fit(x, y, batch_size=B, steps_per_dispatch=K)
    tloss = [s for _, s in tl_.scores]
    assert np.isnan(tloss[1]) and np.isnan([s for _, s in jl_.scores][1])
    np.testing.assert_allclose(np.asarray(tloss)[[0, 2]],
                               np.asarray([s for _, s in jl_.scores])[[0, 2]],
                               rtol=LOSS_RTOL)
    acct, jacct = tnet._sentinel_accounting, jnet._sentinel_accounting
    assert (acct.total_steps, acct.bad_steps, acct.skipped_updates,
            acct.consecutive_bad) == (jacct.total_steps, jacct.bad_steps,
                                      jacct.skipped_updates,
                                      jacct.consecutive_bad) == (3, 1, 1, 0)
    ja, ta = _bad_steps(jmetrics), _bad_steps(tmetrics)
    assert {k: ta[k] - tb[k] for k in ta} == {k: ja[k] - jb[k] for k in ja} \
        == {"dl4jtpu_bad_steps_total": 1, "dl4jtpu_skipped_updates_total": 1}
    _assert_trees_close(params_to_numpy(tnet.params),
                        jax.tree_util.tree_map(np.asarray, jnet.params),
                        PARAM_ATOL)
    # the skip is exact: the steps around the NaN one, run as K = 1
    # steps on a fresh net without it, give the group's parameters
    ref = _mlp()
    ref.load_numpy_params(before)
    ref.fit(np.concatenate([x[:B], x[2 * B:]]),
            np.concatenate([y[:B], y[2 * B:]]), batch_size=B)
    _assert_trees_close(params_to_numpy(tnet.params),
                        params_to_numpy(ref.params), 0)


def _drop_mlp(seed=7):
    layers = [tl.DenseLayer(n_in=6, n_out=8, activation="tanh",
                            dropout=tdrop.Dropout(0.9)),
              tl.DenseLayer(n_out=8, activation="tanh",
                            weight_noise=tdrop.WeightNoise(stddev=0.05)),
              tl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(6),
        seed=seed)).init(device="cpu")


@pytest.mark.parametrize("make", ["transformer", "bn_graph", "drawing_mlp"])
def test_a_group_is_its_k_eager_steps_bit_for_bit(make):
    if make == "drawing_mlp":
        nets = [_drop_mlp(), _drop_mlp()]
        x, y = _mlp_data()
    else:
        nets = [PORT[make]() for _ in range(2)]
        x, y = PAIRS[make][1]()
    losses = []
    for net, k in zip(nets, (1, K)):
        lst = CollectScoresIterationListener()
        net.set_listeners(lst)
        net.fit(x, y, batch_size=B, steps_per_dispatch=k, pad_tail=True)
        losses.append([s for _, s in lst.scores])
    assert losses[0] == losses[1]
    _assert_trees_close(params_to_numpy(nets[1].params),
                        params_to_numpy(nets[0].params), 0)
    _assert_trees_close(state_to_numpy(nets[1].state),
                        state_to_numpy(nets[0].state), 0)
    assert nets[0]._train_gen.initial_seed() == \
        nets[1]._train_gen.initial_seed()
    assert torch.equal(nets[0]._train_gen.get_state(),
                       nets[1]._train_gen.get_state())


@pytest.mark.parametrize("k", [1, K])
@pytest.mark.parametrize("make", ["mlp", "bn_graph"])
def test_prefetch_changes_no_loss_bit(make, k):
    got = []
    for prefetch in (0, 2):
        net = _mlp() if make == "mlp" else PORT[make]()
        lst = CollectScoresIterationListener()
        net.set_listeners(lst)
        net.fit(*PAIRS[make][1](), batch_size=B, steps_per_dispatch=k,
                prefetch=prefetch)
        got.append(([s for _, s in lst.scores],
                    params_to_numpy(net.params)))
    assert got[0][0] == got[1][0]
    _assert_trees_close(got[1][1], got[0][1], 0)


def test_prefetch_pads_in_the_worker_as_jax_does():
    """The graph's prefetch stage pads the ragged tail before the
    transfer (the JAX ``pad_when``); the fit then sees a full batch with
    its example weights, as without prefetch."""
    a, b = _mlp(), _mlp()
    x, y = _mlp_data()
    rec_a, rec_b = _recorder(TrainingListener), _recorder(TrainingListener)
    a.set_listeners(rec_a)
    b.set_listeners(rec_b)
    a.fit(x, y, batch_size=B, steps_per_dispatch=K)
    b.fit(x, y, batch_size=B, steps_per_dispatch=K, prefetch=2)
    assert rec_a.calls == rec_b.calls
    _assert_trees_close(params_to_numpy(b.params), params_to_numpy(a.params),
                        0)


def test_phase_detail_opens_the_step_phases():
    r = tmetrics.global_registry()

    def counts():
        h = r.get("dl4jtpu_span_seconds")
        return {s: h.count(span=s) for s in ("forward", "backward",
                                             "update", "step")}
    net = _mlp()
    x, y = _mlp_data()
    net.fit(x[:2 * B], y[:2 * B], batch_size=B)
    c0 = counts()
    set_phase_detail(True)
    try:
        net.fit(x[:2 * B], y[:2 * B], batch_size=B)
    finally:
        set_phase_detail(False)
    c1 = counts()
    assert {s: c1[s] - c0[s] for s in c0} == {
        "forward": 2, "backward": 2, "update": 2, "step": 0}


def _model_series(registry, model):
    names = ("dl4jtpu_iterations_total", "dl4jtpu_examples_total",
             "dl4jtpu_epochs_total")
    out = {}
    for n in names:
        m = registry.get(n)
        out[n] = 0.0 if m is None or (model,) not in m._children \
            else m.value(model=model)
    return out


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["default_hook", "metrics_listener"])
def test_fit_telemetry_counts_as_jax_does(explicit):
    jnet, tnet = _mlp_pair()
    x, y = _mlp_data()
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    if explicit:
        jnet.set_listeners(JMetricsListener(jr))
        tnet.set_listeners(MetricsListener(tr))
    else:
        jr, tr = jmetrics.global_registry(), tmetrics.global_registry()
    j0 = _model_series(jr, "MultiLayerNetwork")
    t0 = _model_series(tr, "MultiLayerNetwork")
    jnet.fit(x, y, batch_size=B, steps_per_dispatch=K)
    tnet.fit(x, y, batch_size=B, steps_per_dispatch=K)
    j1 = _model_series(jr, "MultiLayerNetwork")
    t1 = _model_series(tr, "MultiLayerNetwork")
    assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}
    assert t1["dl4jtpu_iterations_total"] - \
        t0["dl4jtpu_iterations_total"] == BATCHES
    # the score gauge ends on the last step's loss
    np.testing.assert_allclose(
        tr.get("dl4jtpu_score").value(model="MultiLayerNetwork"),
        tnet.score_value, rtol=0)


def test_the_step_graph_key_follows_shapes_dtypes_and_trees():
    a = network_base._batch_key(network_base.DataSet(
        np.zeros((2, 3), np.float64), np.zeros((2, 4), np.float32)))
    b = network_base._batch_key(network_base.DataSet(
        torch.zeros(2, 3), torch.zeros(2, 4)))
    c = network_base._batch_key(network_base.DataSet(
        torch.zeros(3, 3), torch.zeros(3, 4)))
    assert a == b != c
    net = _mlp()
    k0 = network_base._trees_key(net)
    net.fit(*_mlp_data(), batch_size=B)
    assert network_base._trees_key(net) == k0
    net.params["0"]["W"] = net.params["0"]["W"].double()
    assert network_base._trees_key(net) != k0
    net.params["0"]["W"] = net.params["0"]["W"].float()
    # a loader drops the graph: the next group warms and captures anew
    for load, tree in ((net.load_numpy_params, params_to_numpy(net.params)),
                       (net.load_numpy_state, state_to_numpy(net.state))):
        net._step_graph = object()
        load(tree)
        assert net._step_graph is None


def test_a_replay_drops_the_bf16_copy_of_the_parameters():
    """A replay writes the parameters in place (the same tensors every
    replay), so ``output()`` after it must not reuse the bf16 copy made
    before it: checked through ``_StepGraph.replay`` with a stand-in for
    the CUDA graph that writes new values into the trees in place."""
    net = _mlp()
    net.conf.dtype = "bfloat16"
    x = _mlp_data()[0][:B]
    stale = np.asarray(net.output(x))
    new = network_base.tree_map(lambda t: t + 0.25, net.params)

    class InPlace:
        def replay(self):
            network_base._tree_copy((net.params,), (new,))

    sg = object.__new__(network_base._StepGraph)
    sg.graph = InPlace()
    sg.replay(net)
    fresh = _mlp()
    fresh.conf.dtype = "bfloat16"
    fresh.params = new
    got, want = np.asarray(net.output(x)), np.asarray(fresh.output(x))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, stale)


def test_prefetch_gives_every_batch_its_example_weights():
    """Under padding the prefetch worker attaches each full batch's
    all-ones example-weight mask (the ragged tail's comes with its
    padding), so the mask crosses with the batch and the fit adds no
    host array of its own."""
    net = _mlp()
    seen = []
    real = net._fit_group

    def record(group):
        seen.extend(type(b.labels_mask) for b in group)
        return real(group)
    net._fit_group = record
    net.fit(*_mlp_data(), batch_size=B, steps_per_dispatch=K, prefetch=2)
    assert seen == [torch.Tensor] * (2 * K)


def test_the_card_refuses_what_its_graph_cannot_hold(monkeypatch):
    """A prefetch stage that would place batches on a device mesh is
    refused, naming ROADMAP.md A9 (a drawing network is no longer
    refused: its graph draws what K eager steps draw, below)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        DevicePrefetchIterator(iter([]), data_axis="data")


class _Philox:
    """A stand-in for a CUDA generator: a seed and a Philox offset."""

    device = torch.device("cuda")

    def __init__(self, device=None):
        self.seed = self.offset = 0

    def manual_seed(self, seed):
        self.seed, self.offset = int(seed), 0
        return self

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        self.offset = int(offset)


class _Graph:
    """A stand-in for a CUDA graph: the generators registered with it."""

    def __init__(self):
        self.registered = []

    def register_generator_state(self, gen):
        self.registered.append(gen)


def _card_net(monkeypatch, seed=1234):
    """The drawing MLP with a stand-in CUDA training generator, torch's
    generators replaced by stand-ins for the test."""
    net = _drop_mlp()
    net._train_gen = _Philox().manual_seed(seed)
    monkeypatch.setattr(torch, "Generator", _Philox)
    return net


def test_a_replay_draws_where_k_eager_steps_draw(monkeypatch):
    """The card's path for a drawing network: the step graph holds one
    generator a (step, drawing layer), registered with the graph before
    its capture, and before each replay sets each to the seed and
    Philox offset its eager twin (``_step_gens``) takes, advancing the
    training generator as K eager steps do; a replay moves the
    generators on by their draws, and the next replay sets them again.
    Checked over two replays with stand-ins for the generators and the
    graph (nothing here needs the card)."""
    net = _card_net(monkeypatch)
    want = [{key: (g.initial_seed(), g.get_offset())
             for key, g in net._step_gens().items()} for _ in range(2 * K)]
    end = net._train_gen.get_offset()
    assert all(len(w) == 2 for w in want)   # dropout and weight noise
    net._train_gen = _Philox().manual_seed(1234)
    sg = object.__new__(network_base._StepGraph)
    sg.slots = [None] * K
    graph = _Graph()
    sg.make_gens(net, graph)
    assert len(graph.registered) == 2 * K
    assert sorted(map(id, graph.registered)) == sorted(
        id(g) for gens in sg.gens for g in gens.values())
    got = []
    for _ in range(2):
        sg.draw(net)
        got += [{key: (g.initial_seed(), g.get_offset())
                 for key, g in gens.items()} for gens in sg.gens]
        for g in graph.registered:      # the replay's own draws
            g.set_offset(g.get_offset() + 4 * 1000)
    assert got == want
    assert net._train_gen.get_offset() == end


def test_a_new_learning_rate_takes_a_new_step_graph():
    """A step takes the learning rate as a Python number, so a graph
    bakes it in: the graph's key holds the updater's hyperparameters,
    and a new rate (``lr_backoff``, a restored checkpoint's rate) makes
    the next group warm and capture anew."""
    net = _drop_mlp()
    x, y = _mlp_data()
    group = [network_base.DataSet(x[:B], y[:B])] * K
    key = net._step_graph_key(group, "skip")
    assert net._step_graph_key(group, "skip") == key
    net.conf.updater.learning_rate *= 0.5
    assert net._step_graph_key(group, "skip") != key


def test_a_drawing_lstm_group_is_its_k_eager_steps():
    """The regularized text LSTM without tBPTT (dropout on each LSTM's
    input, DropConnect on the second's weights, a max-norm constraint,
    AdaMax) at a small size: a K-step group's steps draw, step and
    project as K eager steps do, bit for bit (the losses, parameters and
    updater state); a group keeps no streaming carry in the state, as
    the JAX scan's carry keeps none."""
    from deeplearning4j_tpu_torch.nn.conf.constraints import (
        MaxNormConstraint)
    from deeplearning4j_tpu_torch.nn.updater import AdaMax

    def make():
        b = (NeuralNetConfiguration.Builder().seed(5).updater(AdaMax(2e-3))
             .weight_init("xavier_uniform").list())
        for i in range(2):
            b.layer(tl.GravesLSTM(
                n_out=8, activation="tanh", dropout=tdrop.Dropout(0.9),
                weight_noise=tdrop.DropConnect(0.95) if i else None,
                constraints=[MaxNormConstraint(max_norm=0.75)]))
        b.layer(tl.RnnOutputLayer(n_out=V, loss="mcxent",
                                  activation="softmax"))
        conf = b.set_input_type(InputType.recurrent(V, T)).build()
        return MultiLayerNetwork(conf).init(device="cpu")

    x, y = (a[:2 * K * B] for a in _tfm_data())     # two whole groups
    nets, losses = [make(), make()], []
    for net, k in zip(nets, (1, K)):
        lst = CollectScoresIterationListener()
        net.set_listeners(lst)
        net.fit(x, y, batch_size=B, steps_per_dispatch=k, pad_tail=True)
        losses.append([s for _, s in lst.scores])
    assert losses[0] == losses[1]
    _assert_trees_close(params_to_numpy(nets[1].params),
                        params_to_numpy(nets[0].params), 0)
    _assert_trees_close(
        network_base.tree_map(np.asarray, nets[1].updater_state),
        network_base.tree_map(np.asarray, nets[0].updater_state), 0)
    assert not any(k in s for s in nets[1].state.values()
                   for k in network_base.STREAM_STATE_KEYS)


@pytest.mark.parametrize("enabled", [True, False])
def test_the_capture_pauses_the_collector(enabled):
    """The K-step graph's capture runs inside ``_collector_paused``: the
    collector is off inside and its state is restored after, also when
    the block raises. On the card a collection inside a capture that
    frees a dead network's step graph invalidates the capture
    (``chip_smoke.py``'s ``capture_gc`` holds that)."""
    import gc

    (gc.enable if enabled else gc.disable)()
    try:
        with network_base._collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
        with pytest.raises(RuntimeError):
            with network_base._collector_paused():
                raise RuntimeError("capture failed")
        assert gc.isenabled() is enabled
    finally:
        gc.enable()
