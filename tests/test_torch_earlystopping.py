"""The port's early stopping (deeplearning4j_tpu_torch/earlystopping/) and
``EvaluativeListener`` against the JAX package on the CPU.

- ``EarlyStoppingTrainer`` on a small f32 MLP holding the JAX net's
  weights, one case per termination condition (max epochs, score
  improvement, max score, an invalid score from a NaN batch, max time),
  with both score calculators and both savers: the JAX termination
  reason, details, total epochs and best epoch, and each epoch's score
  within ``SCORE_RTOL`` (two f32 trainings summing in different orders).
- ``copy_model``: the best copy shares no tensor with the source; its
  ``output()`` stays bitwise after the source trains two more steps and
  after the source's parameters are rewritten in place (as a step
  graph's replay does); it has no step graph, no cached weights and a
  generator of its own at the source's state. ``LocalFileModelSaver``'s
  restored best model gives the output recorded at its save, bitwise.
- ``EvaluativeListener`` fires at the JAX iterations (every 2 steps,
  eager and with ``steps_per_dispatch=3``; per epoch), each evaluation's
  confusion matrix equal to the JAX one, and it changes nothing the fit
  computes: a drawing net's losses and a BN graph's parameters and
  running statistics are bitwise those of the fit without it.
- A step graph's replay drops the graph's kernel-layout weights along
  with the compute-dtype copy (an evaluation between two replays would
  otherwise read the first replay's weights in a layout it cached).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.datasets.iterators import (
    ArrayDataSetIterator as JIter)
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.optimize.listeners import (
    EvaluativeListener as JEvaluative)
from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.earlystopping.core import copy_model
from deeplearning4j_tpu_torch.nn import network_base
from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresIterationListener, EvaluativeListener)
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy)
from deeplearning4j_tpu_torch.zoo import ResNet50

from test_torch_fit_dispatch import _assert_trees_close, _bn_pair
from torch_threads import one_thread  # noqa: F401 (autouse)

#: two f32 trainings of a few Adam steps, summing in different orders
SCORE_RTOL = 1e-5
B = 8


def _pair(lr=2e-2):
    layers = [jl.DenseLayer(n_out=12, activation="tanh"),
              jl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")]
    jconf = JMLConf(layers=layers, input_type=JIT.feed_forward(5), seed=2,
                    updater=JAdam(lr))
    jnet = JMLN(jconf).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jconf.to_dict()))).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _data(n=32, seed=1, nan_batch=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int)
                                    + (x[:, 1] > 0.5)]
    if nan_batch is not None:
        x[nan_batch * B:(nan_batch + 1) * B] = np.nan
    return x, y


def _iters(x, y):
    return ArrayDataSetIterator(x, y, B), JIter(x, y, B)


CONDITIONS = {
    "max_epochs": dict(epoch=lambda m: [m.MaxEpochsTerminationCondition(3)],
                       calc="loss"),
    "score_improvement": dict(
        epoch=lambda m: [m.ScoreImprovementEpochTerminationCondition(1),
                         m.MaxEpochsTerminationCondition(12)],
        calc="classification", lr=0.5),
    "max_score": dict(
        epoch=lambda m: [m.MaxEpochsTerminationCondition(4)],
        iteration=lambda m: [m.MaxScoreTerminationCondition(0.9)],
        calc="loss"),
    "invalid_score": dict(
        epoch=lambda m: [m.MaxEpochsTerminationCondition(4)],
        iteration=lambda m: [m.InvalidScoreTerminationCondition()],
        calc="loss", nan_batch=2),
    "max_time": dict(
        epoch=lambda m: [m.MaxEpochsTerminationCondition(4)],
        iteration=lambda m: [m.MaxTimeTerminationCondition(0.0)],
        calc="none"),
}


def _run(m, net, case, train, valid, saver):
    spec = CONDITIONS[case]
    calc = {"loss": lambda: m.DataSetLossCalculator(valid),
            "classification": lambda: m.ClassificationScoreCalculator(
                valid),
            "none": lambda: None}[spec["calc"]]()
    cfg = m.EarlyStoppingConfiguration(
        epoch_termination_conditions=spec["epoch"](m),
        iteration_termination_conditions=spec.get(
            "iteration", lambda _: [])(m),
        score_calculator=calc, model_saver=saver, save_last_model=True)
    return m.EarlyStoppingTrainer(cfg, net, train).fit()


@pytest.mark.parametrize("saver", ["memory", "file"])
@pytest.mark.parametrize("case", sorted(CONDITIONS))
def test_the_trainer_stops_where_the_jax_trainer_stops(case, saver,
                                                       tmp_path):
    spec = CONDITIONS[case]
    jnet, tnet = _pair(spec.get("lr", 2e-2))
    x, y = _data(nan_batch=spec.get("nan_batch"))
    vx, vy = _data(24, seed=5)
    tv, jv = _iters(vx, vy)
    tt, jt = _iters(x, y)
    if saver == "memory":
        savers = tes.InMemoryModelSaver(), jes.InMemoryModelSaver()
    else:
        savers = (tes.LocalFileModelSaver(str(tmp_path / "t"), device="cpu"),
                  jes.LocalFileModelSaver(str(tmp_path / "j")))
    got = _run(tes, tnet, case, tt, tv, savers[0])
    want = _run(jes, jnet, case, jt, jv, savers[1])
    assert (got.termination_reason, got.termination_details,
            got.total_epochs, got.best_model_epoch) == \
        (want.termination_reason, want.termination_details,
         want.total_epochs, want.best_model_epoch)
    assert got.score_vs_epoch.keys() == want.score_vs_epoch.keys()
    np.testing.assert_allclose(list(got.score_vs_epoch.values()),
                               list(want.score_vs_epoch.values()),
                               rtol=SCORE_RTOL)
    if want.best_model is not None:
        assert isinstance(got.best_model, MultiLayerNetwork)
        np.testing.assert_allclose(
            np.asarray(got.best_model.output(vx)),
            np.asarray(want.best_model.output(vx)), rtol=0, atol=1e-5)


class _Recording(tes.LocalFileModelSaver):
    """A file saver that records the best model's output at each save."""

    def __init__(self, directory, probe):
        super().__init__(directory, device="cpu")
        self.probe, self.at_save = probe, None

    def save_best(self, model, score):
        super().save_best(model, score)
        self.at_save = model.output(self.probe).numpy()


def test_the_restored_best_model_gives_its_output_at_the_save(tmp_path):
    _, tnet = _pair()
    x, y = _data()
    saver = _Recording(str(tmp_path), _data(16, seed=6)[0])
    cfg = tes.EarlyStoppingConfiguration(
        epoch_termination_conditions=[tes.MaxEpochsTerminationCondition(3)],
        score_calculator=tes.ClassificationScoreCalculator(
            ArrayDataSetIterator(*_data(24, seed=5), B)),
        model_saver=saver)
    res = tes.EarlyStoppingTrainer(cfg, tnet, ArrayDataSetIterator(
        x, y, B)).fit()
    np.testing.assert_array_equal(
        res.best_model.output(saver.probe).numpy(), saver.at_save)
    assert res.total_epochs == 3


def test_copy_model_shares_nothing_the_source_changes():
    _, net = _pair()
    x, y = _data()
    net.fit(x, y, batch_size=B)
    probe = _data(16, seed=6)[0]
    best = copy_model(net)
    at_copy = best.output(probe).numpy()
    src = [t for tree in (net.params, net.updater_state, net.state)
           for t in network_base.tree_leaves(tree) if torch.is_tensor(t)]
    dst = [t for tree in (best.params, best.updater_state, best.state)
           for t in network_base.tree_leaves(tree) if torch.is_tensor(t)]
    assert len(src) == len(dst) and not {t.data_ptr() for t in src} & {
        t.data_ptr() for t in dst}
    assert best._step_graph is None and best._compute is None
    assert best._train_gen is not net._train_gen
    assert torch.equal(best._train_gen.get_state(),
                       net._train_gen.get_state())
    assert best.listeners is not net.listeners
    # the source trains on, then is rewritten in place (a replay)
    net.fit(x[:2 * B], y[:2 * B], batch_size=B)
    network_base._tree_copy((net.params,), (network_base.tree_map(
        lambda t: t + 1.0, net.params),))
    np.testing.assert_array_equal(best.output(probe).numpy(), at_copy)
    assert not np.array_equal(net.output(probe).numpy(), at_copy)
    torch.randint(0, 9, (4,), generator=net._train_gen)
    assert not torch.equal(best._train_gen.get_state(),
                           net._train_gen.get_state())


# ---------------------------------------------------------------------
# EvaluativeListener
# ---------------------------------------------------------------------
class _At:
    """Records the iteration of each evaluation an EvaluativeListener
    makes (its ``_eval`` wrapped)."""

    def __init__(self, listener):
        self.listener, self.at, self.now = listener, [], None
        real = listener._eval

        def record(model):
            self.at.append(self.now)
            real(model)
        listener._eval = record

    def iteration_done(self, model, iteration, score):
        self.now = ("it", iteration)
        self.listener.iteration_done(model, iteration, score)

    def on_epoch_end(self, model, epoch):
        self.now = ("epoch", epoch)
        self.listener.on_epoch_end(model, epoch)

    def __getattr__(self, name):
        return getattr(self.listener, name)


@pytest.mark.parametrize("k,on_epoch,freq", [
    (1, False, 2), (3, False, 2), (3, True, 1)],
    ids=["eager", "k3", "per_epoch"])
def test_the_evaluative_listener_fires_at_the_jax_iterations(k, on_epoch,
                                                            freq):
    jnet, tnet = _pair()
    x, y = _data(48)
    vx, vy = _data(24, seed=5)
    tv, jv = _iters(vx, vy)
    got = _At(EvaluativeListener(tv, frequency=freq, on_epoch=on_epoch))
    want = _At(JEvaluative(jv, frequency=freq, on_epoch=on_epoch))
    tnet.set_listeners(got)
    jnet.set_listeners(want)
    tnet.fit(x, y, epochs=2, batch_size=B, steps_per_dispatch=k)
    jnet.fit(x, y, epochs=2, batch_size=B, steps_per_dispatch=k)
    assert got.at == want.at and len(got.at) >= 2
    for a, b in zip(got.evaluations, want.evaluations):
        np.testing.assert_array_equal(a.confusion.matrix,
                                      b.confusion.matrix)


def _drawing():
    layers = [tl.DenseLayer(n_out=12, activation="tanh",
                            dropout=tdrop.Dropout(0.8)),
              tl.OutputLayer(n_out=3, loss="mcxent", activation="softmax",
                             dropout=0.9)]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(5), seed=4,
        updater=Adam(1e-2))).init(device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_an_evaluation_between_steps_changes_nothing_the_fit_computes(k):
    x, y = _data(48)
    v = ArrayDataSetIterator(*_data(24, seed=5), B)
    losses, params = [], []
    for with_eval in (False, True):
        net = _drawing()
        scores = CollectScoresIterationListener()
        lst = [scores] + ([EvaluativeListener(v, frequency=2)]
                          if with_eval else [])
        net.set_listeners(*lst)
        net.fit(x, y, batch_size=B, steps_per_dispatch=k)
        losses.append([s for _, s in scores.scores])
        params.append(params_to_numpy(net.params))
        if with_eval:
            assert len(net.listeners[1].evaluations) == 2
    assert losses[0] == losses[1]
    _assert_trees_close(params[1], params[0], 0)
    # BN's running statistics: an evaluation reads them, never writes
    trees = []
    for with_eval in (False, True):
        tnet = _bn_pair()[1]
        rng = np.random.default_rng(2)
        bx = rng.standard_normal((12, 4, 6, 6)).astype(np.float32)
        by = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
        if with_eval:
            tnet.set_listeners(EvaluativeListener(
                ArrayDataSetIterator(bx, by, 4), frequency=1))
        tnet.fit(bx, by, batch_size=2, steps_per_dispatch=k)
        trees.append((params_to_numpy(tnet.params),
                      state_to_numpy(tnet.state)))
    for a, b in zip(*trees):
        _assert_trees_close(a, b, 0)


def test_a_replay_drops_the_kernel_layout_weights():
    """A bottleneck plan keeps each conv weight's kernel layout per
    weight tensor; a replay rewrites those tensors in place, so the
    layouts an inference forward cached before it must not survive it
    (checked with a stand-in for the CUDA graph that writes new values
    into the trees in place)."""
    def make():
        return ResNet50(num_classes=10, height=32, width=32,
                        data_format="NHWC", execution_plan="fused"
                        ).init(device="cpu")
    net = make()
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    net.output(x)
    assert net._layouts
    new = network_base.tree_map(lambda t: t * 1.5, net.params)

    class InPlace:
        def replay(self):
            network_base._tree_copy((net.params,), (new,))

    sg = object.__new__(network_base._StepGraph)
    sg.graph = InPlace()
    sg.replay(net)
    net.output(x)
    fresh = make()
    fresh.params = new
    fresh.output(x)
    assert net._layouts.keys() == fresh._layouts.keys()
    for name, (_, w) in fresh._layouts.items():
        assert torch.equal(net._layouts[name][1], w), name
