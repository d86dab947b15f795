"""The port's fault-tolerant trainer and divergence watchdog
(``deeplearning4j_tpu_torch/util/recovery.py``,
``resilience/watchdog.py``), on the CPU:

- the watchdog raises at the JAX watchdog's iteration with its limit,
  on the same score stream and the same run of bad steps, and its
  window is durable state;
- re-pinned torch-vs-torch from ``tests/test_recovery.py`` and
  ``tests/test_durable.py``: a transient failure restarts from the
  newest checkpoint and ends bit for bit where a straight run ends (a
  crash at an epoch's end; ``RaiseOnBatch`` in the middle of one, over
  an iterator with the data cursor); a second trainer resumes what a
  first one saved; the restarts are bounded;
- a divergence (a run of NaN batches under the sentinel) rolls back to
  the last good checkpoint, deletes the saves after it, backs the
  learning rate off, drops the step graph, and the next step is an
  eager step at the backed-off rate from the restored trees.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.resilience import watchdog as jwatchdog
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, tree_map
from deeplearning4j_tpu_torch.optimize import TrainingListener
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.resilience import watchdog as twatchdog
from deeplearning4j_tpu_torch.resilience.watchdog import (
    DivergenceError, DivergenceWatchdog)
from deeplearning4j_tpu_torch.util import (
    FaultTolerantTrainer, list_checkpoints)
from torch_threads import one_thread  # noqa: F401 (autouse)

B = 8


def _net(seed=3, lr=0.01):
    layers = [tl.DenseLayer(n_out=8, activation="tanh"),
              tl.OutputLayer(n_out=2, loss="mcxent", activation="softmax")]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(4), seed=seed,
        updater=Adam(lr))).init(device="cpu")


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x[:, 0] > 0).astype(int)] = 1.0
    return x, y


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _trees(net):
    return (net.params, net.updater_state, net.state)


class _Cursored:
    """An injector over an ``ArrayDataSetIterator`` that passes the data
    cursor through to it, so a restart resumes mid-pass exactly."""

    def state(self):
        return self.base.state()

    def restore_state(self, state):
        self.base.restore_state(state)


class CursoredRaise(_Cursored, chaos.RaiseOnBatch):
    pass


class CursoredNaN(_Cursored, chaos.NaNPoisonIterator):
    pass


class _EpochCrash(TrainingListener):
    """Raises once, at the end of epoch ``after``."""

    def __init__(self, after):
        self.after, self.armed = after, True

    def on_epoch_end(self, model, epoch):
        if self.armed and epoch + 1 == self.after:
            self.armed = False
            raise RuntimeError("simulated preemption")


# ---------------------------------------------------------------------------
# the watchdog against the JAX package's
# ---------------------------------------------------------------------------
class _Model:
    """A model stand-in carrying only a sentinel accounting."""

    def __init__(self, acct):
        self._sentinel_accounting = acct


def _watch(mod, acct_cls, bad_flag, scores, bad_from):
    """Where ``mod``'s watchdog raises over ``scores`` (a bad step
    recorded from ``bad_from`` on, as that package's step records one),
    its limit and its durable state."""
    acct = acct_cls("m")
    model = _Model(acct)
    wd = mod.DivergenceWatchdog(max_consecutive_bad=3, window=6,
                                min_history=3, check_every=2,
                                blowup_factor=4.0)
    for i, s in enumerate(scores):
        if bad_from is not None and i >= bad_from:
            acct.record(bad_flag, skipped=True)
        try:
            wd.iteration_done(model, i, s)
        except mod.DivergenceError as e:
            return i, e.limit, wd.durable_state()
    return None, None, wd.durable_state()


@pytest.mark.parametrize("case", ["blowup", "bad_steps", "quiet"])
def test_the_watchdog_fires_where_the_jax_one_does(case):
    from deeplearning4j_tpu.resilience.sentinel import (
        SentinelAccounting as JAcct)
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        SentinelAccounting)
    scores = [1.0, 0.9, 0.95, 0.8, 0.85, 0.7, 0.75, 0.72, 0.7, 0.69]
    bad_from = None
    if case == "blowup":
        scores[7] = 40.0
    elif case == "bad_steps":
        bad_from = 4
    want = _watch(jwatchdog, JAcct, np.array([False]), scores, bad_from)
    got = _watch(twatchdog, SentinelAccounting, False, scores, bad_from)
    assert got == want
    assert (got[0] is None) == (case == "quiet")
    wd = DivergenceWatchdog()
    wd.restore_durable_state(got[2])
    assert wd.durable_state() == got[2]


# ---------------------------------------------------------------------------
# restarts (torch-vs-torch)
# ---------------------------------------------------------------------------
def test_an_epoch_end_crash_restarts_bit_for_bit(tmp_path):
    x, y = _data()
    a = _net()
    FaultTolerantTrainer(a, str(tmp_path / "a")).fit(x, y, epochs=4,
                                                     batch_size=B)
    b = _net()
    crash = _EpochCrash(2)
    b.add_listener(crash)
    FaultTolerantTrainer(b, str(tmp_path / "b")).fit(x, y, epochs=4,
                                                     batch_size=B)
    assert not crash.armed and b.epoch_count == 4
    assert b.iteration_count == a.iteration_count == 32
    assert _equal(_trees(b), _trees(a))
    assert list_checkpoints(str(tmp_path / "b"))[-1] == 32


def test_a_mid_epoch_fault_restarts_bit_for_bit(tmp_path):
    """``RaiseOnBatch`` before global batch 5, cadence saves every 2
    iterations: the restart restores step 4 and the cursor's pass
    position, and the run ends where a straight one ends."""
    x, y = _data()
    a = _net()
    a.fit(ArrayDataSetIterator(x, y, B, shuffle=True, seed=2), epochs=2)
    b = _net()
    it = CursoredRaise(ArrayDataSetIterator(x, y, B, shuffle=True, seed=2),
                       n=5)
    trainer = FaultTolerantTrainer(b, str(tmp_path),
                                   save_every_n_iterations=2)
    trainer.fit(it, epochs=2)
    assert it.faults_fired == 1
    assert b.iteration_count == a.iteration_count == 16
    assert _equal(_trees(b), _trees(a))


def test_a_second_trainer_resumes_the_first(tmp_path):
    x, y = _data()
    first = _net()
    FaultTolerantTrainer(first, str(tmp_path)).fit(x, y, epochs=2,
                                                   batch_size=B)
    second = _net(seed=9)
    FaultTolerantTrainer(second, str(tmp_path)).fit(x, y, epochs=3,
                                                    batch_size=B)
    straight = _net()
    straight.fit(x, y, epochs=3, batch_size=B)
    assert second.epoch_count == 3
    assert _equal(_trees(second), _trees(straight))
    done = _net(seed=11)
    FaultTolerantTrainer(done, str(tmp_path)).fit(x, y, epochs=2,
                                                  batch_size=B)
    assert done.epoch_count == 3         # restored, not rewound


def test_the_restarts_are_bounded(tmp_path):
    class Always(TrainingListener):
        def on_epoch_end(self, model, epoch):
            raise RuntimeError("hard failure")
    net = _net()
    net.add_listener(Always())
    with pytest.raises(RuntimeError, match="hard failure"):
        FaultTolerantTrainer(net, str(tmp_path), max_restarts=2).fit(
            *_data(), epochs=3, batch_size=B)


# ---------------------------------------------------------------------------
# divergence: rollback and the backed-off rate
# ---------------------------------------------------------------------------
class _After(TrainingListener):
    """Keeps the trees at the start of each fit and after each step of
    iteration ``at`` (clones)."""

    def __init__(self, at):
        self.at, self.starts, self.after = at, [], []

    def on_epoch_start(self, model, epoch):
        self.starts.append(tree_map(torch.clone, model.params))

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            self.after.append(tree_map(torch.clone, model.params))


def test_a_divergence_rolls_back_and_backs_the_rate_off(tmp_path):
    """NaN batches 4 and 5: the sentinel skips both, the watchdog (2 bad
    in a row) raises in iteration 5, before the boundary save of step
    6. The trainer restores step 4 (the newest good save), halves the
    rate, drops the step graph and goes on from batch 4 (its global
    index now 6: clean): that step equals an eager step from step 4's
    trees at the halved rate, not one at the old rate."""
    x, y = _data()
    net = _net(lr=0.05)
    net._step_graph = object()        # stands in for a captured graph
    watch = _After(4)
    net.add_listener(watch)
    wd = DivergenceWatchdog(max_consecutive_bad=2, check_every=1)
    trainer = FaultTolerantTrainer(net, str(tmp_path),
                                   save_every_n_iterations=2,
                                   save_every_epoch=False, watchdog=wd,
                                   lr_backoff=0.5)
    it = CursoredNaN(ArrayDataSetIterator(x, y, B), n=[4, 5])
    trainer.fit(it, epochs=1)
    assert net.conf.updater.learning_rate == 0.025
    assert net._step_graph is None
    assert net.iteration_count == 8
    assert len(watch.starts) == 2 and len(watch.after) == 2
    restored = watch.starts[1]
    for lr, same in ((0.025, True), (0.05, False)):
        ref = _net(lr=lr)
        pre = _net(lr=0.05)
        pre.fit(x[:4 * B], y[:4 * B], batch_size=B)   # steps 0-3
        assert _equal(pre.params, restored)
        ref.params, ref.updater_state, ref.state = (
            pre.params, pre.updater_state, pre.state)
        ref.fit(x[4 * B:5 * B], y[4 * B:5 * B], batch_size=B)
        assert _equal(ref.params, watch.after[1]) is same
    assert list_checkpoints(str(tmp_path)) == [4, 6, 8]


def test_a_divergence_without_a_checkpoint_or_backoff_is_not_retried(
        tmp_path):
    x, y = _data()
    net = _net()
    wd = DivergenceWatchdog(max_consecutive_bad=1, check_every=1)
    trainer = FaultTolerantTrainer(net, str(tmp_path),
                                   save_every_epoch=False,
                                   save_every_n_iterations=100, watchdog=wd)
    with pytest.raises(DivergenceError):
        trainer.fit(chaos.NaNPoisonIterator(ArrayDataSetIterator(x, y, B),
                                            n=0), epochs=1)
