"""The port's durable layer (``deeplearning4j_tpu_torch/resilience/
durable.py``, ``datasets/iterators.py``, ``resilience/chaos.py``) against
the JAX package's, on the CPU:

- the two checkpoint writers pass the same crash milestones, in order,
  recorded with a hook on each;
- the iterators yield the JAX iterators' batches, the array iterator's
  cursor reads as the JAX one's, and the training injectors fire at
  the JAX injectors' global indices (the serving and fleet injectors
  refuse, naming their ROADMAP.md items);

and, re-pinned torch-vs-torch from ``tests/test_durable.py``:

- a kill at each milestone of a save leaves the predecessor intact (a
  kill past the rename means the step is committed);
- the asynchronous writer runs jobs in order, keeps one worker, and
  blocks a submit while its queue is full; ``keep_last`` pruning leaves
  no orphaned tag or directory;
- ``PreemptionGuard.trigger`` saves at the next dispatch boundary
  (after a whole K-step group) and a fresh network resumes bit for bit;
- the local commit protocol: a step without its COMMIT marker is
  invisible, a missing shard times out without a marker;
- a worker process SIGKILLed by ``ProcessKillInjector`` in the middle of
  an epoch (this file is its own worker under ``__main__``) leaves
  checkpoints that verify, and a fresh network resumed from the newest
  ends bit for bit where a straight run ends.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterators as jiters
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.resilience import chaos as jchaos
from deeplearning4j_tpu.resilience import durable as jdurable
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.datasets import iterators as titers
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.dropout import Dropout
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam
from deeplearning4j_tpu_torch.optimize import TrainingListener
from deeplearning4j_tpu_torch.resilience import chaos, durable
from deeplearning4j_tpu_torch.resilience.durable import (
    AsyncCheckpointWriter, CommitTimeoutError, PreemptionExit,
    PreemptionGuard, latest_committed_step, list_committed_steps,
    publish_commit, read_commit, sweep_tmp_dirs, write_shard)
from deeplearning4j_tpu_torch.util.checkpoint import (
    CheckpointListener, list_checkpoints, restore_checkpoint,
    save_checkpoint, verify_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N = 8, 48                     # 6 batches a pass


def _net(seed=3, dropout=True):
    """A small MLP; with ``dropout`` its hidden layer draws (its
    training generator is part of the checkpoint)."""
    kw = {"dropout": Dropout(0.8)} if dropout else {}
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(0.01)).list()
            .layer(DenseLayer(n_out=8, activation="tanh", **kw))
            .layer(OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x[:, 0] > 0).astype(int)] = 1.0
    return x, y


def _it(shuffle=True):
    return ArrayDataSetIterator(*_data(), B, shuffle=shuffle, seed=5)


def _trees(net):
    return {"params": net.params, "updater": net.updater_state,
            "state": net.state}


def _assert_bitwise(a, b, path="<root>"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
        return
    assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path


class _Scores(TrainingListener):
    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(float(score))


class _TriggerAt(TrainingListener):
    """Arms the guard in iteration ``at - 1``'s listener pass: it fires
    at the next dispatch boundary."""

    def __init__(self, guard, at):
        self.guard, self.at = guard, at

    def iteration_done(self, model, iteration, score):
        if iteration + 1 == self.at:
            self.guard.trigger()


# ---------------------------------------------------------------------------
# the writers' milestones, against the JAX writer
# ---------------------------------------------------------------------------
def _milestones(mod, write, tmp):
    seen = []
    old = mod._crash_hook
    mod._crash_hook = seen.append
    try:
        tree = {"params": {"0": {"W": np.arange(6, dtype=np.float32)}},
                "rng": np.zeros(2, np.uint32)}
        write(os.path.join(tmp, "step_1"), tree)
        write(os.path.join(tmp, "latest"), tree)
        write(os.path.join(tmp, "latest"), tree)   # a replace
    finally:
        mod._crash_hook = old
    return seen


def test_the_two_writers_pass_the_same_milestones(tmp_path):
    want = _milestones(jdurable, jdurable.write_checkpoint_dir,
                       str(tmp_path / "jax"))
    got = _milestones(durable, durable.write_checkpoint_dir,
                      str(tmp_path / "port"))
    assert got == want
    assert "mid-replace" in got and got.count("post-rename") == 3


@pytest.mark.parametrize("point", ["data-written", "pre-rename",
                                   "mid-replace", "post-rename"])
def test_a_kill_at_each_milestone_leaves_the_predecessor(tmp_path,
                                                         monkeypatch, point):
    """A kill before the rename leaves step 1 the newest (step 2 never
    appears, no temporary litter once swept); a kill while replacing a
    step keeps its old copy; past the rename the step is committed."""
    x, y = _data()
    net = _net()
    net.fit(x, y, batch_size=B)
    ck = str(tmp_path)
    step = None if point == "mid-replace" else 1
    save_checkpoint(net, ck, step=step)
    before = {k: v.clone() for k, v in net.params["0"].items()}
    net.fit(x, y, batch_size=B)

    class Kill(BaseException):
        pass

    def crash(label):
        if label == point:
            raise Kill(label)

    monkeypatch.setattr(durable, "_crash_hook", crash)
    with pytest.raises(Kill):
        save_checkpoint(net, ck, step=None if step is None else 2)
    monkeypatch.setattr(durable, "_crash_hook", None)
    sweep_tmp_dirs(ck)
    fresh = _net()
    if point == "mid-replace":
        assert durable.verify_state_dir(str(tmp_path / "latest"))
        assert not [n for n in os.listdir(ck) if ".replaced." in n]
        restore_checkpoint(fresh, ck)
    elif point == "post-rename":
        assert list_checkpoints(ck) == [1, 2] and verify_checkpoint(ck, 2)
        restore_checkpoint(fresh, ck)
        assert fresh.epoch_count == 2
        return
    else:
        assert list_checkpoints(ck) == [1] and verify_checkpoint(ck, 1)
        restore_checkpoint(fresh, ck)
    assert fresh.epoch_count == 1
    _assert_bitwise(fresh.params["0"], before)


def test_the_async_writer_keeps_order_and_backpressure():
    import threading
    import time
    w = AsyncCheckpointWriter(max_pending=1)
    order, gate = [], threading.Event()
    w.submit(lambda: (gate.wait(10), order.append("slow")))
    threading.Timer(0.3, gate.set).start()
    t0 = time.perf_counter()
    w.submit(lambda: order.append("queued"))     # fills the queue
    w.submit(lambda: order.append("blocked"))    # waits for a free slot
    assert time.perf_counter() - t0 >= 0.2
    assert w.flush(10) and order == ["slow", "queued", "blocked"]
    first = w._thread
    w.close()
    w.submit(lambda: order.append("after close"))
    assert w.flush(10) and w._thread is first and order[-1] == "after close"

    def fail():
        raise OSError("disk full")
    w.submit(fail)
    w.flush(10)
    h = w.health()
    assert not h["healthy"] and h["failures"] == 1 and "disk full" in \
        h["last_error"]
    w.submit(lambda: None)
    w.flush(10)
    assert w.health()["healthy"]


def test_keep_last_prunes_without_orphans(tmp_path):
    x, y = _data()
    net = _net()
    ck = str(tmp_path)
    lst = CheckpointListener(ck, save_every_n_iterations=2, keep_last=2,
                             async_save=True)
    net.set_listeners(lst)
    net.fit(x, y, epochs=2, batch_size=B)         # 12 iterations
    assert lst.flush(30)
    assert list_checkpoints(ck) == [10, 12]
    assert sorted(os.listdir(ck)) == [
        "config.json", "step_10", "step_10.resilience.json", "step_12",
        "step_12.resilience.json"]
    assert all(verify_checkpoint(ck, s) for s in (10, 12))
    assert lst.health()["healthy"]


@pytest.mark.parametrize("k", [1, 4])
def test_preemption_saves_at_the_next_boundary_and_resumes(tmp_path, k):
    """Triggered in iteration 2's listener pass, the guard saves at the
    boundary after it (with K = 4, after the group of steps 0-3) and
    raises; a fresh network restored from that save finishes the run
    bit for bit as a straight run does."""
    a, tr_a = _net(), _Scores()
    a.set_listeners(tr_a)
    a.fit(_it(), epochs=2, steps_per_dispatch=k)
    b, tr_b = _net(), _Scores()
    guard = PreemptionGuard(b, str(tmp_path), install=False)
    b.set_listeners(tr_b, _TriggerAt(guard, 3))
    with pytest.raises(PreemptionExit) as exc:
        b.fit(_it(), epochs=2, steps_per_dispatch=k)
    assert exc.value.step == b.iteration_count == (3 if k == 1 else 4)
    assert list_checkpoints(str(tmp_path)) == [exc.value.step]
    guard.uninstall()
    c, tr_c = _net(), _Scores()
    restore_checkpoint(c, str(tmp_path))
    c.set_listeners(tr_c)
    c.fit(_it(), epochs=2 - c.epoch_count, steps_per_dispatch=k)
    assert tr_b.scores + tr_c.scores == tr_a.scores
    assert (c.iteration_count, c.epoch_count) == (a.iteration_count,
                                                  a.epoch_count)
    _assert_bitwise(_trees(c), _trees(a))


def test_an_uncommitted_step_stays_invisible(tmp_path):
    """Shards without rank 0's COMMIT marker are invisible; the marker
    publishes only when every shard verifies; a missing shard times out
    with its rank and leaves no marker. The JAX package's listing reads
    these directories the same."""
    root = str(tmp_path)
    tree = {"params": {"0": {"W": np.ones(3, np.float32)}}}
    for step in (1, 2):
        for rank in range(2):
            write_shard(os.path.join(root, f"step_{step}"), rank, tree)
    publish_commit(os.path.join(root, "step_1"), step=1, world=2)
    assert list_committed_steps(root) == [1]
    assert latest_committed_step(root) == 1
    write_shard(os.path.join(root, "step_3"), 0, tree)
    with pytest.raises(CommitTimeoutError) as e:
        publish_commit(os.path.join(root, "step_3"), step=3, world=2,
                       timeout=0.2)
    assert e.value.missing_ranks == [1] and e.value.step == 3
    assert read_commit(os.path.join(root, "step_3")) is None
    assert list_committed_steps(root) == [1]
    assert jdurable.list_committed_steps(root) == [1]
    jdurable.publish_commit(os.path.join(root, "step_2"), step=2, world=2)
    assert list_committed_steps(root) == [1, 2]


# ---------------------------------------------------------------------------
# iterators and injectors, against the JAX package's
# ---------------------------------------------------------------------------
def _sets(n=5, rows=3, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, 4)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)])
            for _ in range(n)]


def _batches(it, passes=2):
    out = []
    for _ in range(passes):
        out += [(np.asarray(ds.features).copy(),
                 None if ds.labels is None else np.asarray(ds.labels).copy())
                for ds in it]
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        assert (gy is None) == (wy is None)
        if gy is not None:
            np.testing.assert_array_equal(gy, wy)


def _iterator_pair(name, pkg, tmp):
    """The iterator ``name`` built from the same arrays and seed in the
    port (pkg "port") or the JAX package (pkg "jax")."""
    mod, DS = (titers, DataSet) if pkg == "port" else (jiters, JDataSet)
    x, y = _data(20, seed=2)
    sets = [DS(a, b) for a, b in _sets()]
    if name == "array_shuffled":
        return mod.ArrayDataSetIterator(x, y, 6, shuffle=True, seed=4)
    if name == "existing":
        return mod.ExistingDataSetIterator(sets)
    if name == "async":
        return mod.AsyncDataSetIterator(
            mod.ArrayDataSetIterator(x, y, 6, shuffle=True, seed=4), 2)
    if name == "benchmark":
        return mod.BenchmarkDataSetIterator((4, 3), 5, 3, seed=8)
    if name == "multiple_epochs":
        return mod.MultipleEpochsIterator(2, mod.ArrayDataSetIterator(
            x, y, 6, shuffle=True, seed=4))
    if name == "early_termination":
        return mod.EarlyTerminationDataSetIterator(
            mod.ArrayDataSetIterator(x, y, 3), 4)
    if name == "sampling":
        return mod.SamplingDataSetIterator(DS(x, y), 5, 4, seed=6)
    if name == "joint":
        return mod.JointParallelDataSetIterator(
            mod.ExistingDataSetIterator(sets[:3]),
            mod.ArrayDataSetIterator(x, y, 7),
            stop_on_first_exhausted=False)
    if name == "file_split":
        os.makedirs(tmp, exist_ok=True)
        for i, (a, b) in enumerate(_sets(3, rows=5)):
            np.savez(os.path.join(tmp, f"s{i}.npz"), features=a, labels=b)
        np.save(os.path.join(tmp, "s9.npy"), x[:4])
        return mod.FileSplitParallelDataSetIterator(tmp, batch_size=2,
                                                    num_threads=2)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "array_shuffled", "existing", "async", "benchmark", "multiple_epochs",
    "early_termination", "sampling", "joint", "file_split"])
def test_the_iterators_yield_the_jax_batches(tmp_path, name):
    want = _batches(_iterator_pair(name, "jax", str(tmp_path)))
    got = _batches(_iterator_pair(name, "port", str(tmp_path)))
    _same_batches(got, want)


def test_the_array_cursor_reads_as_the_jax_one():
    """``state()`` before, inside and after a pass, and a pass restored
    from (epoch 1, pos 2), as the JAX iterator's."""
    x, y = _data(30, seed=3)
    reads = []
    for mod in (jiters, titers):
        it = mod.ArrayDataSetIterator(x, y, 6, shuffle=True, seed=9)
        seq = [it.state()]
        g = iter(it)
        next(g), next(g)
        seq.append(it.state())
        for _ in g:
            pass
        seq.append(it.state())
        it.restore_state({"epoch": 1, "pos": 2})
        seq.append(it.state())
        seq.append([np.asarray(ds.features).copy() for ds in it])
        reads.append(seq)
    (j, p) = reads
    assert p[:4] == j[:4] == [{"epoch": 0, "pos": 0}, {"epoch": 0, "pos": 2},
                              {"epoch": 1, "pos": 0}, {"epoch": 1, "pos": 2}]
    _same_batches([(a, None) for a in p[4]], [(a, None) for a in j[4]])


def _events(inj_cls, mod, sets, passes=2, **kw):
    """Pull ``passes`` passes through the injector, recording each
    batch's first value or the fault and its global index. A faulted
    pull is retried once, as a retry layer would; a second fault at the
    same index ends the pass."""
    inj = inj_cls(mod.ExistingDataSetIterator(sets), **kw)
    seen = []
    for _ in range(passes):
        cur, last = iter(inj), None
        while True:
            try:
                ds = next(cur)
            except StopIteration:
                break
            except Exception as e:      # noqa: BLE001 — recorded
                seen.append((type(e).__name__, inj.batches_seen))
                if last == inj.batches_seen:
                    break
                last = inj.batches_seen
                continue
            seen.append(float(np.asarray(ds.features).ravel()[0]))
    return seen


@pytest.mark.parametrize("case", [
    ("RaiseOnBatch", {"n": 3}), ("RaiseOnBatch", {"n": 2, "once": False,
                                                  "period": 3}),
    ("FaultBurstInjector", {"n": 4, "k": 2}),
    ("NaNPoisonIterator", {"n": [1, 6]}),
    ("LatencyIterator", {"seconds": 0.0, "every": 2}),
    ("PreemptionIterator", {"n": 7})])
def test_the_injectors_fire_at_the_jax_indices(case):
    name, kw = case
    raw = _sets(5)
    want = _events(getattr(jchaos, name), jiters,
                   [JDataSet(a, b) for a, b in raw], **kw)
    got = _events(getattr(chaos, name),
                  titers,
                  [DataSet(a, b) for a, b in raw], **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w or (g != g and w != w)


def test_the_process_kill_injector_fires_at_the_jax_index():
    """With a catchable signal (SIGUSR1, handled here) both packages'
    injectors signal the process once, before global batch 4."""
    fired = []
    old = signal.signal(signal.SIGUSR1, lambda *a: fired.append(None))
    try:
        at = []
        for mod, cls, DS in ((jiters, jchaos.ProcessKillInjector,
                              JDataSet),
                             (titers,
                              chaos.ProcessKillInjector, DataSet)):
            inj = cls(mod.ExistingDataSetIterator(
                [DS(a, b) for a, b in _sets(6)]), n=4,
                sig=signal.SIGUSR1)
            for i, _ in enumerate(inj):
                if fired:
                    at.append(i)
                    fired.clear()
        assert at == [4, 4]
    finally:
        signal.signal(signal.SIGUSR1, old)


def test_fire_drives_an_injector_outside_an_iterator():
    inj = chaos.RaiseOnBatch(None, n=2)
    chaos.fire(inj, 0)
    chaos.fire(inj, 1)
    with pytest.raises(chaos.InjectedFault):
        chaos.fire(inj, 2)
    chaos.fire(inj, 2)                  # once: the latch is spent
    assert inj.batches_seen == 3
    calls = []
    chaos.fire(calls.append, 5)
    chaos.fire(None, 6)
    assert calls == [5]


@pytest.mark.parametrize("name,item", [
    ("RequestFaultInjector", "A7"), ("PageExhaustionInjector", "A7"),
    ("HostLossInjector", "A9"), ("LeaseStallInjector", "A10"),
    ("MailboxInjector", "A10"), ("TornCommandInjector", "A10"),
    ("DuplicateDeliveryInjector", "A10"),
    ("DelayedDeliveryInjector", "A10")])
def test_the_serving_and_fleet_injectors_refuse(name, item):
    """The multi-host and fleet injectors refuse, naming their items.
    The serving engine's two (A7) are ported with its supervisor: they
    fire through ``chaos.fire`` at its seams (the engine runs them in
    tests/test_torch_serving_supervisor.py)."""
    if item != "A7":
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            getattr(chaos, name)(None, 0)
        return
    from deeplearning4j_tpu_torch.serving.paging import PagePool
    if name == "RequestFaultInjector":
        inj = chaos.RequestFaultInjector(match=lambda r: r == "victim")
        chaos.fire(inj, 0, ctx="bystander")
        with pytest.raises(chaos.InjectedFault):
            chaos.fire(inj, 1, ctx="victim")
        chaos.fire(inj, 2, ctx="victim")          # once: the latch holds
        assert inj.faults_fired == 1
    else:
        pool = PagePool(9, 4)
        inj = chaos.PageExhaustionInjector(pool, n=1, free_target=2)
        chaos.fire(inj, 0)
        assert pool.free_count() == 8
        chaos.fire(inj, 1)
        assert pool.free_count() == 2 and pool.used_count() == 0
        inj.release()
        assert pool.free_count() == 8


# ---------------------------------------------------------------------------
# a real SIGKILL
# ---------------------------------------------------------------------------
KILL_AT, EPOCHS = 9, 2


def _worker(ck: str) -> None:
    """Train with cadence saves and a ProcessKillInjector that SIGKILLs
    this process before global batch KILL_AT (pass 1, batch 3)."""
    net = _net()
    net.set_listeners(CheckpointListener(ck, save_every_n_iterations=4,
                                         keep_last=2, async_save=True))
    net.fit(chaos.ProcessKillInjector(_it(), n=KILL_AT), epochs=EPOCHS,
            steps_per_dispatch=2)
    sys.exit(3)                         # not reached


def test_a_sigkilled_worker_resumes_bit_for_bit(tmp_path):
    ck = str(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "kill9", ck], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stdout + proc.stderr
    steps = list_checkpoints(ck)
    assert steps and steps[-1] <= KILL_AT
    assert all(verify_checkpoint(ck, s) for s in steps)
    straight = _net()
    straight.fit(_it(), epochs=EPOCHS, steps_per_dispatch=2)
    resumed = _net()
    restore_checkpoint(resumed, ck)
    assert resumed.iteration_count == steps[-1]
    resumed.fit(_it(), epochs=EPOCHS - resumed.epoch_count,
                steps_per_dispatch=2)
    assert resumed.iteration_count == straight.iteration_count
    _assert_bitwise(_trees(resumed), _trees(straight))


if __name__ == "__main__":
    if sys.argv[1:2] == ["kill9"]:
        _worker(sys.argv[2])
