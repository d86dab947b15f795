"""The port's checkpoints (``deeplearning4j_tpu_torch/util/checkpoint.py``)
against the JAX package's, on the CPU, in the JAX on-disk format:

- a JAX ``save_checkpoint`` after 3 steps (an MLP; a conv -> BN graph)
  restores into the port with the parameters, the BN state, the updater
  state, the counters, the data cursor,
  the sentinel's counts and the learning rate equal bit for bit (the
  ``rng`` leaf, the JAX key, is not the port's stream: the port keeps
  its own and warns); both packages then take 2 more steps, within the
  training tests' f32 limits (rtol 1e-5 on the losses, atol 1e-5 on
  the parameters);
- a port checkpoint passes the JAX ``verify_checkpoint`` and restores
  into the JAX network: the leaf keys of a JAX checkpoint of the same
  network, every leaf's bytes and checksum as the port wrote them;
- ``list_checkpoints``, ``checkpoint_status``, ``list_good_checkpoints``
  and ``list_committed_steps`` read the other package's directories as
  its own listing does;

and torch-vs-torch: a run interrupted after a cadence save and resumed
in a fresh network ends bit for bit where a straight run ends, per
batch, in K = 4 groups (the CPU's group path), with ``prefetch=2``, on a
drawing MLP, the 2-layer transformer graph and a 1-layer tBPTT LSTM; a
corrupt newest checkpoint falls back to the next intact one;
``load_checkpoint`` rebuilds the network; the distributed wrappers take
an explicit rank and world, else (0, 1) without ``torch.distributed``.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.conf.network import (
    MultiLayerConfiguration as JMLConf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.resilience import durable as jdurable
from deeplearning4j_tpu.util import checkpoint as jck
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.dropout import Dropout
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, RmsProp
from deeplearning4j_tpu_torch.optimize import TrainingListener
from deeplearning4j_tpu_torch.resilience import durable
from deeplearning4j_tpu_torch.util import checkpoint as tck
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5      # the training tests' f32 limits
B = 16


def _jconf():
    layers = [jl.DenseLayer(n_out=8, activation="tanh"),
              jl.OutputLayer(n_out=2, loss="mcxent", activation="softmax")]
    return JMLConf(layers=layers, input_type=JIT.feed_forward(4), seed=3,
                   updater=JAdam(0.01))


def _pair():
    """The JAX MLP and the port's from its configuration's JSON, with
    the JAX parameters."""
    jnet = JMLN(_jconf()).init()
    tnet = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jnet.conf.to_dict()))).init(device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    return jnet, tnet


def _data(n=80, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.zeros((n, 2), np.float32)
    y[np.arange(n), (x[:, 0] > 0).astype(int)] = 1.0
    return x, y


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_equal(got, want, path="<root>"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=path)


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step}", "MANIFEST.json")) as f:
        return json.load(f)


class _Losses(TrainingListener):
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, score):
        self.losses.append(float(score))


def _bn_build(nnc, lib, it, upd):
    """A 1x1 conv -> BN (relu) -> average pool -> softmax graph, from
    either package's builder (a network with layer state)."""
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
                n_out=2, loss="mcxent", activation="softmax"), "pool")
            .set_outputs("out").build())


def _bn_pair():
    jnet = JGraph(_bn_build(JNNC, jl, JIT, JAdam(0.01))).init()
    tnet = ComputationGraph(_bn_build(NeuralNetConfiguration, tl, InputType,
                                      Adam(0.01))).init(device="cpu")
    return jnet, tnet


def _bn_data(n=80, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4, 6, 6)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return x, y


PAIRS = {"mlp": (_pair, _data, lambda: JMLN(_jconf()).init()),
         "bn_graph": (_bn_pair, _bn_data,
                      lambda: JGraph(_bn_build(JNNC, jl, JIT,
                                               JAdam(0.01))).init())}


@pytest.mark.parametrize("name", ["mlp", "bn_graph"])
def test_a_jax_checkpoint_restores_into_the_port(tmp_path, caplog, name):
    pair, data, fresh_jax = PAIRS[name]
    jnet, tnet = pair()
    x, y = data()
    jnet.fit(x[:48], y[:48], batch_size=B)          # 3 steps
    jnet.conf.updater.learning_rate = 0.005         # a backed-off rate
    ck = str(tmp_path)
    jck.save_checkpoint(jnet, ck, step=3)
    with caplog.at_level("WARNING"):
        tck.restore_checkpoint(tnet, ck, step=3)
    assert "keeping the network's own seeded stream" in caplog.text
    _assert_equal(params_to_numpy(tnet.params), _np(jnet.params))
    _assert_equal(state_to_numpy(tnet.state), _np(jnet.state))
    _assert_equal(updater_state_to_numpy(tnet.updater_state),
                  _np(jnet.updater_state))
    assert (tnet.iteration_count, tnet.epoch_count) == (3, 1)
    extras = _manifest(ck, 3)["extras"]
    assert tnet._restored_pipeline_state == extras["pipeline"]
    acct = tnet._sentinel_accounting
    assert {k: getattr(acct, k) for k in extras["sentinel"]} == \
        extras["sentinel"]
    assert tnet.conf.updater.learning_rate == 0.005
    # both take two more steps, the JAX package's from its own restore
    # (its jitted step baked the old rate in)
    jnet = fresh_jax()
    jck.restore_checkpoint(jnet, ck, step=3)
    jl_, tl_ = _Losses(), _Losses()
    jnet.set_listeners(jl_)
    tnet.set_listeners(tl_)
    jnet.fit(x[48:], y[48:], batch_size=B)
    tnet.fit(x[48:], y[48:], batch_size=B)
    np.testing.assert_allclose(tl_.losses, jl_.losses, rtol=LOSS_RTOL)
    for got, want in ((params_to_numpy(tnet.params), _np(jnet.params)),
                      (state_to_numpy(tnet.state), _np(jnet.state))):
        for k in want:
            for n in want[k]:
                np.testing.assert_allclose(got[k][n], want[k][n], rtol=0,
                                           atol=PARAM_ATOL)


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    jnet, tnet = _pair()
    x, y = _data()
    tnet.fit(x[:48], y[:48], batch_size=B)
    tck.save_checkpoint(tnet, str(tmp_path / "port"), step=3)
    jck.save_checkpoint(jnet, str(tmp_path / "jax"), step=3)
    assert jck.verify_checkpoint(str(tmp_path / "port"), 3)
    port, ref = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "jax", 3)
    assert sorted(port["leaves"]) == sorted(ref["leaves"])
    assert port["leaves"]["rng"]["dtype"] == "uint8"
    assert port["extras"]["framework"] == tck.FRAMEWORK
    back = JMLN(_jconf()).init()
    jck.restore_checkpoint(back, str(tmp_path / "port"), step=3)
    _assert_equal(_np(back.params), params_to_numpy(tnet.params))
    _assert_equal(_np(back.updater_state),
                  updater_state_to_numpy(tnet.updater_state))
    assert (back.iteration_count, back.epoch_count) == (3, 1)
    # equal bytes, equal checksums: the JAX writer's copy of what it
    # restored carries the port's checksums leaf for leaf
    jck.save_checkpoint(back, str(tmp_path / "again"), step=3)
    again = _manifest(tmp_path / "again", 3)
    assert {k: v["checksum"] for k, v in again["leaves"].items()} == \
        {k: v["checksum"] for k, v in port["leaves"].items()}


def test_each_package_lists_the_others_checkpoints(tmp_path):
    jnet, tnet = _pair()
    x, y = _data()
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    jnet.set_listeners(jck.CheckpointListener(dirs["jax"],
                                              save_every_n_iterations=2,
                                              keep_last=2))
    tnet.set_listeners(tck.CheckpointListener(dirs["port"],
                                              save_every_n_iterations=2,
                                              keep_last=2))
    jnet.fit(x, y, batch_size=B)
    tnet.fit(x, y, batch_size=B)
    for d in dirs.values():
        steps = jck.list_checkpoints(d)
        assert steps == tck.list_checkpoints(d) == [2, 4]
        assert jck.list_good_checkpoints(d) == tck.list_good_checkpoints(d)
        for s in steps:
            assert jck.checkpoint_status(d, s) == tck.checkpoint_status(d, s)
    dist = str(tmp_path / "dist")
    jck.save_distributed_checkpoint(jnet, dist, step=1, rank=0, world=1)
    tck.save_distributed_checkpoint(tnet, dist, step=2, rank=0, world=1)
    os.makedirs(os.path.join(dist, "step_3", "shard_0"))
    assert jdurable.list_committed_steps(dist) == \
        durable.list_committed_steps(dist) == [1, 2]
    other = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
        copy.deepcopy(jnet.conf.to_dict()))).init(device="cpu")
    assert tck.restore_distributed_checkpoint(other, dist, step=1) == 1
    _assert_equal(params_to_numpy(other.params), _np(jnet.params))
    assert tck.restore_distributed_checkpoint(other, dist) == 2
    _assert_equal(params_to_numpy(other.params),
                  params_to_numpy(tnet.params))


# ---------------------------------------------------------------------------
# resume bit for bit (torch-vs-torch)
# ---------------------------------------------------------------------------
V, T = 16, 8


def _drop_mlp():
    layers = [tl.DenseLayer(n_out=8, activation="tanh",
                            dropout=Dropout(0.8)),
              tl.OutputLayer(n_out=2, loss="mcxent", activation="softmax")]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(4), seed=3,
        updater=Adam(0.01))).init(device="cpu")


def _tfm():
    return TextGenerationTransformer(
        vocab_size=V, embed_dim=16, n_heads=2, n_layers=2, max_length=T,
        block_size=8, positional="rope", updater=Adam(3e-3)).init(
            device="cpu")


def _lstm():
    return TextGenerationLSTM(vocab_size=V, hidden=8, layers=1,
                              max_length=4, updater=RmsProp(0.05)).init(
        device="cpu")


def _one_hot(n, seed=1):
    ids = np.random.default_rng(seed).integers(0, V, (n, T))
    x = np.zeros((n, V, T), np.float32)
    x[np.arange(n)[:, None], ids, np.arange(T)[None, :]] = 1.0
    return x, np.roll(x, -1, axis=2)


CASES = {"mlp": (_drop_mlp, lambda: _data(40), 4),
         "transformer": (_tfm, lambda: _one_hot(20), 2),
         "lstm": (_lstm, lambda: _one_hot(10), 2)}


class _Crash(TrainingListener):
    """Raises after iteration ``at`` (a crash after the boundary's save
    is stood in for by the exception, outside the fit's arithmetic)."""

    def __init__(self, at):
        self.at = at

    def on_dispatch_boundary(self, model):
        if model.iteration_count >= self.at:
            raise RuntimeError("crash")


def _trees(net):
    return {"params": params_to_numpy(net.params),
            "updater": updater_state_to_numpy(net.updater_state)}


@pytest.mark.parametrize("name,k,prefetch", [
    ("mlp", 1, 0), ("mlp", 4, 0), ("mlp", 4, 2), ("transformer", 4, 2),
    ("lstm", 1, 0)])
def test_a_resumed_run_ends_where_a_straight_run_ends(tmp_path, name, k,
                                                      prefetch):
    make, data, b = CASES[name]
    x, y = data()
    kw = dict(batch_size=b, steps_per_dispatch=k, prefetch=prefetch)
    straight, lst = make(), _Losses()
    straight.set_listeners(lst)
    straight.fit(x, y, epochs=2, **kw)
    steps = straight.iteration_count
    ck = str(tmp_path)
    broken = make()
    saver = tck.CheckpointListener(ck, save_every_n_iterations=4,
                                   keep_last=1)
    broken.set_listeners(saver, _Crash(steps // 2))
    with pytest.raises(RuntimeError, match="crash"):
        broken.fit(x, y, epochs=2, **kw)
    resumed, rest = make(), _Losses()
    tck.restore_checkpoint(resumed, ck)
    saved = resumed.iteration_count
    assert 0 < saved < steps
    resumed.set_listeners(rest)
    resumed.fit(x, y, epochs=2 - resumed.epoch_count, **kw)
    assert resumed.iteration_count == steps
    assert rest.losses == lst.losses[saved:]
    _assert_equal(_trees(resumed), _trees(straight))


def test_a_corrupt_newest_checkpoint_falls_back(tmp_path):
    net = _drop_mlp()
    x, y = _data(40)
    ck = str(tmp_path)
    net.fit(x, y, batch_size=4)
    tck.save_checkpoint(net, ck, step=1)
    first = params_to_numpy(net.params)
    net.fit(x, y, batch_size=4)
    tck.save_checkpoint(net, ck, step=2)
    data = os.path.join(ck, "step_2", "data.npz")
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) // 2)
    assert not tck.verify_checkpoint(ck, 2) and tck.verify_checkpoint(ck, 1)
    fresh = _drop_mlp()
    with pytest.raises(durable.CorruptCheckpointError):
        tck.restore_checkpoint(fresh, ck, step=2)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(fresh, ck, step=7)
    tck.restore_checkpoint(fresh, ck)
    _assert_equal(params_to_numpy(fresh.params), first)
    loaded = tck.load_checkpoint(ck, step=1, device="cpu")
    assert type(loaded) is MultiLayerNetwork
    _assert_equal(params_to_numpy(loaded.params), first)


def test_the_distributed_wrappers_default_to_one_process(tmp_path):
    net = _drop_mlp()
    net.fit(*_data(40), batch_size=4)
    assert not torch.distributed.is_initialized()
    sdir = tck.save_distributed_checkpoint(net, str(tmp_path), step=5)
    assert sdir.endswith(os.path.join("step_5", "shard_0"))
    assert durable.read_commit(str(tmp_path / "step_5"))["world"] == 1
    fresh = _drop_mlp()
    assert tck.restore_distributed_checkpoint(fresh, str(tmp_path)) == 5
    _assert_equal(_trees(fresh), _trees(net))
    assert torch.equal(fresh._train_gen.get_state(),
                       net._train_gen.get_state())
