"""The sequential network's breadth in the port (deeplearning4j_tpu_torch/
nn/conf/preprocessors.py, SAME windows in nn/layers/convolution.py,
zoo/lenet.py, MultiLayerNetwork ``feed_forward`` / ``summary`` /
``clone``, ComputationGraph ``summary``) against the JAX package's, on
the CPU in f32.

- Each of the six preprocessors, forward and backward (a seeded
  cotangent through ``jax.vjp`` and autograd), NCHW and internal NHWC
  where it has a layout: exact (reshapes and permutes), and their JSON
  form key for key; the builder infers them as the JAX package does.
- SAME convolution (2-D, dilated, 1-D), max and average pooling at odd
  sizes and strides 1 to 3 against the JAX ops (XLA's asymmetric pads),
  within CONV_ATOL (f32 sums in other orders).
- LeNet at 28x28 (the JAX init's parameters carried over with
  ``util/convert.params_from_numpy``): the output within OUT_ATOL; three
  fit steps with the score within 1e-5 relative, under SGD each leaf
  within 1e-5 of its own update, under the zoo's Adam within 1e-2 of
  the learning rate (``FIT_UPDATERS`` says why); ``feed_forward`` layer
  by layer within OUT_ATOL; ``summary``
  character for character (the graph's too); a clone shares no tensor
  and stays put while its source trains.
- A network of an LSTM and dense layers (the inferred RNN to
  feed-forward preprocessor) against the JAX one, and the refusals that
  stay: feed-forward to CNN has no shape to infer; a mask through a
  preprocessor is A6's; ``pretrain`` is A11's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JBuilder
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import preprocessors as jp
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.multilayer import (
    MultiLayerNetwork as JMultiLayerNetwork)
from deeplearning4j_tpu.nn.updater import Adam as JAdam
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu.zoo.transformer import (
    TextGenerationTransformer as JaxTFM)
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import (
    MultiLayerConfiguration, NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import Adam, Sgd
from deeplearning4j_tpu_torch.util.convert import (
    params_from_numpy, params_to_numpy)
from deeplearning4j_tpu_torch.zoo import LeNet, TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

CONV_ATOL = 1e-5
OUT_ATOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------
# preprocessors
# ---------------------------------------------------------------------
#: (name, fields, input shape)
PRE_CASES = [
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=5, channels=2),
     (4, 2, 3, 5)),
    ("CnnToFeedForwardPreProcessor", dict(height=3, width=5, channels=2,
                                          data_format="NHWC"), (4, 3, 5, 2)),
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=5, channels=2),
     (4, 30)),
    ("FeedForwardToCnnPreProcessor", dict(height=3, width=5, channels=2,
                                          data_format="NHWC"), (4, 30)),
    ("RnnToFeedForwardPreProcessor", {}, (3, 6, 5)),
    ("FeedForwardToRnnPreProcessor", dict(timesteps=5), (15, 6)),
    ("CnnToRnnPreProcessor", dict(height=3, width=4, channels=2,
                                  timesteps=5), (10, 2, 3, 4)),
    ("CnnToRnnPreProcessor", dict(height=3, width=4, channels=2, timesteps=5,
                                  data_format="NHWC"), (10, 3, 4, 2)),
    ("RnnToCnnPreProcessor", dict(height=3, width=4, channels=2),
     (2, 24, 5)),
    ("RnnToCnnPreProcessor", dict(height=3, width=4, channels=2,
                                  data_format="NHWC"), (2, 24, 5)),
]


@pytest.mark.parametrize("name,fields,shape", PRE_CASES,
                         ids=[f"{c[0]}-{c[1].get('data_format', 'NCHW')}"
                              for c in PRE_CASES])
def test_each_preprocessor_forward_and_backward_equals_jax(name, fields,
                                                          shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    x = rng.standard_normal(shape).astype(np.float32)
    jpre = jp.PREPROCESSOR_REGISTRY[name](**fields)
    tpre = tp.PREPROCESSOR_REGISTRY[name](**fields)
    want, vjp = jax.vjp(jpre.apply, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tpre.apply(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    got.backward(torch.tensor(ct))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(ct))[0]))
    d = tp.preprocessor_to_dict(tpre)
    assert d == jp.preprocessor_to_dict(jpre)
    assert tp.preprocessor_from_dict(d) == tpre
    if name != "RnnToFeedForwardPreProcessor":
        it = (JInputType.convolutional(3, 5, 2) if "Cnn" in name[:3]
              else JInputType.feed_forward(30))
        tit = (InputType.convolutional(3, 5, 2) if "Cnn" in name[:3]
               else InputType.feed_forward(30))
        assert tpre.output_type(tit).to_dict() == \
            jpre.output_type(it).to_dict()


def test_the_builder_infers_preprocessors_as_jax():
    def build(pkg):
        L, B, IT = (jl, JBuilder, JInputType) if pkg == "jax" else \
            (tl, NeuralNetConfiguration, InputType)
        return (B.Builder().seed(3).list()
                .layer(L.ConvolutionLayer(n_out=3, kernel=(3, 3),
                                          convolution_mode="same"))
                .layer(L.SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
                .layer(L.DenseLayer(n_out=5))
                .layer(L.OutputLayer(n_out=2, loss="mcxent",
                                     activation="softmax"))
                .set_input_type(IT.convolutional(7, 9, 2)).build())
    want, got = build("jax").to_dict(), build("torch").to_dict()
    assert got == want
    assert got["preprocessors"]["2"]["@class"] == \
        "CnnToFeedForwardPreProcessor"
    assert MultiLayerConfiguration.from_json(json.dumps(got)).to_dict() == \
        want
    with pytest.raises(ValueError, match="add it explicitly"):
        (NeuralNetConfiguration.Builder().list()
         .layer(tl.ConvolutionLayer(n_out=3, kernel=(3, 3)))
         .set_input_type(InputType.feed_forward(12)).build())


# ---------------------------------------------------------------------
# SAME windows
# ---------------------------------------------------------------------
SIZES = [(7, 9), (5, 6), (11, 4)]


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_same_windows_equal_jax(hw, stride):
    rng = np.random.default_rng(hw[0] * 10 + stride)
    x = rng.standard_normal((2, 3) + hw).astype(np.float32)
    s = (stride, stride)
    for k, d in ((2, 1), (3, 1), (3, 2)):
        w = rng.standard_normal((4, 3, k, k)).astype(np.float32)
        b = rng.standard_normal(4).astype(np.float32)
        want = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), s, (0, 0), (d, d),
                                       "same"))
        got = tconv.conv2d(torch.tensor(x), torch.tensor(w),
                           torch.tensor(b), s, (0, 0), (d, d), "same")
        assert got.shape == want.shape == (2, 4, -(-hw[0] // stride),
                                           -(-hw[1] // stride))
        np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL)
        # NHWC internally: the same values in the other layout
        got_nhwc = tconv.conv2d(torch.tensor(x).permute(0, 2, 3, 1),
                                torch.tensor(w), torch.tensor(b), s, (0, 0),
                                (d, d), "same", data_format="NHWC")
        np.testing.assert_allclose(got_nhwc.permute(0, 3, 1, 2).numpy(),
                                   want, atol=CONV_ATOL)
        for fn in ("max_pool2d", "avg_pool2d"):
            want = np.asarray(getattr(jconv, fn)(jnp.asarray(x), (k, k), s,
                                                 (0, 0), "same"))
            got = getattr(tconv, fn)(torch.tensor(x), (k, k), s, (0, 0),
                                     "same")
            np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL)
        w1 = rng.standard_normal((4, 3, k)).astype(np.float32)
        want = np.asarray(jconv.conv1d(jnp.asarray(x[:, :, 0]),
                                       jnp.asarray(w1), jnp.asarray(b),
                                       stride, 0, d, "same"))
        got = tconv.conv1d(torch.tensor(x[:, :, 0]), torch.tensor(w1),
                           torch.tensor(b), stride, 0, d, "same")
        np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL)
    # explicit padding counted in truncate mode, as the JAX package does
    want = np.asarray(jconv.avg_pool2d(jnp.asarray(x), (3, 3), s, (1, 1)))
    got = tconv.avg_pool2d(torch.tensor(x), (3, 3), s, (1, 1))
    np.testing.assert_allclose(got.numpy(), want, atol=CONV_ATOL)


def test_same_pads_are_xlas_asymmetric_split():
    # in 6, k 3, s 2: out 3, total 1 -> (0, 1); in 7, k 4, s 1: (1, 2)
    assert tconv.same_pads(6, 3, 2) == (0, 1)
    assert tconv.same_pads(7, 4, 1) == (1, 2)
    assert tconv.same_pads(5, 3, 1, 2) == (2, 2)
    assert tconv.same_pads(9, 2, 3) == (0, 0)


# ---------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def lenet():
    jnet = JaxLeNet().init()
    np_params = _np(jnet.params)
    tnet = LeNet().init(device="cpu")
    tnet.params = params_from_numpy(np_params, "cpu")
    tnet.updater_state = tnet.conf.updater.init_state(tnet.params)
    rng = np.random.default_rng(0)
    x = rng.random((24, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 24)]
    return jnet, tnet, np_params, x, y


def test_lenet_output_and_layers_equal_jax(lenet):
    jnet, tnet, _, x, _ = lenet
    np.testing.assert_allclose(tnet.output(x[:8]).numpy(),
                               np.asarray(jnet.output(x[:8])),
                               atol=OUT_ATOL)
    got, want = tnet.feed_forward(x[:8]), jnet.feed_forward(x[:8])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL,
                                   rtol=1e-5)
    assert torch.equal(got[-1], tnet.output(x[:8]))
    assert tnet.summary() == jnet.summary()
    assert tnet.conf.to_dict() == jnet.conf.to_dict()


#: (JAX updater, port updater, leaf limit, whether the limit is a share
#: of each leaf's update (else of the learning rate))
FIT_UPDATERS = {
    # SGD: the update is the gradient; f32 sums in other orders
    "sgd": (JSgd(0.1), Sgd(0.1), 1e-5, True),
    # the zoo's Adam: its first steps divide each gradient by its own
    # magnitude, which turns f32 noise on near-zero gradients into up to
    # ~3e-3 of a leaf's largest update (measured): held to 1e-2 of lr
    "adam": (JAdam(1e-3), Adam(1e-3), 1e-2, False)}


@pytest.mark.parametrize("updater", sorted(FIT_UPDATERS))
def test_lenet_three_fit_steps_match_jax(lenet, updater):
    _, _, start, x, y = lenet
    jupd, tupd, limit, of_update = FIT_UPDATERS[updater]
    jnet = JaxLeNet(updater=jupd).init()
    jnet.params = jax.tree_util.tree_map(jnp.asarray, start)
    tnet = LeNet(updater=tupd).init(device="cpu")
    tnet.params = params_from_numpy(start, "cpu")
    tnet.updater_state = tnet.conf.updater.init_state(tnet.params)
    jnet.fit(JDataSet(x, y), batch_size=8)
    tnet.fit(DataSet(x, y), batch_size=8)
    assert tnet.iteration_count == jnet.iteration_count == 3
    assert tnet.score_value == pytest.approx(float(jnet.score_value),
                                             rel=1e-5)
    got, want = params_to_numpy(tnet.params), _np(jnet.params)
    for k in want:
        for n in want[k]:
            scale = (np.abs(want[k][n] - start[k][n]).max() if of_update
                     else tupd.learning_rate)
            err = np.abs(got[k][n] - want[k][n]).max() / scale
            assert err <= limit, (k, n, err)


def test_a_clone_shares_nothing_with_its_source(lenet):
    _, _, start, x, y = lenet
    net = LeNet().init(device="cpu")
    net.params = params_from_numpy(start, "cpu")
    twin = net.clone()
    assert twin.summary() == net.summary()
    assert torch.equal(twin.output(x[:4]), net.output(x[:4]))
    ptrs = {t.data_ptr() for p in net.params.values() for t in p.values()}
    assert not ptrs & {t.data_ptr() for p in twin.params.values()
                       for t in p.values()}
    before = twin.output(x[:4])
    net.fit(DataSet(x, y), batch_size=8)
    assert torch.equal(twin.output(x[:4]), before)
    assert not torch.equal(net.output(x[:4]), before)


def test_graph_summary_equals_jax():
    kw = dict(vocab_size=16, embed_dim=16, n_heads=2, n_layers=1,
              max_length=8)
    assert TextGenerationTransformer(**kw).init(device="cpu").summary() == \
        JaxTFM(**kw).init().summary()


# ---------------------------------------------------------------------
# an RNN network through the inferred RNN -> feed-forward adapter
# ---------------------------------------------------------------------
def test_rnn_to_dense_network_equals_jax():
    def conf(pkg):
        L, B, IT = (jl, JBuilder, JInputType) if pkg == "jax" else \
            (tl, NeuralNetConfiguration, InputType)
        return (B.Builder().seed(5).weight_init("xavier").list()
                .layer(L.LSTM(n_out=6, activation="tanh"))
                .layer(L.DenseLayer(n_out=5, activation="tanh"))
                .layer(L.OutputLayer(n_out=3, loss="mse",
                                     activation="identity"))
                .set_input_type(IT.recurrent(4, 7)).build())
    jnet = JMultiLayerNetwork(conf("jax")).init()
    tnet = MultiLayerNetwork(conf("torch")).init(device="cpu")
    assert tnet.conf.to_dict() == jnet.conf.to_dict()
    assert isinstance(tnet.conf.preprocessors[1],
                      tp.RnnToFeedForwardPreProcessor)
    tnet.load_numpy_params(_np(jnet.params))
    x = np.random.default_rng(2).standard_normal((2, 4, 7)).astype(
        np.float32)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x)
    assert got.shape == want.shape == (14, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL)
    assert tnet.summary() == jnet.summary()
    with pytest.raises(NotImplementedError, match="A6"):
        tnet.output(x, mask=np.ones((2, 7), np.float32))
    with pytest.raises(NotImplementedError, match="A11"):
        tnet.pretrain(None)
