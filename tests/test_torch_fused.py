"""The port's fused bn -> act -> 1x1 conv (deeplearning4j_tpu_torch/nn/
layers/fused.py) and the level-True plan against the JAX package, on the
CPU.

- ``bn_act_conv1x1`` (NHWC: its ``FusedMatmul`` over the plain kernels)
  against the JAX ``bn_act_conv1x1(use_pallas=True, interpret=True)``,
  its Pallas kernels in interpret mode, forward and ``jax.vjp`` (seeded
  cotangents on the output and, in training, on the running
  statistics): relu and identity, training and inference, and the tails
  M = 18 and M = 147 that no row block divides. f32: the output within
  1e-5 (atol and rtol), the gradients of x, gamma, beta, w and b within
  atol 3e-5, rtol 1e-4 (the JAX package's own limits for its kernel
  against its XLA formulation; 2.3e-5 read). bf16 (the same rounding
  points, sums in other orders): the output, dx and dw equal but for
  1-ulp flips in under 1% of the elements, the f32 gradients of gamma,
  beta and b within 1e-5 of their largest entry (bit-equal read at
  these sizes).
- The bf16 running statistics equal the port's own ``batch_norm``'s
  bitwise on the same input (the unfused layer's precision chain), and
  the JAX op's within one f32 ulp (its batch term sums in another
  order).
- The level-True matcher on the JAX test graphs (``tests/test_fused.py``):
  the chain, a BN with two consumers, a 3x3 conv, the BN's own
  activation; the JAX matcher's plans.
- The small bottleneck graph with ``set_fusion(True)``: ``output()``
  equal to the port's unfused graph and the JAX fused graph within 1e-5,
  NCHW and NHWC; three ``fit`` steps against the JAX fused graph within
  ``tests/test_fused.py``'s limits (score 1e-6, parameters atol 2e-5 /
  rtol 1e-4, BN state 1e-5); inference then reads the running
  statistics.
- The wrappers take the plain versions for CPU tensors and launch
  nothing; the gate refuses an activation outside relu and identity and
  f64 off the CPU.
- The bf16 backward on the tensor cores (``csrc/conv_bwd_tc.cuh``'s
  fused mode): its plan (``_bwd_tc_plan``, the bottleneck's 1x1 plan
  over M one-pixel images) covers every row, every dW split's chunks and
  every (channel, column) tile once at 1 and 132 SMs for the four
  stages' groups and the tail; ``bwd_route`` sends bf16 to the tensor
  cores and f32 to the CUDA cores; a torch mirror of its order (128-row
  dz blocks summing the f32 dz into per-block partials, dW and db over
  the plan's splits merged in f64) against the JAX ``_pallas_bwd`` in
  interpret mode within TC_ROW / TC_TILE (dy, dW) and TC_SUMS (the
  sums), with the sums over the bf16-rounded dz outside TC_SUMS.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.graph_conf import ElementWiseVertex as JEW
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.fused import bn_act_conv1x1 as jfused
from deeplearning4j_tpu.nn.updater import Sgd as JSgd
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.graph_conf import ElementWiseVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import fused as tf
from deeplearning4j_tpu_torch.nn.layers import normalization as tn
from deeplearning4j_tpu_torch.nn.updater import Sgd
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy)
from test_torch_bottleneck import assert_bf16_flips
from torch_threads import one_thread  # noqa: F401 (autouse)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
#: (N, H, W, C, O): the JAX kernel test's shape (M = 32) and two tails
SHAPES = {"m32": (2, 4, 4, 16, 24), "m18": (1, 3, 6, 8, 8),
          "m147": (3, 7, 7, 16, 24)}


# ---------------------------------------------------------------------
# the op against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------
def _op_inputs(shape, seed):
    n, h, w, c, o = shape
    rng = np.random.default_rng(seed)

    def f32(a):
        return np.asarray(a, np.float32)

    return {"x": f32(rng.standard_normal((n, h, w, c)) * 1.5 + 0.3),
            "gamma": f32(rng.standard_normal(c) * 0.3 + 1.0),
            "beta": f32(rng.standard_normal(c) * 0.2),
            "rm": f32(rng.standard_normal(c) * 0.1),
            "rv": f32(np.abs(rng.standard_normal(c)) + 0.4),
            "w": f32(rng.standard_normal((o, c, 1, 1)) * 0.2),
            "b": f32(rng.standard_normal(o) * 0.1),
            "go": f32(rng.standard_normal((n, h, w, o))),
            "gm": f32(rng.standard_normal(c)),
            "gv": f32(rng.standard_normal(c))}


def _run_both(a, dtype, act, train):
    """(port outputs and gradients, JAX outputs and gradients) as f32
    numpy: the outputs (out, new mean, new var) and the gradients of
    (x, gamma, beta, w, b) for the seeded cotangents."""
    tdt, jdt = DTYPES[dtype]
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("x", "w", "go"):
        t[k] = t[k].to(tdt)
    j = {k: jnp.asarray(v.float().numpy() if torch.is_tensor(v) else v)
         for k, v in t.items()}
    for k in ("x", "w", "go"):
        j[k] = j[k].astype(jdt)
    ins = [t[k].clone().requires_grad_()
           for k in ("x", "gamma", "beta", "w", "b")]
    outs = tf.bn_act_conv1x1(ins[0], ins[1], ins[2], t["rm"], t["rv"],
                             ins[3], ins[4], train=train, act=act,
                             data_format="NHWC")
    cot = (t["go"], t["gm"], t["gv"]) if train else (t["go"],)
    grads = torch.autograd.grad(outs[:len(cot)], ins, cot)

    def f(x, gamma, beta, w, b):
        return jfused(x, gamma, beta, j["rm"], j["rv"], w, b, train=train,
                      act=act, data_format="NHWC", use_pallas=True,
                      interpret=True)

    jouts, vjp = jax.vjp(f, *(j[k] for k in ("x", "gamma", "beta", "w",
                                             "b")))
    jcot = (j["go"], j["gm"], j["gv"]) if train else (
        j["go"], jnp.zeros_like(jouts[1]), jnp.zeros_like(jouts[2]))
    jgrads = vjp(jcot)

    def np32(v):
        return (v.detach().float().numpy() if torch.is_tensor(v)
                else np.asarray(jnp.asarray(v, jnp.float32)))

    return ([np32(v) for v in (*outs, *grads)],
            [np32(v) for v in (*jouts, *jgrads)], outs, grads)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("act", ["relu", "identity"])
def test_f32_op_matches_the_pallas_kernels(act, train):
    got, want, outs, _ = _run_both(_op_inputs(SHAPES["m32"], 1), "f32", act,
                                   train)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1:3], want[1:3], atol=1e-6, rtol=0)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "db"), got[3:],
                          want[3:]):
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=1e-4,
                                   err_msg=name)
    assert outs[1].dtype == torch.float32
    assert outs[1].requires_grad == train


@pytest.mark.parametrize("shape", ["m18", "m147"])
def test_tail_rows_enter_no_sum(shape):
    """M that no row block divides: the Pallas kernel masks its garbage
    tail rows out of every sum; the plain versions hold only M rows."""
    got, want, _, _ = _run_both(_op_inputs(SHAPES[shape], 2), "f32", "relu",
                                True)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "db"), got[3:],
                          want[3:]):
        np.testing.assert_allclose(g, w, atol=3e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("act,train", [("relu", True), ("identity", False)])
def test_bf16_op_matches_the_pallas_kernels(act, train):
    got, want, outs, grads = _run_both(_op_inputs(SHAPES["m147"], 3),
                                       "bf16", act, train)
    assert outs[0].dtype == grads[0].dtype == grads[3].dtype == \
        torch.bfloat16
    for i in (0, 3, 6):                      # out, dx, dw
        assert_bf16_flips(torch.from_numpy(got[i]), want[i])
    for i in (4, 5, 7):                      # dgamma, dbeta, db (f32)
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=1e-5 * np.abs(want[i]).max())


def test_bf16_running_stats_quantize_like_the_unfused_layer():
    """The fused op's running statistics go through the unfused
    BatchNormalization's precision chain (the running statistics
    rounded through bf16 before the decay, the decay itself rounded):
    bitwise the port's ``batch_norm``'s, and the JAX op's within one f32
    ulp: the decayed term rounds alike, the batch term sums in another
    order (one flip read)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4))
                         .astype(np.float32)).to(torch.bfloat16)
    gamma, beta, rm, rv = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal(4) * 0.1 + 1, rng.standard_normal(4) * 0.1,
        rng.standard_normal(4) * 0.01, rng.standard_normal(4) * 0.01 + 1))
    w = torch.from_numpy(rng.standard_normal((3, 4, 1, 1))
                         .astype(np.float32)).to(torch.bfloat16)
    _, fm, fv = tf.bn_act_conv1x1(x, gamma, beta, rm, rv, w, None,
                                  train=True, data_format="NHWC")
    _, um, uv = tn.batch_norm(x, gamma.to(x.dtype), beta.to(x.dtype),
                              rm.to(x.dtype), rv.to(x.dtype), True,
                              channel_axis=3)
    assert fm.dtype == fv.dtype == torch.float32
    assert torch.equal(fm, um.float()) and torch.equal(fv, uv.float())
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _, jm, jv = jfused(jx, jnp.asarray(gamma.numpy()),
                       jnp.asarray(beta.numpy()), jnp.asarray(rm.numpy()),
                       jnp.asarray(rv.numpy()),
                       jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                       None, train=True, data_format="NHWC")
    for got, want in ((fm, jm), (fv, jv)):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want)
                      <= np.spacing(np.abs(want)))


# ---------------------------------------------------------------------
# the level-True plan on the JAX test graphs
# ---------------------------------------------------------------------
def _graph(pkg, fmt, case="bottleneck"):
    """The graphs of tests/test_fused.py built by either package
    (``pkg`` "jax" or "torch"): the conv -> bn -> relu -> 1x1 bottleneck
    with its residual add, and the matcher's three refusal cases."""
    if pkg == "jax":
        L, NNC, EW, IT, sgd = jl, JNNC, JEW, JIT, JSgd(0.05)
    else:
        L, NNC, EW, IT, sgd = tl, NeuralNetConfiguration, \
            ElementWiseVertex, InputType, Sgd(0.05)
    g = (NNC.Builder().seed(3).updater(sgd).graph_builder()
         .add_inputs("in").set_input_types(IT.convolutional(8, 8, 4)))
    head = "c2"
    if case == "bottleneck":
        g.add_layer("c1", L.ConvolutionLayer(
            n_out=4, kernel=(3, 3), padding=(1, 1), activation="identity",
            has_bias=False), "in")
        g.add_layer("bn1", L.BatchNormalization(), "c1")
        g.add_layer("act1", L.ActivationLayer(activation="relu"), "bn1")
        g.add_layer("c2", L.ConvolutionLayer(
            n_out=4, kernel=(1, 1), activation="identity", has_bias=False),
            "act1")
        g.add_layer("bn2", L.BatchNormalization(), "c2")
        g.add_vertex("skip", EW(op="add"), "bn2", "c1")
        head = "skip"
    else:
        g.add_layer("c1", L.ConvolutionLayer(
            n_out=8, kernel=(1, 1), activation="identity"), "in")
        g.add_layer("bn1", L.BatchNormalization(activation="relu"), "c1")
        if case == "multi_consumer":
            g.add_layer("c2", L.ConvolutionLayer(
                n_out=8, kernel=(1, 1), activation="identity"), "bn1")
            g.add_vertex("add", EW(op="add"), "c2", "bn1")
            head = "add"
        elif case == "conv3x3":
            g.add_layer("c2", L.ConvolutionLayer(
                n_out=8, kernel=(3, 3), padding=(1, 1)), "bn1")
        else:                                   # the BN's own activation
            g.add_layer("c2", L.ConvolutionLayer(n_out=8, kernel=(1, 1)),
                        "bn1")
    g.add_layer("pool", L.GlobalPoolingLayer(pooling_type="avg"), head)
    g.add_layer("out", L.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax"), "pool")
    conf = g.set_outputs("out").build()
    if fmt != "NCHW":
        conf.use_cnn_data_format(fmt)
    if pkg == "jax":
        return JGraph(conf).init()
    return ComputationGraph(conf).init(device="cpu")


@pytest.mark.parametrize("case,plan,skip", [
    ("bottleneck", {"c2": ("bn1", "relu", "c1")}, {"bn1", "act1"}),
    ("multi_consumer", {}, set()),
    ("conv3x3", {}, set()),
    ("bn_activation", {"c2": ("bn1", "relu", "c1")}, {"bn1"})])
def test_the_matcher_plans_as_the_jax_graph(case, plan, skip):
    tnet = _graph("torch", "NCHW", case).set_fusion(True)
    jnet = _graph("jax", "NCHW", case).set_fusion(True)
    jplan, jskip, _ = jnet._fusion()
    assert tnet._conv_plan() == jplan == plan
    assert set(tnet._fusion()[0]) == set(jskip) == skip
    assert tnet._fusion()[1:] == ({}, {})
    # the other levels carry no level-True groups
    assert tnet.set_fusion("bottleneck")._conv_plan() == {}
    assert tnet.set_fusion(False)._conv_plan() == {}


def _data(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 4, 8, 8)).astype(np.float32)
    y = np.zeros((4, 3), np.float32)
    y[np.arange(4), rng.integers(0, 3, 4)] = 1.0
    return x, y, rng.standard_normal((2, 4, 8, 8)).astype(np.float32)


def _carried(fmt):
    """The JAX bottleneck graph on the fused plan and two port graphs
    (fused, unfused) holding its parameters, BN gains drawn away from 1
    and 0."""
    jnet = _graph("jax", fmt).set_fusion(True)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(np.asarray, jnet.params)
    for bn in ("bn1", "bn2"):
        params[bn] = {"gamma": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                      "beta": rng.normal(0, 0.2, 4).astype(np.float32)}
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    nets = [_graph("torch", fmt).load_numpy_params(params)
            for _ in range(2)]
    return jnet, nets[0].set_fusion(True), nets[1]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_output_matches_unfused_and_the_jax_fused_graph(fmt):
    jnet, fused, unfused = _carried(fmt)
    x = _data()[0]
    got = fused.output(x).numpy()
    np.testing.assert_allclose(got, unfused.output(x).numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_fit_matches_the_jax_fused_graph(fmt):
    """Three fit steps on the fused plan, from the same parameters:
    score, parameters and BN state as the JAX fused graph's; then the
    inference forward reads the running statistics."""
    jnet, fused, unfused = _carried(fmt)
    x, y, x2 = _data()
    for _ in range(3):
        fused.fit(DataSet(x, y))
        unfused.fit(DataSet(x, y))
        jnet.fit(JDataSet(x, y))
    assert np.isclose(fused.score_value, float(jnet.score_value), atol=1e-6)
    tp, jp = params_to_numpy(fused.params), jax.tree_util.tree_map(
        np.asarray, jnet.params)
    for v in jp:
        for k in jp[v]:
            np.testing.assert_allclose(tp[v][k], jp[v][k], atol=2e-5,
                                       rtol=1e-4, err_msg=f"{v}.{k}")
    ts = state_to_numpy(fused.state)
    for name in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(ts[name][k],
                                       np.asarray(jnet.state[name][k]),
                                       atol=1e-5, err_msg=f"{name}.{k}")
    # the steps moved the running statistics away from the init's
    assert not np.allclose(ts["bn1"]["var"], 1.0)
    # inference reads them: as the unfused graph trained alike, and JAX
    np.testing.assert_allclose(fused.output(x2).numpy(),
                               unfused.output(x2).numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(fused.output(x2).numpy(),
                               np.asarray(jnet.output(x2)), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------
# the wrappers and the gate
# ---------------------------------------------------------------------
def test_the_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(4)
    y2 = torch.from_numpy(rng.standard_normal((147, 16))
                          .astype(np.float32)).to(torch.bfloat16)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    bb = torch.from_numpy(rng.normal(0, 0.5, 16).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((16, 24))
                          .astype(np.float32)).to(torch.bfloat16)
    b = torch.zeros(24)
    g = torch.from_numpy(rng.standard_normal((147, 24))
                         .astype(np.float32)).to(torch.bfloat16)
    before = (tf.FUSED_FWD.launches, tf.FUSED_BWD.launches)
    out = tf.fused_matmul(y2, sc, bb, w2, b, "relu")
    assert torch.equal(out, tf.fused_matmul_plain(y2, sc, bb, w2, b,
                                                  "relu"))
    got = tf.fused_matmul_bwd(y2, sc, bb, w2, g, "relu")
    want = tf.fused_matmul_bwd_plain(y2, sc, bb, w2, g, "relu")
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.float32]
    assert (tf.FUSED_FWD.launches, tf.FUSED_BWD.launches) == before
    # the gate: relu or identity, f32 or bf16, any C and K
    assert tf.fused_conv1x1_supported("relu", "bfloat16")
    assert tf.fused_conv1x1_supported("identity", torch.float32)
    assert not tf.fused_conv1x1_supported("gelu", torch.float32)
    assert not tf.fused_conv1x1_supported("relu", torch.float64)
    with pytest.raises(ValueError, match="relu or identity"):
        tf.fused_matmul(y2, sc, bb, w2, b, "gelu")
    with pytest.raises(ValueError, match="relu or identity"):
        tf.bn_act_conv1x1(y2.reshape(1, 3, 49, 16), sc, bb, sc, sc,
                          w2.t().reshape(24, 16, 1, 1), None, train=True,
                          act="gelu", data_format="NHWC")
    with pytest.raises(ValueError, match="not \\(16,\\)"):
        tf.fused_matmul(y2, sc[:8], bb, w2, b, "relu")
    # f64 off the CPU is refused before any launch
    meta = {k: t.to("meta", torch.float64) for k, t in
            (("y2", y2), ("w2", w2), ("g", g))}
    with pytest.raises(ValueError, match="f32 or bf16"):
        tf.fused_matmul(meta["y2"], sc.to("meta"), bb.to("meta"),
                        meta["w2"], b.to("meta"), "relu")
    with pytest.raises(ValueError, match="f32 or bf16"):
        tf.fused_matmul_bwd(meta["y2"], sc.to("meta"), bb.to("meta"),
                            meta["w2"], meta["g"], "relu")
    assert (tf.FUSED_FWD.launches, tf.FUSED_BWD.launches) == before


# ---------------------------------------------------------------------
# the bf16 forward's launch plan (host side): the bottleneck's 1x1 rule
# ---------------------------------------------------------------------
#: the four stages' groups at B = 128 (M = 128 H W, C, K) and the tail
FUSED_FWD_PLANS = [(128 * 56 * 56, 64, 256), (128 * 28 * 28, 128, 512),
                   (128 * 14 * 14, 256, 1024), (128 * 7 * 7, 512, 2048),
                   (147, 512, 2048)]


@pytest.mark.parametrize("m, c, k", FUSED_FWD_PLANS)
def test_the_forward_plan_is_the_bottleneck_1x1_rule(m, c, k):
    """The fused forward runs the bottleneck's bf16 1x1 kernel over M
    images of one pixel: its plan is ``_fwd_tc_plan``'s stride-1 1x1
    plan of that image, 128-row blocks, 64 or 128 output channels a
    block, and the grid rows of ``_fwd_rows`` (fewest rounds of row
    blocks over the card's blocks), each walking every row block once."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
    sms = 132
    plan = tf._fwd_plan(m, k, sms)
    assert plan == tb._fwd_tc_plan(m, 1, 1, k, 1, 1, sms)
    assert plan.blocks == -(-m // 128) and plan.patch is None
    channels, per_sm = (64, 2) if k <= 64 else (128, 1)
    assert plan.channels == channels
    assert plan.tiles == tb._fwd_rows(plan.blocks, -(-k // channels),
                                      per_sm * sms)
    walked = np.zeros(plan.blocks, np.int64)
    for q in range(plan.tiles):
        walked[q::plan.tiles] += 1
    assert (walked == 1).all()


# ---------------------------------------------------------------------
# the bf16 backward on the tensor cores: its plan, its route, and a
# mirror of its order against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------
#: the four stages' groups at B = 128 and the tail (M, C, K)
FUSED_BWD_PLANS = FUSED_FWD_PLANS


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("m, c, k", FUSED_BWD_PLANS)
def test_the_backward_plan_covers_every_row_and_tile_once(m, c, k, sms):
    """``_bwd_tc_plan`` is the bottleneck's stride-1 1x1 plan over M
    one-pixel images: ``tiles`` 128-row dz blocks cover every row once
    (the sums' partials a channel); the dW pass's 64-row chunks, ``chunk``
    a split, cover every row once with no empty split; its (channel,
    column) tiles, as the kernel's launcher picks them, cover every
    entry of dW once; its partials ``[splits, C + 1, K]`` hold row C for
    db."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
    plan = tf._bwd_tc_plan(m, c, k, sms)
    assert plan == tb._bwd_tc_plan(m, 1, 1, c, k, 1, 1, sms)
    rows = np.zeros(m, np.int64)
    for blk in range(plan.tiles):
        rows[128 * blk:128 * (blk + 1)] += 1
    assert (rows == 1).all() and 128 * (plan.tiles - 1) < m
    chunks = -(-m // 64)
    seen = np.zeros(m, np.int64)
    for s in range(plan.splits):
        first, last = s * plan.chunk, min((s + 1) * plan.chunk, chunks)
        assert first < last, "an empty split"
        seen[64 * first:64 * last] += 1
    assert (seen == 1).all()
    br = 64 if c <= 64 else 128
    bn = 64 if k <= 64 else 128 if (k <= 128 or c > 64) else 256
    cover = np.zeros((c, k), np.int64)
    for i in range(-(-c // br)):
        for j in range(-(-k // bn)):
            cover[br * i:br * (i + 1), bn * j:bn * (j + 1)] += 1
    assert (cover == 1).all()
    part = torch.empty((plan.splits, c + 1, k), device="meta")
    assert part.shape[1] == c + 1 and part.numel() < 2 ** 31 - 1


def test_the_backward_route_is_the_tensor_cores_for_bf16():
    assert tf.bwd_route(torch.bfloat16) == tf.TENSOR_CORES
    assert tf.bwd_route(torch.float32) == tf.CUDA_CORES
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tf.bwd_route(torch.float16)


def _tc_bwd_mirror(y2, sc, bb, w2, g, act, plan, fault=None):
    """The bf16 tensor-core backward's order as plain torch: dz per
    128-row block in f32 (the tensor cores' products of bf16 operands
    are exact), masked by relu'(z0) on the unrounded z0, dy = dz sc
    rounded once, the block's sums dz y and dz of the f32 dz into
    per-block partials summed in f64; dW and db per split of the plan's
    64-row chunks in f32 (db the split's column sums of g, row C of the
    partials), the splits summed in f64, dW rounded to w2's dtype.
    ``fault="rounded_dz_sums"`` sums the bf16-rounded dz instead."""
    m, c = y2.shape
    k = w2.shape[1]
    yf, gf, wf = y2.float(), g.float(), w2.float()
    z0 = yf * sc + bb
    dy = torch.empty_like(y2)
    p1 = torch.zeros((plan.tiles, c))
    p2 = torch.zeros((plan.tiles, c))
    for blk in range(plan.tiles):
        r = slice(128 * blk, min(128 * (blk + 1), m))
        dz = gf[r] @ wf.t()
        if act == "relu":
            dz = torch.where(z0[r] > 0, dz, 0.0)
        dy[r] = (dz * sc).to(y2.dtype)
        terms = dz.to(y2.dtype).float() if fault == "rounded_dz_sums" else dz
        p1[blk] = (terms * yf[r]).sum(0)
        p2[blk] = terms.sum(0)
    z = (torch.clamp_min(z0, 0.0) if act == "relu" else z0).to(g.dtype)
    parts = torch.zeros((plan.splits, c + 1, k))
    for s in range(plan.splits):
        r = slice(64 * plan.chunk * s, min(64 * plan.chunk * (s + 1), m))
        parts[s, :c] = z[r].float().t() @ gf[r]
        parts[s, c] = gf[r].sum(0)
    tot = parts.double().sum(0).float()
    return (dy, p1.double().sum(0).float(), p2.double().sum(0).float(),
            tot[:c].to(w2.dtype), tot[c])


def _agreement(x, ref):
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    k = ref.shape[-1]
    return fa.agreement(x.float().reshape(1, 1, -1, k),
                        ref.float().reshape(1, 1, -1, k))


#: (M, C, K, act): tails past the 128-row dz blocks and the 64-row dW
#: chunks, C = 64 and a width that is not a multiple of 8, small K; M =
#: 1573 splits its dW pass four ways at 132 SMs
TC_BWD_CASES = [(147, 64, 40, "relu"), (147, 20, 24, "identity"),
                (1573, 20, 24, "relu"), (1573, 64, 40, "identity")]
#: the limits: dy and dW per row (one row's largest error over its
#: largest |ref|) 2^-6 and per 64-row tile 1e-4 (one bf16 ulp flips
#: where the f32 sums' order moves a rounding); the sums within 1e-6 of
#: each channel's sum of |terms| (f32 sums in another order)
TC_ROW, TC_TILE, TC_SUMS = 2 ** -6, 1e-4, 1e-6


def _tc_bwd_inputs(m, c, k, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 0.3, c)
    std = rng.uniform(0.5, 1.5, c)
    y = mean + std * rng.standard_normal((m, c))
    sc = rng.uniform(0.5, 1.5, c) / std
    bb = rng.normal(0, 0.2, c) - mean * sc
    w = rng.standard_normal((c, k)) * (2.0 / c) ** 0.5
    g = rng.standard_normal((m, k))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(y), f32(sc), f32(bb), f32(w), f32(g)


@pytest.mark.parametrize("m, c, k, act", TC_BWD_CASES)
def test_the_tensor_core_backward_order_matches_the_pallas_kernel(
        m, c, k, act):
    """The mirror of the bf16 tensor-core backward's order (its plan at
    132 SMs) against the JAX ``_pallas_bwd`` in interpret mode on the same
    bf16 inputs: dy and dW within TC_ROW a row and TC_TILE a 64-row tile,
    dsc, dbb and db within TC_SUMS of each channel's sum of |terms|; the
    sums over the bf16-rounded dz (the planted fault) fall outside."""
    from deeplearning4j_tpu.nn.layers.fused import _pallas_bwd
    y, sc, bb, w, g = _tc_bwd_inputs(m, c, k, seed=m + c)
    bf = torch.bfloat16
    ty, tw, tg = (torch.from_numpy(a).to(bf) for a in (y, w, g))
    tsc, tbb = torch.from_numpy(sc), torch.from_numpy(bb)
    plan = tf._bwd_tc_plan(m, c, k, 132)
    got = _tc_bwd_mirror(ty, tsc, tbb, tw, tg, act, plan)
    jy, jw, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (ty, tw, tg))
    want = [torch.from_numpy(np.array(jnp.asarray(v, jnp.float32)))
            for v in _pallas_bwd(jy, jnp.asarray(sc), jnp.asarray(bb), jw,
                                 jg, act, 128, True)]
    for name, i in (("dy", 0), ("dw", 3)):
        row, tile = _agreement(got[i], want[i])
        assert row <= TC_ROW and tile <= TC_TILE, (name, row, tile)
    yf, gf = ty.float(), tg.float()
    z0 = yf * tsc + tbb
    dz = gf @ tw.float().t()
    if act == "relu":
        dz = torch.where(z0 > 0, dz, 0.0)
    terms = {1: (dz * yf).abs().sum(0), 2: dz.abs().sum(0),
             4: gf.abs().sum(0)}

    def sums_rel(a):
        return max(float(((a[i] - want[i]).abs() / t).max())
                   for i, t in terms.items())

    assert sums_rel(got) <= TC_SUMS
    bad = _tc_bwd_mirror(ty, tsc, tbb, tw, tg, act, plan, "rounded_dz_sums")
    assert sums_rel(bad) > TC_SUMS
