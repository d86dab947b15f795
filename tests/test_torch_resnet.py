"""The port's ResNet50 inference slice against the JAX package, on the
CPU.

- Each CNN layer the slice adds (convolution, batch norm, activation,
  max/avg pooling, zero padding, global pooling) against its JAX twin,
  in NCHW and NHWC; dense and output layers, the two CNN preprocessors,
  ``batch_norm`` in both modes, the "relu" init and one ``Nesterovs``
  step. f32, within 1e-5 (1e-6 for the updater).
- ResNet50 at 64x64, 10 classes, batch 2, f32, NHWC, with the JAX
  graph's parameters (BN gains and biases drawn away from 1 and 0) and
  non-trivial BN running statistics (each BN's batch statistics over 8
  seeded images, then scaled) carried across: the "xla" plan against
  the JAX unfused ``output()``, and the fused plan with the stem
  (``set_fusion("bottleneck", stem=True)``: the plain versions of the
  kernels on the CPU) against the JAX fused graph, whose Pallas kernels
  run in interpret mode. Probabilities within 1e-5 (the f32 sums of 53
  layers, taken in other orders).
- The fused plan matches the same vertex groups as the JAX matchers (16
  bottleneck blocks and the stem) and skips the same vertices; with
  ``only=`` two named blocks, as the JAX graph does.
- The refusals: ``fit(steps_per_dispatch>1)`` (``fuse=True`` and fusion
  level True build and plan their 16 groups, ``fuse="bottleneck"`` the
  bottleneck level); ``execution_plan="auto"`` on an uncalibrated store
  resolves to the xla plan (in the zoo, ``apply_execution_plan`` and
  ``fit``), and ``fit`` and ``output(train=True)`` run with the stem
  kernels engaged (training is ``tests/test_torch_resnet_train.py`` and
  ``test_torch_resnet_train_stem.py``); the default device is the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import preprocessors as jp
from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu.nn.layers import normalization as jn
from deeplearning4j_tpu.nn.updater import Nesterovs as JNesterovs
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import normalization as tn
from deeplearning4j_tpu_torch.nn.updater import Nesterovs
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.tuning import apply_execution_plan
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, state_to_numpy)
from deeplearning4j_tpu_torch.zoo import ResNet50
from torch_threads import one_thread  # noqa: F401 (autouse)

H = W = 64
CLASSES = 10

LAYER_CASES = {
    "conv3x3_s2_p1_bias": ("ConvolutionLayer",
                           dict(n_out=6, kernel=(3, 3), stride=(2, 2),
                                padding=(1, 1))),
    "conv1x1_relu_nobias": ("ConvolutionLayer",
                            dict(n_out=5, kernel=(1, 1), has_bias=False,
                                 activation="relu")),
    "conv7x7_s2": ("ConvolutionLayer",
                   dict(n_out=4, kernel=(7, 7), stride=(2, 2),
                        has_bias=False)),
    "batch_norm": ("BatchNormalization", {}),
    "relu": ("ActivationLayer", dict(activation="relu")),
    "maxpool3x3_s2_p1": ("SubsamplingLayer",
                         dict(pooling_type="max", kernel=(3, 3),
                              stride=(2, 2), padding=(1, 1))),
    "avgpool2x2": ("SubsamplingLayer",
                   dict(pooling_type="avg", kernel=(2, 2), stride=(2, 2))),
    "zero_pad": ("ZeroPaddingLayer", dict(padding=(1, 2, 3, 0))),
    "global_avg": ("GlobalPoolingLayer", dict(pooling_type="avg")),
    "global_max": ("GlobalPoolingLayer", dict(pooling_type="max")),
}


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _draw(tree, rng):
    """Draw every non-weight leaf away from its constant init: biases and
    betas N(0, 0.2), gammas U(0.5, 1.5)."""
    out = {}
    for k, a in tree.items():
        a = np.array(a, np.float32)
        if k == "gamma":
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif k in ("b", "beta"):
            a = rng.normal(0, 0.2, a.shape).astype(np.float32)
        out[k] = a
    return out


def _layer_pair(case, fmt, it_t, it_j, seed):
    cls, kw = LAYER_CASES[case]
    kw = dict(kw)
    if cls not in ("ActivationLayer",):
        kw["data_format"] = fmt
    jlayer = getattr(jl, cls)(**kw)
    tlayer = getattr(tl, cls)(**kw)
    jp_, js_ = jlayer.init(jax.random.PRNGKey(seed), it_j)
    rng = np.random.default_rng(seed)
    params = _draw(jp_, rng)
    state = {k: np.asarray(a, np.float32) for k, a in js_.items()}
    if state:                                   # BN running statistics
        state = {"mean": rng.normal(0, 0.5, state["mean"].shape),
                 "var": rng.uniform(0.5, 2.0, state["var"].shape)}
        state = {k: a.astype(np.float32) for k, a in state.items()}
    tp_, ts_ = tlayer.init(torch.Generator().manual_seed(seed), it_t, "cpu")
    assert {k: tuple(a.shape) for k, a in tp_.items()} == \
        {k: a.shape for k, a in params.items()}
    assert set(ts_) == set(state)
    return ((jlayer, {k: jnp.asarray(a) for k, a in params.items()},
             {k: jnp.asarray(a) for k, a in state.items()}),
            (tlayer, {k: torch.from_numpy(a) for k, a in params.items()},
             {k: torch.from_numpy(a) for k, a in state.items()}))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_cnn_layer_matches_its_jax_twin(case, fmt):
    c, h, w = 4, 11, 10
    (jlayer, jparams, jstate), (tlayer, tparams, tstate) = _layer_pair(
        case, fmt, InputType.convolutional(h, w, c),
        JIT.convolutional(h, w, c), seed=len(case))
    x = np.random.default_rng(5).standard_normal((2, c, h, w)) \
        .astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    want, _ = jlayer.apply(jparams, jnp.asarray(x), jstate, train=False)
    got, new_state = tlayer.apply(tparams, torch.from_numpy(x), tstate)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert new_state is tstate
    jt = jlayer.output_type(JIT.convolutional(h, w, c))
    tt = tlayer.output_type(InputType.convolutional(h, w, c))
    assert (tt.kind, tt.size, tt.channels, tt.height, tt.width) == \
        (jt.kind, jt.size, jt.channels, jt.height, jt.width)


@pytest.mark.parametrize("cls", ["DenseLayer", "OutputLayer"])
def test_dense_and_output_layers_match_jax(cls):
    kw = dict(n_out=7, activation="softmax" if cls == "OutputLayer"
              else "relu")
    jlayer, tlayer = getattr(jl, cls)(**kw), getattr(tl, cls)(**kw)
    jp_, _ = jlayer.init(jax.random.PRNGKey(0), JIT.feed_forward(12))
    tp_, _ = tlayer.init(torch.Generator().manual_seed(0),
                         InputType.feed_forward(12), "cpu")
    params = _draw(jp_, np.random.default_rng(1))
    assert {k: tuple(v.shape) for k, v in tp_.items()} == \
        {k: v.shape for k, v in params.items()}
    x = np.random.default_rng(2).standard_normal((3, 12)).astype(np.float32)
    want, _ = jlayer.apply({k: jnp.asarray(a) for k, a in params.items()},
                           jnp.asarray(x), {})
    got, _ = tlayer.apply({k: torch.from_numpy(a) for k, a in params.items()},
                          torch.from_numpy(x), {})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    if cls == "OutputLayer":
        y = np.eye(7, dtype=np.float32)[[0, 3, 6]]
        pre = x @ params["W"] + params["b"]
        np.testing.assert_allclose(
            float(tlayer.compute_score(torch.from_numpy(y),
                                       torch.from_numpy(pre))),
            float(jlayer.compute_score(jnp.asarray(y), jnp.asarray(pre))),
            rtol=1e-6)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_cnn_preprocessors_match_jax(fmt):
    x = np.random.default_rng(3).standard_normal((2, 3 * 5 * 4)) \
        .astype(np.float32)
    kw = dict(height=5, width=4, channels=3, data_format=fmt)
    to_cnn = tp.FeedForwardToCnnPreProcessor(**kw).apply(torch.from_numpy(x))
    want = jp.FeedForwardToCnnPreProcessor(**kw).apply(jnp.asarray(x))
    np.testing.assert_array_equal(_np(to_cnn), np.asarray(want))
    back = tp.CnnToFeedForwardPreProcessor(**kw).apply(to_cnn)
    np.testing.assert_array_equal(_np(back), x)
    np.testing.assert_array_equal(
        _np(back), np.asarray(jp.CnnToFeedForwardPreProcessor(**kw)
                              .apply(want)))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_matches_jax(axis, train):
    rng = np.random.default_rng(axis)
    x = rng.standard_normal((4, 5, 6, 3) if axis == 3 else (4, 3, 5, 6)) \
        .astype(np.float32) * 2 + 1
    g, b = rng.uniform(0.5, 1.5, 3), rng.normal(0, 0.3, 3)
    m, v = rng.normal(0, 0.5, 3), rng.uniform(0.5, 2, 3)
    args = [a.astype(np.float32) for a in (x, g, b, m, v)]
    got = tn.batch_norm(*map(torch.from_numpy, args), train, 1e-5, 0.9,
                        channel_axis=axis)
    want = jn.batch_norm(*map(jnp.asarray, args), train, 1e-5, 0.9,
                         channel_axis=axis)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b_), atol=1e-5,
                                   rtol=1e-5)


def test_relu_init_is_he_normal():
    w = init_weights(torch.Generator().manual_seed(0), (256, 64, 3, 3),
                     64 * 9, 256 * 9, "relu", "cpu")
    assert abs(float(w.std()) / np.sqrt(2 / (64 * 9)) - 1) < 0.01
    # the other schemes are ported (tests/test_torch_numerics.py); a name
    # the JAX package does not know raises as there
    with pytest.raises(ValueError, match="Unknown weight init"):
        init_weights(torch.Generator(), (2, 2), 2, 2, "he_normal", "cpu")


def test_nesterovs_step_matches_jax():
    rng = np.random.default_rng(4)
    tree = {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": {"gamma": rng.standard_normal(5).astype(np.float32)}}
    grads = {v: {k: rng.standard_normal(a.shape).astype(np.float32)
                 for k, a in p.items()} for v, p in tree.items()}
    vel = {v: {k: rng.standard_normal(a.shape).astype(np.float32)
               for k, a in p.items()} for v, p in tree.items()}

    def conv(t, f):
        return {v: {k: f(a) for k, a in p.items()} for v, p in t.items()}

    tu, ju = Nesterovs(0.05, momentum=0.8), JNesterovs(0.05, momentum=0.8)
    assert set(tu.init_state(conv(tree, torch.from_numpy))) == {"v"}
    steps, st = tu.update(conv(grads, torch.from_numpy),
                          {"v": conv(vel, torch.from_numpy)},
                          conv(tree, torch.from_numpy))
    jsteps, jst = ju.update(conv(grads, jnp.asarray),
                            {"v": conv(vel, jnp.asarray)},
                            conv(tree, jnp.asarray))
    for v, p in tree.items():
        for k in p:
            np.testing.assert_allclose(_np(steps[v][k]),
                                       np.asarray(jsteps[v][k]), atol=1e-6)
            np.testing.assert_allclose(_np(st["v"][v][k]),
                                       np.asarray(jst["v"][v][k]),
                                       atol=1e-6)


# ---------------------------------------------------------------------
# ResNet50 at 64x64
# ---------------------------------------------------------------------
def calibrate_bn(net, x):
    """Set every BN's running statistics to the batch statistics its
    input has over ``x`` (one unfused f32 pass, vertex by vertex), then
    scale them, so the inference forward neither explodes nor meets the
    init's zeros and ones."""
    rng = np.random.default_rng(11)
    acts = {"input": torch.from_numpy(x)}
    for name in net._topo:
        v = net.conf.vertices[name]
        xs = [acts[i] for i in net.conf.vertex_inputs[name]]
        if isinstance(getattr(v, "layer", None), tl.BatchNormalization):
            dims = (0, 1, 2) if v.layer.data_format == "NHWC" else (0, 2, 3)
            c = xs[0].shape[3 if dims == (0, 1, 2) else 1]
            net.state[name] = {
                "mean": xs[0].mean(dims) + torch.from_numpy(
                    rng.normal(0, 0.05, c).astype(np.float32)),
                "var": xs[0].var(dims, unbiased=False) * torch.from_numpy(
                    rng.uniform(0.8, 1.25, c).astype(np.float32))}
        acts[name], _ = v.apply(net.params[name], xs, net.state[name])


@pytest.fixture(scope="module")
def nets():
    """The JAX ResNet50 and the port's, NHWC, with the same parameters
    and BN state; and the seeded batch they are compared on."""
    jnet = JResNet50(num_classes=CLASSES, height=H, width=W,
                     data_format="NHWC").init()
    rng = np.random.default_rng(0)
    np_params = {v: _draw(p, rng) for v, p in jnet.params.items()}
    tnet = ResNet50(num_classes=CLASSES, height=H, width=W,
                    data_format="NHWC").init(device="cpu")
    tnet.load_numpy_params(np_params)
    x = rng.standard_normal((8, 3, H, W)).astype(np.float32)
    calibrate_bn(tnet, x)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray,
                                        state_to_numpy(tnet.state))
    # the JAX graph's state, carried back across, is the one compared
    tnet.load_numpy_state(jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, tnet, x[:2]


def _plans(jnet, tnet, level, stem):
    jnet.set_fusion(level, stem=stem)
    tnet.set_fusion(level, stem=stem)


def test_xla_plan_matches_the_jax_unfused_graph(nets):
    jnet, tnet, x = nets
    _plans(jnet, tnet, False, False)
    got, want = tnet.output(x), np.asarray(jnet.output(x))
    assert tuple(got.shape) == (2, CLASSES) and got.dtype == torch.float32
    # not the init's BN statistics, and not saturated
    assert not np.allclose(tnet.state["s3b1_b_bn"]["var"].numpy(), 1.0)
    assert float(got.max()) < 0.9
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-4)


def test_fused_plan_with_the_stem_matches_the_jax_fused_graph(nets):
    jnet, tnet, x = nets
    _plans(jnet, tnet, "bottleneck", True)
    assert len(jnet._fusion()[2]) == 16 and jnet._stem_plan()
    got, want = tnet.output(x), np.asarray(jnet.output(x))
    np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-4)
    # the 52 bottleneck convs' and the stem's kernel-layout weights are
    # made once, and made anew for a new parameter tree
    layouts = dict(tnet._layouts)
    assert len(layouts) == 53
    tnet.output(x)
    assert all(tnet._layouts[k][1] is v[1] for k, v in layouts.items())
    tnet.load_numpy_params(params_to_numpy(tnet.params))
    np.testing.assert_array_equal(_np(tnet.output(x)), _np(got))
    assert not any(tnet._layouts[k][1] is v[1] for k, v in layouts.items())
    _plans(jnet, tnet, False, False)
    np.testing.assert_allclose(_np(got), _np(tnet.output(x)), atol=1e-5,
                               rtol=1e-4)


def test_only_fuses_the_named_blocks_as_the_jax_graph_does(nets,
                                                          monkeypatch):
    """``set_fusion("bottleneck", only=...)``: an identity and a
    downsample block fused, the other 14 unfused; the same groups and
    output as the JAX graph, and the plain versions (the kernels' stand-ins
    on the CPU) called once per fused conv."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
    from deeplearning4j_tpu_torch.nn.layers import stem as ts
    jnet, tnet, x = nets
    only = {"s3b1_out", "s4b0_out"}
    jnet.set_fusion("bottleneck", only=only)
    tnet.set_fusion("bottleneck", only=only)
    skip, bplan, splan = tnet._fusion()
    _, jskip, jbplan = jnet._fusion()
    assert set(bplan) == only and bplan == jbplan and skip == jskip
    assert not splan
    calls = {"conv1x1": 0, "conv3x3": 0, "stem_conv": 0}

    def counted(mod, name):
        fn = getattr(mod, name + "_plain")

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name + "_plain", wrapper)

    for mod, name in ((tb, "conv1x1"), (tb, "conv3x3"), (ts, "stem_conv")):
        counted(mod, name)
    got = tnet.output(x)
    # s3b1: conv_a, conv_c; s4b0: conv_a, conv_c and the shortcut
    assert calls == {"conv1x1": 5, "conv3x3": 2, "stem_conv": 0}
    np.testing.assert_allclose(_np(got), np.asarray(jnet.output(x)),
                               atol=1e-5, rtol=1e-4)
    _plans(jnet, tnet, False, False)


def test_the_matchers_find_the_jax_packages_groups(nets):
    jnet, tnet, _ = nets
    _plans(jnet, tnet, "bottleneck", True)
    _, jskip, jbplan = jnet._fusion()
    skip, bplan, splan = tnet._fusion()
    assert len(bplan) == 16 and list(splan) == ["stem_pool"]
    assert bplan == jbplan
    assert splan == jnet._stem_plan()
    assert splan["stem_pool"]["pre_vertex"] == "stem_pad"
    assert skip == jskip
    strides = {n: g["stride"] for n, g in bplan.items() if "conv_skip" in g}
    assert strides == {"s2b0_out": 1, "s3b0_out": 2, "s4b0_out": 2,
                       "s5b0_out": 2}
    bc, sc = tnet.fusion_candidates()
    jbc, jsc = jnet.fusion_candidates()
    assert bc == jbc and sc == jsc
    _plans(jnet, tnet, False, False)


def test_the_entry_point_selects_the_fused_plan():
    net = ResNet50(num_classes=CLASSES, height=32, width=32,
                   data_format="NHWC", execution_plan="fused") \
        .init(device="cpu")
    assert net.fusion_level == "bottleneck" and not net._fuse_stem
    assert len(net._fusion()[1]) == 16 and not net._fusion()[2]
    from deeplearning4j_tpu_torch.tuning import KernelCrossoverStore
    # the record names each consulted candidate's key and choice: under
    # "fused" the stem's, off on an uncalibrated store
    rec = apply_execution_plan(
        net, "fused", store=KernelCrossoverStore(path="/nonexistent/none"))
    assert rec == {"plan": "fused", "level": "bottleneck", "blocks": 16,
                   "stem": False, "keys": {"stem_pool": {
                       "key": "train_stem|cin=3,cout=64,h=32,w=32|f32",
                       "choice": "fallback"}}}
    net.set_fusion("bottleneck", stem=True)
    assert list(net._fusion()[2]) == ["stem_pool"]
    assert apply_execution_plan(net, "xla")["level"] is False
    assert net.fusion_level is False and not net._fusion()[1]
    # NCHW: the matchers engage nothing
    nchw = ResNet50(num_classes=CLASSES, height=32, width=32,
                    execution_plan="fused").init(device="cpu")
    assert nchw.fusion_level is False
    nchw.set_fusion("bottleneck", stem=True)
    assert nchw._fusion() == ({}, {}, {})
    # a bf16 net runs the same plan (the gates take bf16 too)
    net.conf.dtype = "bfloat16"
    net.set_fusion("bottleneck", stem=True)
    assert len(net._fusion()[1]) == 16 and net._fusion()[2]
    out = net.output(np.zeros((1, 3, 32, 32), np.float32))
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, CLASSES)


def test_what_is_not_ported_is_refused(tmp_path, monkeypatch):
    from deeplearning4j_tpu_torch.tuning import (
        KernelCrossoverStore, crossover)
    monkeypatch.setattr(crossover, "_default_store", KernelCrossoverStore(
        path=str(tmp_path / crossover.CROSSOVER_NAME)))
    net = ResNet50(num_classes=CLASSES, height=32, width=32,
                   data_format="NHWC").init(device="cpu")
    # "auto" on an uncalibrated store: the xla plan
    assert apply_execution_plan(net, "auto")["level"] is False
    assert ResNet50(num_classes=CLASSES, height=32, width=32,
                    data_format="NHWC", execution_plan="auto"
                    ).init(device="cpu").fusion_level is False
    # fuse=True and fusion level True build and plan the JAX package's 16
    # bn -> act -> 1x1-conv groups (tests/test_torch_resnet_fuse_true.py)
    assert sorted(ResNet50(num_classes=CLASSES, height=32, width=32,
                           data_format="NHWC", fuse=True)
                  .init(device="cpu")._conv_plan()) == sorted(
        f"s{s}b{i}_c_conv" for s, n in ((2, 3), (3, 4), (4, 6), (5, 3))
        for i in range(n))
    assert len(net.set_fusion(True)._conv_plan()) == 16
    with pytest.raises(ValueError, match="stem=True"):
        net.set_fusion(False, stem=True)
    x = np.random.default_rng(1).standard_normal((2, 3, 32, 32)) \
        .astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[[0, 1]]
    # K-step dispatch is ported (tests/test_torch_fit_dispatch.py): the
    # two one-image batches run as one group of two steps
    net.fit(x, y, batch_size=1, steps_per_dispatch=2)
    assert net.iteration_count == 2 and \
        net.fit_dispatch["eager_group_steps"] == 2
    assert np.isfinite(net.score_value)
    net.set_fusion("bottleneck", stem=True)
    assert net.output(x, train=True).shape == (2, CLASSES)
    # the stem kernels' plan trains; "auto" then resolves to the xla plan
    net.fit(x, y)
    assert net.iteration_count == 3 and np.isfinite(net.score_value)
    net.fit(x, y, execution_plan="auto")
    assert net.iteration_count == 4 and net.fusion_level is False
    # the fused plan (the stem off on an uncalibrated store) trains
    net.fit(x, y, execution_plan="fused")
    assert net.iteration_count == 5 and np.isfinite(net.score_value)
    assert net.fusion_level == "bottleneck" and not net._fusion()[2]
    with pytest.raises(ValueError, match="state tree"):
        net.load_numpy_state({"stem_bn": {"mean": np.zeros(3, np.float32)}})
    # the zoo's fuse="bottleneck" is the bottleneck level
    assert len(ResNet50(num_classes=CLASSES, height=32, width=32,
                        data_format="NHWC", fuse="bottleneck")
               .init(device="cpu")._fusion()[1]) == 16


@pytest.mark.parametrize("site", ["batch_norm", "bottleneck_stats"])
def test_batch_stats_overflow_as_the_jax_package(site):
    """Training's batch statistics take ``E[x^2] - mean^2`` in f32, as the
    JAX package's do (``batch_norm``; the fused bottleneck's
    ``_finalize_stats`` over the kernels' sums): once |x| passes about
    1.8e19 the square overflows and that channel's variance is NaN in
    both packages, the same channels. The previous test's fits diverge,
    and which step reaches that range depends on the f32 summation
    order: on two torch threads its fifth step's stage-4 conv output
    passes it and the loss is NaN, in the port and in the JAX package
    from the same trees (ROADMAP §C)."""
    x = np.array([[0.5, 4.88e19, 1e18, -2.0],
                  [1.5, 4.0e19, 3e18, 2.0]], np.float32)
    if site == "batch_norm":
        c = x.shape[1]
        ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
        _, _, got = tn.batch_norm(*(torch.from_numpy(a) for a in
                                    (x, ones, zeros, zeros, ones)),
                                  train=True)
        _, _, want = jn.batch_norm(*(jnp.asarray(a) for a in
                                     (x, ones, zeros, zeros, ones)),
                                   train=True)
    else:
        from deeplearning4j_tpu.nn.layers import bottleneck as jb
        from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
        s1, s2 = tb._stats(torch.from_numpy(x))
        _, got = tb._finalize_stats(s1, s2, x.shape[0])
        xj = jnp.asarray(x)
        _, want = jb._finalize_stats(xj.sum(0), (xj * xj).sum(0),
                                     x.shape[0])
    got, want = got.numpy(), np.asarray(want)
    assert np.isnan(got).tolist() == np.isnan(want).tolist() == \
        [False, True, False, False]
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=1e-6)


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(num_classes=CLASSES, height=32, width=32,
                 data_format="NHWC", execution_plan="fused").init()


def test_params_and_state_round_trip(nets):
    _, tnet, _ = nets
    p, s = params_to_numpy(tnet.params), state_to_numpy(tnet.state)
    assert set(s["stem_bn"]) == {"mean", "var"} and s["stem_pool"] == {}
    assert p["s2b0_a_conv"]["W"].shape == (64, 64, 1, 1)
    assert p["stem_conv"]["W"].shape == (64, 3, 7, 7)


def test_layer_options_not_ported_are_refused():
    x = torch.zeros((1, 2, 8, 8))
    same = tl.ConvolutionLayer(n_out=3, kernel=(3, 3),
                               convolution_mode="same")
    p, _ = same.init(torch.Generator(), InputType.convolutional(8, 8, 2),
                     "cpu")
    # ConvolutionMode "same" is ported (tests/test_torch_lenet.py holds
    # it against the JAX package's XLA padding)
    y, _ = same.apply(p, x, {})
    assert tuple(y.shape) == (1, 3, 8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A11"):
        tl.SubsamplingLayer(pooling_type="pnorm").apply({}, x, {})
    got, _ = tl.SubsamplingLayer(pooling_type="sum").apply({}, x + 1, {})
    assert float(got.max()) == 4.0
