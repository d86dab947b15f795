"""Training in the port against the JAX package, in f32 unless stated:
the losses, the updaters and gradient normalization, the learned
positional table, and the transformer trained through
``ComputationGraph.fit`` with the JAX graph's parameters loaded.

Tolerances. Losses, updaters, normalization and the positional layer:
rtol 1e-5, atol 1e-6 (one f32 op sequence against another). Transformer
fit in f32: per-step score rtol 1e-5, parameters atol 1e-5 after each
of three Adam(3e-3) steps (both sides sum attention and the matmuls in
different orders; Adam moves every entry by up to lr whatever the
gradient's size, so an entry whose small gradient differs by 1e-3 of
itself moves up to 3e-6 apart per step; the attention key biases, whose
exact gradient is zero, are held to lr per step). Transformer fit in bf16: per-step score rtol 5e-3, and the
three steps' updates agree in sign where JAX moved a parameter by more
than a quarter of lr in 97% of the parameters (the JAX graph runs jitted
on the CPU, where XLA's fusions keep f32 between some bf16 ops, and its
whole-sequence attention takes the scan, which keeps p in f32; the port
rounds as the TPU kernels do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JaxDataSet
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.nn import updater as jax_updater
from deeplearning4j_tpu.nn.conf.layers import (
    PositionalEmbeddingLayer as JaxPos, RnnOutputLayer as JaxOut)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator, DataSet
from deeplearning4j_tpu_torch.nn import losses, updater
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresIterationListener, EvaluativeListener)
from deeplearning4j_tpu_torch.pipeline import DevicePrefetchIterator
from deeplearning4j_tpu_torch.nn.conf.layers import (
    PositionalEmbeddingLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.util.convert import (
    params_to_numpy, updater_state_to_numpy)
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
V, E, HEADS, LAYERS, T = 24, 32, 4, 2, 40


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------
def _loss_inputs(loss, n=6, c=5, seed=0):
    rng = np.random.default_rng(seed)
    pre = rng.normal(0, 1.5, (n, c)).astype(np.float32)
    if loss in ("mcxent", "negativeloglikelihood", "kl_divergence"):
        y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
        if loss == "kl_divergence":
            y = 0.8 * y + 0.04
    elif loss in ("xent", "binary_crossentropy"):
        y = rng.integers(0, 2, (n, c)).astype(np.float32)
    elif loss in ("hinge", "squared_hinge"):
        y = rng.choice([-1.0, 1.0], (n, c)).astype(np.float32)
    else:
        y = rng.normal(0, 1, (n, c)).astype(np.float32)
    if loss in ("poisson", "mean_squared_logarithmic_error"):
        pre = np.abs(pre) + 0.1
        y = np.abs(y)
    return y, pre


LOSS_CASES = [("mse", "identity"), ("l1", "identity"), ("l2", "identity"),
              ("xent", "sigmoid"), ("binary_crossentropy", "sigmoid"),
              ("mcxent", "softmax"), ("negativeloglikelihood", "softmax"),
              ("mcxent", "identity"), ("kl_divergence", "softmax"),
              ("hinge", "identity"), ("squared_hinge", "identity"),
              ("poisson", "identity"),
              ("mean_absolute_percentage_error", "identity"),
              ("mean_squared_logarithmic_error", "identity"),
              ("cosine_proximity", "identity")]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("loss,act", LOSS_CASES,
                         ids=[f"{l}-{a}" for l, a in LOSS_CASES])
def test_losses_match_jax(loss, act, masked):
    y, pre = _loss_inputs(loss)
    if loss == "mcxent" and act == "identity":
        pre = np.abs(pre) / np.abs(pre).sum(1, keepdims=True)
    mask = (np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None)

    def jf(p):
        return jax_losses.score(jnp.asarray(y), p, loss, act,
                                None if mask is None else jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jf)(jnp.asarray(pre))
    p = torch.tensor(pre, requires_grad=True)
    got = losses.score(torch.tensor(y), p, loss, act,
                       None if mask is None else torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), **TOL)


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get("nope")


def test_rnn_output_score_folds_time_into_batch():
    """RnnOutputLayer: preout [N, C, T] and a [N, T] mask folded to
    [N*T, C] and [N*T]."""
    rng = np.random.default_rng(1)
    n, c, t = 3, 4, 5
    pre = rng.normal(0, 1, (n, c, t)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, t))]
    y = y.transpose(0, 2, 1)
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    want = JaxOut(n_out=c).compute_score(jnp.asarray(y), jnp.asarray(pre),
                                         jnp.asarray(mask))
    got = RnnOutputLayer(n_out=c).compute_score(
        torch.tensor(y), torch.tensor(pre), torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------------
# updaters and gradient normalization
# ---------------------------------------------------------------------
def _trees(seed, steps=5):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"W": (3, 4), "b": (4,)}, "b": {"W": (2, 2)}}

    def draw(scale):
        return {v: {k: (rng.normal(0, scale, s)).astype(np.float32)
                    for k, s in p.items()} for v, p in shapes.items()}

    return draw(1.0), [draw(0.1) for _ in range(steps)]


def _to_torch(tree):
    return updater.tree_map(lambda a: torch.tensor(a), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("name,kw", [("Sgd", dict(learning_rate=0.05)),
                                     ("Adam", dict(learning_rate=3e-3)),
                                     ("Adam", dict(learning_rate=0.1,
                                                   beta1=0.8, beta2=0.99,
                                                   epsilon=1e-6))])
def test_updaters_match_jax_over_five_steps(name, kw):
    params, grads = _trees(2)
    ju = getattr(jax_updater, name)(**kw)
    tu = getattr(updater, name)(**kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for g in grads:
        jsteps, js = ju.update(_to_jax(g), js, jp)
        tsteps, ts = tu.update(_to_torch(g), ts, tp)
        jp = jax.tree_util.tree_map(lambda p, s: p - s, jp, jsteps)
        tp = updater.tree_map(lambda p, s: p - s, tp, tsteps)
        for v in params:
            for k in params[v]:
                np.testing.assert_allclose(tp[v][k].numpy(),
                                           np.asarray(jp[v][k]), **TOL)
    if name == "Adam":
        assert ts["t"] == int(js["t"]) == len(grads)
        for key in ("m", "v"):
            np.testing.assert_allclose(ts[key]["a"]["W"].numpy(),
                                       np.asarray(js[key]["a"]["W"]), **TOL)


@pytest.mark.parametrize("method", [
    None, "RenormalizeL2PerGradient", "renormalize_l2_per_param_type",
    "ClipElementWiseAbsoluteValue", "clip_l2_per_gradient",
    "ClipL2PerParamType"])
@pytest.mark.parametrize("threshold", [0.05, 10.0])
def test_normalize_gradients_matches_jax(method, threshold):
    _, (g,) = _trees(3, steps=1)
    want = jax_updater.normalize_gradients(_to_jax(g), method, threshold)
    got = updater.normalize_gradients(_to_torch(g), method, threshold)
    for v in g:
        for k in g[v]:
            np.testing.assert_allclose(got[v][k].numpy(),
                                       np.asarray(want[v][k]), **TOL)


def test_normalize_gradients_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        updater.normalize_gradients({"a": torch.ones(2)}, "nope")


@pytest.mark.parametrize("policy,kw", [
    (None, {}), ("exponential", dict(decay_rate=0.9)),
    ("inverse", dict(decay_rate=0.1, power=0.75)),
    ("poly", dict(power=2.0, max_iter=100)),
    ("sigmoid", dict(decay_rate=0.3, steps=10)),
    ("step", dict(decay_rate=0.5, steps=4))])
def test_schedule_lr_matches_jax(policy, kw):
    for it in (0, 1, 7, 33):
        np.testing.assert_allclose(
            updater.schedule_lr(0.1, policy, it, **kw),
            float(jax_updater.schedule_lr(0.1, policy, it, **kw)),
            rtol=1e-6)


# ---------------------------------------------------------------------
# the learned positional table
# ---------------------------------------------------------------------
def test_positional_embedding_matches_jax():
    rng = np.random.default_rng(4)
    f, L = 6, 16
    P = rng.normal(0, 0.02, (f, L)).astype(np.float32)
    x = rng.normal(0, 1, (2, f, 11)).astype(np.float32)
    jl, tl = JaxPos(max_length=L), PositionalEmbeddingLayer(max_length=L)
    want, _ = jl.apply({"P": jnp.asarray(P)}, jnp.asarray(x), {})
    got, _ = tl.apply({"P": torch.tensor(P)}, torch.tensor(x), {})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # chunked stream: each chunk at its absolute positions
    jstate, tstate = {}, {}
    for a, b in ((0, 4), (4, 5), (5, 11)):
        want, jstate = jl.apply({"P": jnp.asarray(P)},
                                jnp.asarray(x[:, :, a:b]), jstate,
                                stream=True)
        got, tstate = tl.apply({"P": torch.tensor(P)},
                               torch.tensor(x[:, :, a:b]), tstate,
                               stream=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tstate["pos_offset"] == int(jstate["pos_offset"]) == 11
    with pytest.raises(ValueError, match="max_length"):
        tl.apply({"P": torch.tensor(P)}, torch.zeros((1, f, L + 1)), {})


# ---------------------------------------------------------------------
# the transformer through fit
# ---------------------------------------------------------------------
def _one_hot_batch(seed, b):
    ids = np.random.default_rng(seed).integers(0, V, (b, T))
    x = np.zeros((b, V, T), np.float32)
    x[np.arange(b)[:, None], ids, np.arange(T)[None, :]] = 1.0
    return x, np.roll(x, -1, axis=2)


def _models(positional, lr=3e-3):
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=T, block_size=16, positional=positional)
    from deeplearning4j_tpu.nn.updater import Adam as JaxAdam
    jnet = JaxTFM(updater=JaxAdam(lr), **kw).init()
    rng = np.random.default_rng(7)
    # weights as initialised; biases, gammas and betas drawn away from
    # their constant init
    np_params = {v: {k: np.asarray(a, np.float32) if k in ("W", "Wq", "Wk",
                                                           "Wv", "Wo", "P")
                     else rng.normal(float(k == "gamma"), 0.2, a.shape)
                     .astype(np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tnet = TextGenerationTransformer(updater=updater.Adam(lr), **kw).init(
        device="cpu")
    tnet.load_numpy_params(np_params)
    return jnet, tnet


def _assert_params_close(tnet, jnet, steps=0, lr=3e-3, learned=False,
                         **tol):
    """Every parameter within ``tol``, except the attention key biases
    under learned positions: there their exact gradient is zero (a bias
    on every key of a query shifts all its scores alike, and softmax
    ignores the shift; rope rotates it by position, so there it has a
    real gradient and is compared like the rest). That zero is checked
    on both sides: the root of Adam's second moment of bk (the size of
    its gradients so far) stays under 1e-5 of the key weights'. Adam
    scales each side's round-off to a step of up to lr, so the bk values
    themselves are held to that bound."""
    got = params_to_numpy(tnet.params)
    for v, p in jnet.params.items():
        for k, a in p.items():
            if learned and k == "bk":
                for side in (jnet.updater_state["v"],
                             params_to_numpy(tnet.updater_state["v"])):
                    side = jax.tree_util.tree_map(np.asarray, side)
                    ratio = np.sqrt(side[v]["bk"].max() / side[v]["Wk"].max())
                    assert ratio < 1e-5, (v, ratio)
                np.testing.assert_allclose(got[v][k], np.asarray(a), rtol=0,
                                           atol=2 * lr * steps,
                                           err_msg=f"{v}.{k}")
                continue
            np.testing.assert_allclose(got[v][k], np.asarray(a),
                                       err_msg=f"{v}.{k}", **tol)


@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_fit_matches_jax_for_three_steps(positional):
    jnet, tnet = _models(positional)
    for step in range(3):
        x, y = _one_hot_batch(10 + step, 2)
        jnet.fit(x, y, batch_size=2)
        tnet.fit(x, y, batch_size=2)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        _assert_params_close(tnet, jnet, steps=step + 1,
                             learned=positional == "learned", atol=1e-5,
                             rtol=0)
    assert tnet.iteration_count == jnet.iteration_count == 3
    assert tnet.epoch_count == jnet.epoch_count == 3
    assert tnet.updater_state["t"] == int(jnet.updater_state["t"]) == 3
    # score() of a batch at the trained parameters
    x, y = _one_hot_batch(20, 2)
    np.testing.assert_allclose(tnet.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=1e-5)


def test_fit_in_bf16_tracks_jax():
    jnet, tnet = _models("learned")
    jnet.conf.dtype = tnet.conf.dtype = "bfloat16"
    start = params_to_numpy(tnet.params)
    for step in range(3):
        x, y = _one_hot_batch(30 + step, 2)
        jnet.fit(x, y, batch_size=2)
        tnet.fit(x, y, batch_size=2)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=5e-3)
    # the master weights stay f32 and moved by the gradient of the bf16
    # forward: compare the three steps' updates with JAX's
    got = params_to_numpy(tnet.params)
    agree = total = 0
    for v, p in jnet.params.items():
        for k, a in p.items():
            assert tnet.params[v][k].dtype == torch.float32
            dj = np.asarray(a) - start[v][k]
            dt = got[v][k] - start[v][k]
            big = np.abs(dj) > 0.25 * 3e-3
            agree += int((np.sign(dj[big]) == np.sign(dt[big])).sum())
            total += int(big.sum())
    assert total > 1000 and agree / total > 0.97, (agree, total)


def test_resume_a_jax_adam_state():
    """Two steps in JAX, its parameters and Adam state (m, v, t) carried
    into the port, the third step in both."""
    jnet, tnet = _models("rope")
    for step in range(2):
        x, y = _one_hot_batch(40 + step, 2)
        jnet.fit(x, y, batch_size=2)
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    tnet.load_numpy_updater_state(
        jax.tree_util.tree_map(np.asarray, jnet.updater_state))
    assert tnet.updater_state["t"] == 2
    x, y = _one_hot_batch(42, 2)
    jnet.fit(x, y, batch_size=2)
    tnet.fit(x, y, batch_size=2)
    np.testing.assert_allclose(tnet.score_value, jnet.score_value, rtol=1e-5)
    _assert_params_close(tnet, jnet, steps=3, atol=1e-5, rtol=0)
    back = updater_state_to_numpy(tnet.updater_state)
    assert back["t"].dtype == np.int32 and int(back["t"]) == 3
    with pytest.raises(ValueError, match="does not match"):
        tnet.load_numpy_updater_state({"m": {}, "v": {}, "t": 0})


def test_fit_batches_in_the_jax_order():
    """fit(x, y, batch_size) and a shuffled ArrayDataSetIterator give the
    JAX package's batches, pass by pass."""
    from deeplearning4j_tpu.datasets import (
        ArrayDataSetIterator as JaxIter)
    x = np.arange(7)[:, None].astype(np.float32)
    for shuffle in (False, True):
        ji = JaxIter(x, x, batch_size=3, shuffle=shuffle, seed=5)
        ti = ArrayDataSetIterator(x, x, batch_size=3, shuffle=shuffle,
                                  seed=5)
        for _ in range(2):
            want = [b.features[:, 0].tolist() for b in ji]
            got = [b.features[:, 0].tolist() for b in ti]
            assert got == want
        ji.restore_state({"epoch": 4, "pos": 1})
        ti.restore_state({"epoch": 4, "pos": 1})
        assert [b.features.tolist() for b in ti] == \
            [b.features.tolist() for b in ji]


def test_builder_cascades_regularization_and_normalization():
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .updater(updater.Sgd(0.5)).l2(1e-2).l1(1e-3)
            .gradient_normalization("ClipL2PerParamType", 0.5)
            .graph_builder().add_inputs("in")
            .set_input_types(InputType.recurrent(4, 6))
            .add_layer("out", RnnOutputLayer(n_out=4, l2=0.2), "in")
            .set_outputs("out").build())
    layer = conf.vertices["out"].layer
    assert (layer.l1, layer.l2) == (1e-3, 0.2)
    assert layer.l1_coeffs() == {"W": 1e-3, "RW": 1e-3}
    assert conf.updater == updater.Sgd(0.5)
    assert (conf.gradient_normalization,
            conf.gradient_normalization_threshold) == ("ClipL2PerParamType",
                                                       0.5)


def test_regularized_fit_matches_jax():
    """L1/L2 terms and gradient normalization inside fit, on a graph of
    the JAX builder and the port's builder spelled the same way."""
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JOut
    from deeplearning4j_tpu.nn.conf.network import (
        NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def build(nnc, it, out, upd):
        return (nnc.Builder().seed(3).updater(upd).l2(1e-2).l1(1e-3)
                .gradient_normalization("ClipL2PerGradient", 0.5)
                .graph_builder().add_inputs("in")
                .set_input_types(it.recurrent(V, 6))
                .add_layer("out", out(n_out=V), "in")
                .set_outputs("out").build())

    jnet = JCG(build(JNNC, JIT, JOut, jax_updater.Sgd(0.5))).init()
    tnet = ComputationGraph(build(NeuralNetConfiguration, InputType,
                                  RnnOutputLayer, updater.Sgd(0.5))).init(
        device="cpu")
    tnet.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.params))
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (4, V, 6)).astype(np.float32)
    y = np.eye(V, dtype=np.float32)[rng.integers(0, V, (4, 6))]
    y = y.transpose(0, 2, 1).copy()
    for _ in range(2):
        jnet.fit(x, y, batch_size=2)
        tnet.fit(x, y, batch_size=2)
        np.testing.assert_allclose(tnet.score_value, jnet.score_value,
                                   rtol=1e-5)
        _assert_params_close(tnet, jnet, lr=0.5, atol=1e-6, rtol=1e-5)


def test_fit_refuses_what_is_not_ported():
    tnet = TextGenerationTransformer(vocab_size=V, embed_dim=E,
                                     n_heads=HEADS, n_layers=1,
                                     max_length=T).init(device="cpu")
    x, y = _one_hot_batch(0, 2)
    # K-step dispatch, prefetch and listeners are ported
    # (tests/test_torch_fit_dispatch.py): each trains here; what stays
    # refused names its ROADMAP.md item
    for kw in (dict(steps_per_dispatch=2), dict(prefetch=2)):
        before = tnet.iteration_count
        tnet.fit(x, y, **kw)
        assert tnet.iteration_count == before + 1
    scores = CollectScoresIterationListener()
    assert tnet.add_listener(scores) is tnet
    tnet.fit(x, y)
    assert [i for i, _ in scores.scores] == [tnet.iteration_count - 1]
    # EvaluativeListener is ported (tests/test_torch_earlystopping.py)
    assert EvaluativeListener(None, frequency=0).frequency == 1
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y), mesh=object())
    # the sentinel is ported (tests/test_torch_sentinel.py): a policy it
    # does not know raises before any step
    trained = tnet.iteration_count
    tnet.nonfinite_policy = "skip-all"
    with pytest.raises(ValueError, match="nonfinite_policy must be one of"):
        tnet.fit(x, y)
    tnet.nonfinite_policy = None
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        tnet.fit(DataSet(x, y, features_mask=np.ones((2, T), np.float32)))
    assert tnet.iteration_count == trained
    # "auto" resolves: the transformer has no fusable chain (the xla plan)
    tnet.fit(x, y, execution_plan="auto")
    assert tnet.iteration_count == trained + 1 and \
        tnet.fusion_level is False


def test_the_engine_refuses_learned_positions():
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    tnet = TextGenerationTransformer(vocab_size=V, embed_dim=E,
                                     n_heads=HEADS, n_layers=1,
                                     max_length=T).init(device="cpu")
    with pytest.raises(ValueError, match="learned positional"):
        GenerationEngine(tnet, V, device="cpu")


def test_learned_positions_output_and_stream_match_jax():
    """A learned-position transformer's output() and its chunked
    rnn_time_step (pos_offset carried, a left-padded prime dropping its
    pads) against the JAX graph with the same parameters."""
    jnet, tnet = _models("learned")
    x, _ = _one_hot_batch(50, 2)
    np.testing.assert_allclose(tnet.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=2e-5,
                               rtol=1e-4)
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    for a, b in ((0, 7), (7, 8), (8, 19)):
        np.testing.assert_allclose(
            tnet.rnn_time_step(x[:, :, a:b]).numpy(),
            np.asarray(jnet.rnn_time_step(x[:, :, a:b])), atol=2e-5,
            rtol=1e-4)
    pad = 3
    xp = np.concatenate([np.zeros((1, V, pad), np.float32), x[:1, :, :6]],
                        axis=2)
    for net in (jnet, tnet):
        net.rnn_clear_previous_state()
    got = tnet.rnn_time_step(xp, pad_left=pad).numpy()
    want = np.asarray(jnet.rnn_time_step(xp, pad_left=pad))
    np.testing.assert_allclose(got[:, :, pad:], want[:, :, pad:], atol=2e-5,
                               rtol=1e-4)
    nxt = x[:1, :, 6:9]
    np.testing.assert_allclose(tnet.rnn_time_step(nxt).numpy(),
                               np.asarray(jnet.rnn_time_step(nxt)),
                               atol=2e-5, rtol=1e-4)
