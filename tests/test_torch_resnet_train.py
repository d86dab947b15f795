"""The port's ResNet50 training slice against the JAX package, on the CPU.

- ``BatchNormalization.apply(train=True)`` against the JAX layer, NCHW
  and NHWC, f32 and bf16: the output (f32 within 1e-5; bf16 equal but
  for 1-ulp flips) and the running statistics, f32 and detached, within
  1e-6, including JAX's bf16 rounding of ``decay * old`` (decay itself
  rounds to bf16 there; a PyTorch bf16 tensor times the Python float
  0.9 does not, and lands ~1e-3 away).
- ResNet50 at 64x64, 10 classes, B=4, f32, NHWC, ``Nesterovs(1e-7,
  0.9)``, with the JAX graph's parameters (BN gains and biases drawn
  away from 1 and 0), state and Nesterovs state carried across: two
  ``fit`` steps on the "xla" plan against the JAX ``fit(execution_plan=
  "xla")``, and two on the fused plan (the plain versions of the
  kernels on the CPU) against the port's own xla plan and, in
  ``tests/test_torch_resnet_train_fused.py``, against the JAX fused
  graph (its Pallas kernels in interpret mode). The learning
  rate keeps the steps where the loss falls about linearly: BN makes
  the loss scale-free in the small He-init conv weights, the gradient's
  norm is ~1.4e3, so one step at 1e-7 takes the loss from 3.22 to 2.96,
  while at 1e-5 it goes to 1.4 and both packages' runs part by a quarter
  of the update. Scores within 1e-3 relative (2.6e-4 measured at the
  second step). Parameters, BN state and the Nesterovs velocity by
  :func:`update_err`, leaf by leaf: each leaf's largest difference over
  that leaf's own change since the start, the change floored at 2^-16
  of the leaf's largest value (at this rate most BN gains move by one
  or two f32 ulps: rounding, not an update) and at 1e-2 of the largest
  change of any leaf. Its limits: this net is badly conditioned in f32
  (BN over 16 values per channel at s5, 53 layers): the port's own f32
  gradient lies 1.2% of the largest entry from its f64 gradient, and
  the worst leaves, the s5 convolutions' velocity at 1-4% of the
  largest change, read 0.162 between JAX's own xla and fused plans. So
  0.3 against the JAX graphs (0.162 measured), 0.2 between the port's
  plans (sums in other orders only, 0.080 measured), 1e-2 for the BN
  running statistics everywhere (a forward quantity: 1.3e-3 measured);
  every stage c backward without its relu' mask reads 76 against the
  port's xla plan, far outside the plans' limit.
- ``output(train=True)``: the batch-statistics forward, against the JAX
  graph's, leaving the state as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.updater import Nesterovs as JNesterovs
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
from deeplearning4j_tpu_torch.nn.updater import Nesterovs
from deeplearning4j_tpu_torch.util.convert import params_to_numpy
from deeplearning4j_tpu_torch.zoo import ResNet50
from test_torch_bottleneck import assert_bf16_flips
from test_torch_resnet import _draw
from torch_threads import one_thread  # noqa: F401 (autouse)

H = W = 64
CLASSES, B, LR, STEPS = 10, 4, 1e-7, 2
SCORE_RTOL = 1e-3
JAX_LIMIT = 0.3           # the port against the JAX graphs
PLANS_LIMIT = 0.2         # the port's fused plan against its xla plan
STATE_LIMIT = 1e-2        # the BN running statistics
#: update_err's floors of a leaf's change: of the leaf's largest value
#: (a change of a few f32 ulps is rounding) and of the largest change
ULP_FLOOR, REL_FLOOR = 2.0 ** -16, 1e-2


def _numpy(tree):
    """A tree of torch tensors or JAX arrays as f64 numpy arrays."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().double().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32), np.float64)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def update_err(got, want, base):
    """How far apart two trees are, leaf by leaf: the worst leaf's
    largest |got - want| over that leaf's own change max|want - base|
    since ``base``, the change floored at ULP_FLOOR of the leaf's
    largest |base| and at REL_FLOOR of the largest change of any
    leaf."""
    g, w, b = (dict(_leaves(t)) for t in (got, want, base))
    assert set(g) == set(w) == set(b)
    keys = [k for k in w if w[k].size]
    change = {k: float(np.abs(w[k] - b[k]).max()) for k in keys}
    top = max(change.values())
    return max(float(np.abs(g[k] - w[k]).max())
               / max(change[k], ULP_FLOOR * float(np.abs(b[k]).max()),
                     REL_FLOOR * top, 1e-30) for k in keys)


# ---------------------------------------------------------------------
# the BN layer
# ---------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_layer_trains_as_its_jax_twin(fmt, dtype):
    c = 32
    rng = np.random.default_rng(7)
    shape = (4, c, 6, 7) if fmt == "NCHW" else (4, 6, 7, c)
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = torch.from_numpy((rng.standard_normal(shape) * 2 + 1)
                         .astype(np.float32)).to(tdt)
    params = {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.normal(0, .3, c)}
    state = {"mean": rng.normal(0, 0.5, c), "var": rng.uniform(0.5, 2, c)}
    tp = {k: torch.from_numpy(a.astype(np.float32)) for k, a in params.items()}
    ts = {k: torch.from_numpy(a.astype(np.float32)) for k, a in state.items()}
    jp = {k: jnp.asarray(a, jnp.float32) for k, a in params.items()}
    js = {k: jnp.asarray(a, jnp.float32) for k, a in state.items()}
    tlayer = tl.BatchNormalization(data_format=fmt)
    jlayer = jl.BatchNormalization(data_format=fmt)
    xg = x.clone().requires_grad_()
    y, new = tlayer.apply(tp, xg, ts, train=True)
    jy, jnew = jlayer.apply(jp, jnp.asarray(x.float().numpy()).astype(jdt),
                            js, train=True)
    if dtype == "float32":
        np.testing.assert_allclose(_numpy(y), _numpy(jy), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert y.dtype == torch.bfloat16
        assert_bf16_flips(y.detach(), jy)
    for k in ("mean", "var"):
        assert new[k].dtype == torch.float32 and not new[k].requires_grad
        np.testing.assert_allclose(_numpy(new[k]), _numpy(jnew[k]),
                                   atol=1e-6, rtol=0)
    # inference leaves the state as it is
    assert tlayer.apply(tp, x, ts)[1] is ts
    if dtype == "bfloat16":
        # decay * old with the unrounded decay misses JAX's running mean
        axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
        naive = 0.9 * ts["mean"].to(tdt) + 0.1 * x.float().mean(axes)
        assert float(np.abs(_numpy(naive) - _numpy(jnew["mean"])).max()) \
            > 1e-4


# ---------------------------------------------------------------------
# ResNet50 at 64x64
# ---------------------------------------------------------------------
def _port_net(p0, s0, u0):
    net = ResNet50(num_classes=CLASSES, height=H, width=W,
                   updater=Nesterovs(LR, momentum=0.9),
                   data_format="NHWC").init(device="cpu")
    net.load_numpy_params(p0)
    net.load_numpy_state(s0)
    net.load_numpy_updater_state(u0)
    return net


def plan_name(plan):
    """A record's name for ``plan``: an execution plan by its name, the
    fusion level True as "fuse_true"."""
    return "fuse_true" if plan is True else plan


def _fit(net, x, y, plan):
    """STEPS fit steps on ``plan``: an execution plan ("xla", "fused"),
    resolved by each fit, or the fusion level True, set once; each
    step's score, parameters, state and updater state as numpy."""
    if plan is True:
        net.set_fusion(True)
    recs = []
    for _ in range(STEPS):
        net.fit(x, y, batch_size=B,
                execution_plan=None if plan is True else plan)
        recs.append({"score": float(net.score_value),
                     "params": _numpy(net.params),
                     "state": _numpy(net.state),
                     "updater": _numpy(net.updater_state)})
    return recs


def train_both(jax_plans, port_plans, jax_output_train=False):
    """The JAX ResNet50 and the port's, from the same parameters, state
    and Nesterovs state, each trained STEPS steps on each of its plans
    (records "jax_<plan>", "port_<plan>", named by :func:`plan_name`;
    a plan is an execution plan or the fusion level True); with
    ``jax_output_train`` also the JAX graph's ``output(train=True)`` at
    the start."""
    jnet = JResNet50(num_classes=CLASSES, height=H, width=W,
                     updater=JNesterovs(LR, momentum=0.9),
                     data_format="NHWC").init()
    rng = np.random.default_rng(0)
    p0 = {v: _draw(p, rng) for v, p in jnet.params.items()}
    s0 = jax.tree_util.tree_map(np.asarray, jnet.state)
    u0 = jax.tree_util.tree_map(np.asarray, jnet.updater_state)
    x = rng.standard_normal((B, 3, H, W)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, B)]
    out = {"base": {"params": _numpy(p0), "state": _numpy(s0),
                    "updater": _numpy(u0)}, "x": x, "y": y,
           "trees": (p0, s0, u0)}
    for plan in jax_plans:
        jnet.params = jax.tree_util.tree_map(jnp.asarray, p0)
        jnet.state = jax.tree_util.tree_map(jnp.asarray, s0)
        jnet.updater_state = jax.tree_util.tree_map(jnp.asarray, u0)
        out["jax_" + plan_name(plan)] = _fit(jnet, x, y, plan)
    for plan in port_plans:
        out["port_" + plan_name(plan)] = _fit(_port_net(p0, s0, u0), x, y,
                                              plan)
    if jax_output_train:
        jnet.params = jax.tree_util.tree_map(jnp.asarray, p0)
        jnet.state = jax.tree_util.tree_map(jnp.asarray, s0)
        out["jax_output_train"] = np.asarray(jnet.output(x, train=True))
    return out


@pytest.fixture(scope="module")
def runs():
    """The JAX graph on the xla plan, the port on both plans (the fused
    plan against the JAX fused graph: test_torch_resnet_train_fused.py,
    so that each file's JAX compiles stay within its time)."""
    return train_both(("xla",), ("xla", "fused"), jax_output_train=True)


def check(runs, got, want, limit):
    base = runs["base"]
    for step, (g, w) in enumerate(zip(runs[got], runs[want])):
        np.testing.assert_allclose(g["score"], w["score"], rtol=SCORE_RTOL,
                                   err_msg=f"step {step}")
        for key in ("params", "state", "updater"):
            err = update_err(g[key], w[key], base[key])
            assert err < (STATE_LIMIT if key == "state" else limit), \
                (step, key, err)


def test_xla_plan_trains_as_the_jax_graph(runs):
    check(runs, "port_xla", "jax_xla", JAX_LIMIT)
    # the steps moved the parameters and the running statistics
    base = runs["base"]
    assert update_err(base["params"], runs["port_xla"][-1]["params"],
                      base["params"]) == pytest.approx(1.0)
    assert runs["port_xla"][0]["score"] != runs["port_xla"][1]["score"]


def test_fused_plan_trains_as_the_xla_plan(runs):
    check(runs, "port_fused", "port_xla", PLANS_LIMIT)


def test_a_backward_stage_without_its_mask_fails_the_limit(runs,
                                                           monkeypatch):
    """Stage c's backward (the one relu 1x1 stage of each block) without
    its relu' mask, through the fused plan, is far outside PLANS_LIMIT."""
    plain = tb.conv1x1_bwd_plain

    def no_mask(yk, g, yprev, w, aff_k, aff_p, *, act_prev, stride=1):
        dz, dw, sums = plain(yk, g, yprev, w, aff_k, aff_p,
                             act_prev="identity", stride=stride)
        if act_prev == "relu":
            ref = plain(yk, g, yprev, w, aff_k, aff_p, act_prev=act_prev,
                        stride=stride)
            sums = ref[2]
        return dz, dw, sums

    monkeypatch.setattr(tb, "conv1x1_bwd_plain", no_mask)
    recs = _fit(_port_net(*runs["trees"]), runs["x"], runs["y"], "fused")
    err = update_err(recs[0]["updater"], runs["port_xla"][0]["updater"],
                     runs["base"]["updater"])
    assert err > 5 * PLANS_LIMIT


def test_the_nesterovs_state_carries_across(runs):
    p0, _, u0 = runs["trees"]
    net = _port_net(*runs["trees"])
    # the velocity tree holds every parameter, the BN gains and biases too
    v = params_to_numpy(net.updater_state["v"])
    assert set(v["s2b0_a_bn"]) == {"gamma", "beta"}
    assert {k: {n: a.shape for n, a in p.items()} for k, p in v.items()} \
        == {k: {n: a.shape for n, a in p.items()} for k, p in p0.items()}
    np.testing.assert_array_equal(v["s2b0_a_bn"]["gamma"],
                                  u0["v"]["s2b0_a_bn"]["gamma"])
    assert isinstance(net.conf.updater, Nesterovs)
    assert isinstance(ResNet50().conf().updater, Nesterovs)
    assert ResNet50().conf().updater.learning_rate == 0.1


def test_output_train_uses_batch_statistics(runs):
    net = _port_net(*runs["trees"])
    state = net.state
    got = net.output(runs["x"], train=True)
    np.testing.assert_allclose(_numpy(got), runs["jax_output_train"],
                               atol=1e-4, rtol=1e-3)
    assert net.state is state
    assert not np.allclose(_numpy(net.output(runs["x"])), _numpy(got),
                           atol=1e-3)
