"""The port's numerics core (deeplearning4j_tpu_torch/nn/activations.py,
weights.py, updater.py) against the JAX package's, on the CPU.

- Every activation of the JAX package (and the parameterized forms):
  f32 values and gradients (``jax.grad`` of the sum against a seeded
  cotangent) within 1e-6 on standard normal inputs; bf16 values bit
  for bit against the JAX function run op by op (``jax.disable_jit``:
  each op rounds to bf16).
- Every weight init: the shape; ``zero``, ``ones``, ``identity`` and
  ``distribution`` / ``constant`` exact; the random ones at 256 x 256 by
  their moments against the JAX package's formula for the same fans (a
  uniform's bounds and standard deviation, a normal's standard
  deviation, a truncated normal's cut at two standard deviations), and
  the binomial distribution's mean.
- Each updater the port took over in this slice (AdaMax, Nadam, AdaGrad,
  AdaDelta, NoOp) over 5 steps from the same parameters and gradients
  against the JAX updater, parameters and every state leaf within 1e-6,
  the state's keys the JAX package's; its JSON and its state through
  ``updater_to_dict`` / ``updater_from_dict`` and the numpy trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import activations as jact
from deeplearning4j_tpu.nn import updater as jupd
from deeplearning4j_tpu.nn import weights as jw
from deeplearning4j_tpu_torch.nn import activations as tact
from deeplearning4j_tpu_torch.nn import updater as tupd
from deeplearning4j_tpu_torch.nn.weights import WEIGHT_INITS, init_weights
from deeplearning4j_tpu_torch.util.convert import (
    updater_state_from_numpy, updater_state_to_numpy)
from torch_threads import one_thread  # noqa: F401 (autouse)

NAMES = sorted(jact.ACTIVATIONS) + ["leakyrelu(0.3)", "thresholdedrelu(0.5)"]


def _x(seed=0, shape=(16, 24)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 3).astype(np.float32)


def test_the_port_has_every_activation_and_init():
    assert set(tact.ACTIVATIONS) == set(jact.ACTIVATIONS)
    assert WEIGHT_INITS == jw.WEIGHT_INITS


@pytest.mark.parametrize("name", NAMES)
def test_activation_f32_value_and_gradient(name):
    # standard normal inputs: XLA's f32 tanh is an approximation a few
    # ulps off, and gelu's gradient multiplies that error by x
    x = _x(1) / 3
    ct = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jf, tf = jact.get(name), tact.get(name)
    want = np.asarray(jf(jnp.asarray(x)))
    jgrad = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * ct))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = tf(xt)
    (got * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_activation_bf16_op_by_op(name):
    x = _x(3)
    with jax.disable_jit():
        want = np.asarray(jact.get(name)(jnp.asarray(x, jnp.bfloat16))
                          .astype(jnp.float32))
    got = tact.get(name)(torch.tensor(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_register_and_unknown_names():
    tact.register("Twice", lambda x: 2 * x)
    assert torch.equal(tact.get("twice")(torch.ones(2)), torch.full((2,), 2.))
    del tact.ACTIVATIONS["twice"]
    for bad in ("nope", "nope(0.2)"):
        with pytest.raises(ValueError, match="Unknown activation"):
            tact.get(bad)


# ---------------------------------------------------------------------
# weight inits
# ---------------------------------------------------------------------
FAN_IN, FAN_OUT = 256.0, 512.0
#: scheme -> (kind, the JAX formula's scale: a uniform's bound, a
#: normal's standard deviation, a truncated normal's pre-cut deviation)
RANDOM = {
    "uniform": ("uniform", 1.0 / np.sqrt(FAN_IN)),
    "sigmoid_uniform": ("uniform", 4.0 * np.sqrt(6.0 / (FAN_IN + FAN_OUT))),
    "xavier": ("normal", np.sqrt(2.0 / (FAN_IN + FAN_OUT))),
    "xavier_uniform": ("uniform", np.sqrt(6.0 / (FAN_IN + FAN_OUT))),
    "xavier_fan_in": ("normal", 1.0 / np.sqrt(FAN_IN)),
    "xavier_legacy": ("normal", np.sqrt(1.0 / (FAN_IN + FAN_OUT))),
    "relu": ("normal", np.sqrt(2.0 / FAN_IN)),
    "relu_uniform": ("uniform", np.sqrt(6.0 / FAN_IN)),
    "lecun_normal": ("normal", 1.0 / np.sqrt(FAN_IN)),
    "lecun_uniform": ("uniform", 3.0 / np.sqrt(FAN_IN)),
    "normal": ("normal", 1.0 / np.sqrt(FAN_IN)),
    "truncated_normal": ("truncated", 1.0 / np.sqrt(FAN_IN)),
    "var_scaling_normal_fan_in": ("truncated", np.sqrt(1.0 / FAN_IN)),
    "var_scaling_normal_fan_out": ("truncated", np.sqrt(1.0 / FAN_OUT)),
    "var_scaling_normal_fan_avg": ("truncated",
                                   np.sqrt(2.0 / (FAN_IN + FAN_OUT))),
    "var_scaling_uniform_fan_in": ("uniform", np.sqrt(3.0 / FAN_IN)),
    "var_scaling_uniform_fan_out": ("uniform", np.sqrt(3.0 / FAN_OUT)),
    "var_scaling_uniform_fan_avg": ("uniform",
                                    np.sqrt(6.0 / (FAN_IN + FAN_OUT))),
}
#: the standard deviation of a standard normal cut at +-2
TRUNC_STD = 0.8796256610342398


def _init(scheme, shape=(256, 256), dist=None, seed=0):
    return init_weights(torch.Generator().manual_seed(seed), shape, FAN_IN,
                        FAN_OUT, scheme, "cpu", dist)


@pytest.mark.parametrize("scheme", sorted(RANDOM))
def test_random_init_moments(scheme):
    kind, scale = RANDOM[scheme]
    w = _init(scheme).double()
    jwant = np.asarray(jw.init_weights(jax.random.PRNGKey(0), (256, 256),
                                       FAN_IN, FAN_OUT, scheme))
    assert w.shape == jwant.shape == (256, 256) and w.dtype == torch.float64
    std = {"uniform": scale / np.sqrt(3.0), "normal": scale,
           "truncated": scale * TRUNC_STD}[kind]
    # 65,536 draws: the mean within 4 standard errors, the deviation 2%
    assert abs(float(w.mean())) < 4 * std / 256
    assert abs(float(w.std()) / std - 1) < 0.02
    assert abs(float(np.std(jwant)) / std - 1) < 0.02
    bound = {"uniform": scale, "normal": None, "truncated": 2 * scale}[kind]
    if bound is not None:
        assert float(w.abs().max()) <= bound * (1 + 1e-6)
        assert float(w.abs().max()) > 0.99 * bound


def test_exact_inits_and_distributions():
    for scheme, want in (("zero", np.zeros((3, 5))), ("ones", np.ones((3, 5))),
                         ("identity", np.eye(4))):
        shape = want.shape
        got = _init(scheme, shape).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jw.init_weights(jax.random.PRNGKey(0), shape,
                                            FAN_IN, FAN_OUT, scheme)))
    with pytest.raises(ValueError, match="square"):
        _init("identity", (3, 4))
    const = {"type": "constant", "value": 0.25}
    np.testing.assert_array_equal(_init("distribution", (2, 3), const)
                                  .numpy(), np.full((2, 3), 0.25))
    for dist, mean, std in (
            ({"type": "normal", "mean": 1.0, "std": 0.5}, 1.0, 0.5),
            ({"type": "gaussian"}, 0.0, 1.0),
            ({"type": "uniform", "lower": -2.0, "upper": 4.0}, 1.0,
             6.0 / np.sqrt(12.0)),
            ({"type": "truncated_normal", "mean": -1.0, "std": 2.0}, -1.0,
             2.0 * TRUNC_STD),
            ({"type": "binomial", "trials": 4, "probability": 0.25}, 1.0,
             np.sqrt(4 * 0.25 * 0.75))):
        w = _init("distribution", dist=dist).double()
        assert abs(float(w.mean()) - mean) < 4 * std / 256, dist
        assert abs(float(w.std()) / std - 1) < 0.02, dist
    b = _init("distribution", dist={"type": "binomial", "trials": 4})
    assert set(np.unique(b.numpy())) <= {0.0, 1.0, 2.0, 3.0, 4.0}
    with pytest.raises(ValueError, match="Unknown distribution"):
        _init("distribution", dist={"type": "cauchy"})


def test_a_seed_gives_the_same_weights():
    assert torch.equal(_init("xavier_uniform", seed=3),
                       _init("xavier_uniform", seed=3))
    assert not torch.equal(_init("xavier_uniform", seed=3),
                           _init("xavier_uniform", seed=4))


# ---------------------------------------------------------------------
# updaters
# ---------------------------------------------------------------------
NEW_UPDATERS = {
    "AdaMax": dict(learning_rate=2e-2, beta1=0.8, beta2=0.99),
    "Nadam": dict(learning_rate=1e-2, beta1=0.85),
    "AdaGrad": dict(learning_rate=0.1, epsilon=1e-5),
    "AdaDelta": dict(rho=0.9, epsilon=1e-4),
    "NoOp": dict(learning_rate=0.5),
}


def _trees(seed):
    rng = np.random.default_rng(seed)
    params = {"0": {"W": rng.standard_normal((4, 6)).astype(np.float32),
                    "b": rng.standard_normal(6).astype(np.float32)},
              "1": {"gamma": rng.standard_normal(3).astype(np.float32)}}
    grads = [{k: {n: rng.standard_normal(a.shape).astype(np.float32)
                  for n, a in p.items()} for k, p in params.items()}
             for _ in range(5)]
    return params, grads


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    return tupd.tree_map(torch.tensor, tree)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}/{k}"))
        return out
    return {pre: np.asarray(tree)}


@pytest.mark.parametrize("name", sorted(NEW_UPDATERS))
def test_new_updater_five_steps_against_jax(name):
    kw = NEW_UPDATERS[name]
    ju = jupd.UPDATER_REGISTRY[name](**kw)
    tu = tupd.updater_from_dict({"@class": name, **kw})
    assert tupd.updater_to_dict(tu) == jupd.updater_to_dict(ju)
    params, grads = _trees(7)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = ju.init_state(jp), tu.init_state(tp)
    for g in grads:
        jsteps, js = ju.update(_jtree(g), js, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a - b, jp, jsteps)
        tsteps, ts = tu.update(_ttree(g), ts, tp)
        tp = tupd.tree_map(lambda a, b: a - b, tp, tsteps)
    for got, want in ((tp, jp), (updater_state_to_numpy(ts), js)):
        got, want = _flat(tupd.tree_map(np.asarray, got)), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    if "t" in ts:
        assert ts["t"].dtype == torch.int32 and ts["t"].dim() == 0
        assert int(ts["t"]) == 5
    # the state through the numpy trees (the archives' updater/ entries)
    back = updater_state_from_numpy(updater_state_to_numpy(ts), "cpu")
    assert _flat(updater_state_to_numpy(back)).keys() == \
        _flat(updater_state_to_numpy(ts)).keys()
    for a, b in zip(tupd.tree_leaves(back), tupd.tree_leaves(ts)):
        assert torch.equal(a, b)


def test_noop_leaves_params_and_state():
    params, grads = _trees(8)
    tp = _ttree(params)
    steps, state = tupd.NoOp().update(_ttree(grads[0]), {}, tp)
    assert state == {} and all(not s.any() for s in tupd.tree_leaves(steps))
