"""ResNet50 on the bn -> act -> 1x1-conv plan (``fuse=True``) against
the JAX package, on the CPU.

- ``ResNet50(fuse=True)`` plans exactly the 16 ``*_c_conv`` vertices
  (each block's ``b_bn -> b_act -> c_conv`` chain), the groups and the
  absorbed vertices of the JAX graph's ``_fusion()``; the stem and the
  other chains run as on the xla plan.
- ``output()`` at 64x64, 10 classes, batch 2, f32, NHWC, with the JAX
  graph's parameters (BN gains and biases drawn away from 1 and 0) and
  calibrated BN statistics carried across: against the JAX ``fuse=True``
  net within atol 1e-4, rtol 1e-3 (the JAX package's own limits between
  its fused and unfused ResNet50), and against the port's xla plan.
- Two ``fit`` steps at batch 4 under ``Nesterovs(1e-7, 0.9)``
  (``tests/test_torch_resnet_train.py``'s configuration and
  ``train_both``, given the fusion level): against the JAX ``fuse=True``
  graph within ``check(..., JAX_LIMIT)``, and against the port's xla
  plan within ``PLANS_LIMIT``; the plain backward without its relu'
  mask in one group reads far outside the plans' limit.
- ``modeled_train_step_traffic`` equals the JAX package's dict at
  B=128, f32 and bf16, where the two gates take the same chains (at
  224x224 in f32 the JAX gate's VMEM budget refuses four blocks and the
  stem; the port's takes all 16 and the stem).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.tuning.plan import (
    modeled_train_step_traffic as jax_traffic)
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.nn.layers import fused as tf
from deeplearning4j_tpu_torch.tuning import modeled_train_step_traffic
from deeplearning4j_tpu_torch.util.convert import state_to_numpy
from deeplearning4j_tpu_torch.zoo import ResNet50
from test_torch_resnet import _draw, calibrate_bn
from test_torch_resnet_train import (
    JAX_LIMIT, PLANS_LIMIT, _fit, _port_net, check, train_both,
    update_err)
from torch_threads import one_thread  # noqa: F401 (autouse)

H = W = 64
CLASSES = 10


@pytest.fixture(scope="module")
def nets():
    """The JAX ResNet50 and the port's on fuse=True, NHWC, with the same
    parameters and BN state, and the batch they are compared on."""
    jnet = JResNet50(num_classes=CLASSES, height=H, width=W,
                     data_format="NHWC", fuse=True).init()
    rng = np.random.default_rng(0)
    np_params = {v: _draw(p, rng) for v, p in jnet.params.items()}
    tnet = ResNet50(num_classes=CLASSES, height=H, width=W,
                    data_format="NHWC", fuse=True).init(device="cpu")
    tnet.load_numpy_params(np_params)
    x = rng.standard_normal((8, 3, H, W)).astype(np.float32)
    tnet.set_fusion(False)
    calibrate_bn(tnet, x)
    tnet.set_fusion(True)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    jnet.state = jax.tree_util.tree_map(jnp.asarray,
                                        state_to_numpy(tnet.state))
    return jnet, tnet, x[:2]


def test_fuse_true_plans_the_jax_groups(nets):
    jnet, tnet, _ = nets
    assert tnet.fusion_level is True and jnet.fuse_bn_act_conv is True
    jplan, jskip, _ = jnet._fusion()
    plan = tnet._conv_plan()
    assert len(plan) == 16 and all(k.endswith("_c_conv") for k in plan)
    assert plan == jplan
    assert all(plan[f"{b}_c_conv"] == (f"{b}_b_bn", "relu", f"{b}_b_conv")
               for b in (k[:-len("_c_conv")] for k in plan))
    skip, bplan, splan = tnet._fusion()
    assert skip == jskip and bplan == {} and splan == {}
    # the zoo's switches: "bottleneck" is the bottleneck level; fuse=
    # with execution_plan= is refused, as in the JAX zoo
    assert ResNet50(num_classes=CLASSES, height=H, width=W,
                    data_format="NHWC", fuse="bottleneck").init(
        device="cpu").fusion_level == "bottleneck"
    with pytest.raises(ValueError, match="mutually exclusive"):
        ResNet50(fuse=True, execution_plan="fused").init(device="cpu")
    with pytest.raises(ValueError, match="stem=True"):
        tnet.set_fusion(True, stem=True)
    assert tnet.fusion_level is True


def test_output_matches_the_jax_fuse_true_net(nets):
    jnet, tnet, x = nets
    got = tnet.output(x)
    assert tuple(got.shape) == (2, CLASSES) and got.dtype == torch.float32
    assert float(got.max()) < 0.9                   # not saturated
    np.testing.assert_allclose(got.numpy(), np.asarray(jnet.output(x)),
                               atol=1e-4, rtol=1e-3)
    tnet.set_fusion(False)
    try:
        np.testing.assert_allclose(got.numpy(), tnet.output(x).numpy(),
                                   atol=1e-5, rtol=1e-4)
    finally:
        tnet.set_fusion(True)
    # inference launched no kernel: the plain versions ran on the CPU
    assert tf.FUSED_FWD.launches == tf.FUSED_BWD.launches == 0


@pytest.fixture(scope="module")
def runs():
    """Two fit steps of the JAX graph on fuse=True and of the port on
    fuse=True and on the xla plan, from the same trees."""
    return train_both((True,), (True, "xla"))


def test_fit_matches_the_jax_fuse_true_graph(runs):
    check(runs, "port_fuse_true", "jax_fuse_true", JAX_LIMIT)
    base = runs["base"]
    assert update_err(base["params"], runs["port_fuse_true"][-1]["params"],
                      base["params"]) == pytest.approx(1.0)


def test_fit_matches_the_xla_plan(runs):
    check(runs, "port_fuse_true", "port_xla", PLANS_LIMIT)


def test_a_group_without_its_relu_mask_fails_the_limit(runs, monkeypatch):
    """The first group's backward without its relu' mask (the plain
    version run with the identity prologue's dz) is far outside the
    plans' limit: the limit sees a fault in one of the 16 groups."""
    plain, seen = tf.fused_matmul_bwd_plain, [0]

    def no_mask(y2, sc, bb, w2, g, act="relu"):
        seen[0] += 1
        if seen[0] % 16 != 1:
            return plain(y2, sc, bb, w2, g, act)
        dy, _, _, dw, db = plain(y2, sc, bb, w2, g, act)
        udy, dsc, dbb, _, _ = plain(y2, sc, bb, w2, g, "identity")
        return udy, dsc, dbb, dw, db

    monkeypatch.setattr(tf, "fused_matmul_bwd_plain", no_mask)
    recs = _fit(_port_net(*runs["trees"]), runs["x"], runs["y"], True)
    err = update_err(recs[0]["updater"], runs["port_xla"][0]["updater"],
                     runs["base"]["updater"])
    assert err > 5 * PLANS_LIMIT


@pytest.mark.parametrize("hw,dtype", [(64, "float32"), (64, "bfloat16"),
                                      (224, "bfloat16")])
def test_modeled_train_step_traffic_is_the_jax_packages(hw, dtype):
    jnet = JResNet50(num_classes=1000, height=hw, width=hw,
                     data_format="NHWC").init()
    tnet = ResNet50(num_classes=1000, height=hw, width=hw,
                    data_format="NHWC").init(device="cpu")
    jnet.conf.dtype = tnet.conf.dtype = dtype
    want = jax_traffic(jnet, 128)
    assert modeled_train_step_traffic(tnet, 128) == want
    assert want["blocks"] == 16 and want["stems"] == 1
    if dtype == "bfloat16":
        tnet.conf.dtype = jnet.conf.dtype = "float32"
        got = modeled_train_step_traffic(tnet, 128)
        assert got["xla_bytes"] == 2 * want["xla_bytes"]
        assert (got["blocks"], got["stems"]) == (16, 1)
