"""The port's fused-stem forward (deeplearning4j_tpu_torch/nn/layers/
stem.py) against the JAX package's, on the CPU.

- ``stem_geometry`` and ``stem_weight_s2d`` equal the JAX package's at
  even and odd sizes.
- The plain stem conv and pool against the JAX ``_conv_stats`` and
  ``_pool`` with their Pallas kernels in interpret mode: f32 within
  1e-5 (the pool within 1e-6: XLA fuses its multiply-add); bf16 the
  stored conv output and the pool equal but for 1-ulp flips in under 1%
  of the elements, the sums within 1e-5 of Σ|y| (Σy²: of itself).
- ``fused_stem(train=False)`` against the JAX ``fused_stem(
  interpret=True)`` and both packages' ``reference_stem``; training
  runs (held against the JAX package in
  ``tests/test_torch_stem_train.py``).
Inputs come from a numpy seed (continuous values: no ties in a pool
window).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import stem as js
from deeplearning4j_tpu_torch.nn.layers import stem as ts

from test_torch_bottleneck import (
    _bn, _both, _np, assert_bf16_flips, assert_sums_close)
from torch_threads import one_thread  # noqa: F401 (autouse)

SIZES = [(16, 16), (15, 17), (20, 9), (7, 7)]


@pytest.mark.parametrize("h,w", SIZES + [(224, 224), (223, 225)])
def test_geometry_is_the_jax_packages(h, w):
    assert ts.stem_geometry(h, w) == js.stem_geometry(h, w)


@pytest.mark.parametrize("c,k", [(3, 64), (2, 5)])
def test_weight_s2d_is_the_jax_packages(c, k):
    w = np.random.default_rng(c).standard_normal((k, c, 7, 7)) \
        .astype(np.float32)
    got = ts.stem_weight_s2d(torch.from_numpy(w))
    want = np.asarray(js.stem_weight_s2d(jnp.asarray(w)))
    assert tuple(got.shape) == (64 * c, k)
    np.testing.assert_array_equal(got.numpy(), want)


def _inputs(h, w, dtype, n=2, c=3, k=16, seed=0):
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((n, h, w, c)), dtype)
    w7 = _both(rng.standard_normal((k, c, 7, 7)) * np.sqrt(2 / (49 * c)),
               dtype)
    return x, w7, _bn(rng, k, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_conv_and_pool_match_the_jax_kernels(h, w, dtype):
    x, w7, (tbn, jbn) = _inputs(h, w, dtype)
    g = ts.stem_geometry(h, w)
    tw = ts.stem_weight_s2d(w7[0])
    jw = js.stem_weight_s2d(w7[1])
    y, s1, s2 = ts.stem_conv(x[0], tw)
    jy, js1, js2 = js._conv_stats(x[1], jw, g, True)
    assert tuple(y.shape) == jy.shape and y.dtype == x[0].dtype
    if dtype == "f32":
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
    else:
        assert_bf16_flips(y, jy)
    assert_sums_close((s1, s2), (js1, js2), y)
    # the pool on the same y, so the comparison is exact
    sc = torch.from_numpy(np.random.default_rng(1).uniform(
        0.5, 1.5, y.shape[3]).astype(np.float32))
    bb = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.5, y.shape[3]).astype(np.float32))
    jy_same = jnp.asarray(y.float().numpy()).astype(jy.dtype)
    out = ts.stem_pool(y, sc, bb)
    jout = js._pool(jy_same, jnp.asarray(sc.numpy()),
                    jnp.asarray(bb.numpy()), g, True)
    assert tuple(out.shape) == jout.shape == (2, g["po"], g["pw"], 16)
    # XLA contracts y sc + bb into one fused multiply-add (1 ulp of f32)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-6,
                                   rtol=1e-6)
    else:
        assert_bf16_flips(out, jout)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", [(32, 32), (15, 17)])
def test_fused_stem_matches_jax(h, w, dtype):
    x, w7, (tbn, jbn) = _inputs(h, w, dtype, seed=3)
    out, stats = ts.fused_stem(x[0], w7[0], tbn, train=False)
    jout, jstats = js.fused_stem(x[1], w7[1], jbn, train=False,
                                 interpret=True)
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5,
                                   rtol=1e-5)
        for ref in (ts.reference_stem(x[0], w7[0], tbn, train=False)[0],
                    js.reference_stem(x[1], w7[1], jbn, train=False)[0]):
            np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5,
                                       rtol=1e-5)
    else:
        assert out.dtype == torch.bfloat16
        assert_bf16_flips(out, jout, max_share=5e-2, ulps=2)
    for a, b in zip(stats, jstats):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_reference_stem_matches_jax_in_training():
    x, w7, (tbn, jbn) = _inputs(16, 16, "f32", n=4, seed=4)
    out, (m, v) = ts.reference_stem(x[0], w7[0], tbn, train=True)
    jout, (jm, jv) = js.reference_stem(x[1], w7[1], jbn, train=True)
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(m), _np(jm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(v), _np(jv), atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_launch_nothing_and_train_runs():
    x, w7, (tbn, _) = _inputs(16, 16, "f32")
    counters = (ts.STEM_CONV, ts.STEM_POOL, ts.STEM_BWD_POOL,
                ts.STEM_BWD_DW, ts.STEM_BWD_DX)
    before = [c.launches for c in counters]
    ts.fused_stem(x[0], w7[0], tbn, train=False)
    # training runs (StemTrain: tests/test_torch_stem_train.py)
    out, (m, v) = ts.fused_stem(x[0], w7[0], tbn, train=True)
    assert tuple(out.shape) == (2, 4, 4, 16)
    assert bool(torch.isfinite(out).all()) and m.dtype == torch.float32
    assert not torch.equal(m, tbn.running_mean)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match=r"\[64 C, K\]"):
        ts.stem_conv(x[0], w7[0])
    assert ts.fused_stem_supported((1, 224, 224, 3), 64, "float32")
    assert ts.fused_stem_supported((1, 5, 5, 3), 64, "bfloat16")
    assert not ts.fused_stem_supported((1, 224, 224, 3), 64, "float16")
    assert not ts.fused_stem_supported((224, 224, 3), 64, "float32")
    # the input gradient's kernel keeps the weight in shared memory
    assert not ts.fused_stem_supported((1, 8, 8, 193), 64, "float32")
