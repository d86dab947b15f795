"""The seven kernel sites that dropped NaN (ROADMAP C4), on the CPU: the
port's plain versions against the JAX kernels in interpret mode, with
one NaN planted.

The CUDA kernels wrote the relu of the bottleneck forward's and
backward's prologue, the fused forward's prologue and the stem pool
backward's zc as ``fmaxf(z, 0)``, and the pool backward's window maximum
as ``fmaxf`` / ``__hmax2``: each returns the other operand where one is
NaN. The JAX kernels take ``jnp.maximum``, which returns NaN. The
kernels now take ``max.NaN`` / ``__hmax2_nan`` (``csrc/nan_max.cuh``);
on the card ``chip_smoke.py`` holds each against its plain version with
a NaN planted. Here each plain version is held against its JAX twin with
the same NaN: NaN at exactly the JAX kernel's positions, every other
element within the plain-version tests' own limits (f32 1e-5 relative
to the tensor's scale; bf16 outputs within two ulps, the f32 sums and
dW within 1e-5 of their scale). A stand-in for the old kernels (the
planted input changed so its prologue is negative: what fmaxf made of
the NaN) is shown to put NaN elsewhere, so the comparison can fail.

- conv1x1 / conv3x3 forward (sites 1 and 2: ``conv_mma.cuh`` z8 and
  ``conv_gemm.cuh``): a NaN in x; ``_fwd_conv_stats``.
- the fused forward (sites 1 and 2, through the shared tiles): a NaN
  in y2; ``fused._pallas_fwd``.
- the fused backward's recomputed z in its dW pass (site 3,
  ``fused.cu``; site 1 in bf16): a NaN in y2; ``fused._pallas_bwd``.
- the bottleneck backward's recomputed prologue (site 4,
  ``bottleneck_bwd.cu``; site 1 in bf16): a NaN in yprev; ``_bwd_stage``.
- the stem pool backward (sites 5-7, ``stem_bwd.cu``): a NaN in y, so
  that every window holding it has a NaN maximum and sends no gradient;
  ``stem._bwd_pool``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import bottleneck as jb
from deeplearning4j_tpu.nn.layers import fused as jf
from deeplearning4j_tpu.nn.layers import stem as js
from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
from deeplearning4j_tpu_torch.nn.layers import fused as tf
from deeplearning4j_tpu_torch.nn.layers import stem as ts
from torch_threads import one_thread  # noqa: F401 (autouse)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SITES = ["conv1x1", "conv3x3", "fused", "fused_bwd", "bwd1x1", "bwd3x3",
         "stem_pool_bwd"]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, dtype, what):
    """NaN at the same elements; the rest within the limit."""
    got, want = _np(got), _np(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    g, w = got[~nan], want[~nan]
    if not w.size:
        return
    scale = max(np.abs(w).max(), 1e-30)
    if dtype == "bf16" and what in ("out", "dy", "dW"):
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert np.all(np.abs(g - w) <= 2 * ulp + 1e-6 * scale), what
    else:
        assert np.abs(g - w).max() <= 1e-5 * scale, what


def _same(a, b):
    return np.array_equal(np.isnan(_np(a)), np.isnan(_np(b)))


def _negative_prologue(x, pos, sc, bb):
    """``x`` with the planted element replaced by a value whose prologue
    ``x sc + bb`` is negative: the relu of it is what fmaxf made of NaN."""
    c = pos[-1]
    out = x.clone()
    out[pos] = (-abs(float(bb[c])) - 1.0) / float(sc[c])
    return out


def _case(site, dtype):
    """(the port's outputs, the JAX kernel's, the NaN-dropping stand-in's),
    each a tuple of tensors."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(SITES.index(site))
    n, h, w, c, k = 2, 6, 7, 16, 24

    def both(a):
        a = np.asarray(a, np.float32)
        return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)

    sc = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bb = rng.normal(0, 0.5, c).astype(np.float32)
    if site in ("conv1x1", "conv3x3", "fused", "fused_bwd"):
        x = rng.standard_normal((n, h, w, c)).astype(np.float32)
        pos = (1, 2, 3, 5)
        x[pos] = np.nan
        taps = 9 if site == "conv3x3" else 1
        wt = (rng.standard_normal((9, c, k) if taps == 9 else (c, k))
              / np.sqrt(taps * c))
        (tx, jx), (tw, jw) = both(x), both(wt)
        tsc, tbb = torch.from_numpy(sc), torch.from_numpy(bb)
        if site == "fused":
            b = rng.normal(0, 0.2, k).astype(np.float32)
            y2, jy2 = tx.reshape(-1, c), jx.reshape(-1, c)
            got = (tf.fused_matmul(y2, tsc, tbb, tw, torch.from_numpy(b)),)
            want = (jf._pallas_fwd(jy2, jnp.asarray(sc), jnp.asarray(bb),
                                   jw, jnp.asarray(b), "relu", 21, True),)
            drop = _negative_prologue(tx, pos, sc, bb).reshape(-1, c)
            dropped = (tf.fused_matmul(drop, tsc, tbb, tw,
                                       torch.from_numpy(b)),)
            return got, want, dropped
        if site == "fused_bwd":
            tg, jg = both(rng.standard_normal((n * h * w, k)))
            y2, jy2 = tx.reshape(-1, c), jx.reshape(-1, c)
            got = tf.fused_matmul_bwd(y2, tsc, tbb, tw, tg)
            want = jf._pallas_bwd(jy2, jnp.asarray(sc), jnp.asarray(bb), jw,
                                  jg, "relu", 21, True)
            drop = _negative_prologue(tx, pos, sc, bb).reshape(-1, c)
            dropped = tf.fused_matmul_bwd(drop, tsc, tbb, tw, tg)
            return got, want, dropped
        fn = tb.conv3x3 if taps == 9 else tb.conv1x1
        got = fn(tx, tsc, tbb, tw, act="relu")
        want = jb._fwd_conv_stats(jx, jnp.asarray(sc), jnp.asarray(bb), jw,
                                  taps=taps, act="relu", interpret=True)
        dropped = fn(_negative_prologue(tx, pos, sc, bb), tsc, tbb, tw,
                     act="relu")
        return got, want, dropped
    if site.startswith("bwd"):
        taps = 9 if site == "bwd3x3" else 1
        yk = rng.standard_normal((n, h, w, k))
        g = rng.standard_normal((n, h, w, k))
        yprev = rng.standard_normal((n, h, w, c)).astype(np.float32)
        pos = (0, 3, 2, 7)
        yprev[pos] = np.nan
        wt = (rng.standard_normal((9, c, k) if taps == 9 else (c, k))
              / np.sqrt(taps * c))
        aff_k = np.stack([rng.uniform(0.5, 1.5, k), rng.normal(0, 0.3, k),
                          rng.uniform(0.5, 2.0, k), rng.normal(0, 0.3, k),
                          rng.normal(0, 0.2, k), rng.normal(0, 0.2, k)])
        aff_p = np.stack([sc, bb, rng.uniform(0.5, 2.0, c),
                          rng.normal(0, 0.3, c)])
        t = [both(a)[0] for a in (yk, g, yprev, wt)] + \
            [torch.from_numpy(a.astype(np.float32)) for a in (aff_k, aff_p)]
        j = [both(a)[1] for a in (yk, g, yprev, wt)] + \
            [jnp.asarray(a.astype(np.float32)) for a in (aff_k, aff_p)]
        fn = tb.conv3x3_bwd if taps == 9 else tb.conv1x1_bwd
        got = fn(*t, act_prev="relu")
        want = jb._bwd_stage(*j, taps=taps, act_prev="relu", gmode="dz0",
                             interpret=True)
        t[2] = _negative_prologue(t[2], pos, sc, bb)
        dropped = fn(*t, act_prev="relu")
        return got, want, dropped
    # the stem pool backward: y the raw conv output
    k = 64
    geo = ts.stem_geometry(16, 16)
    mu, sd = rng.normal(0, 0.3, k), rng.uniform(0.5, 1.5, k)
    gamma, beta = rng.uniform(0.5, 1.5, k), rng.normal(0, 0.3, k)
    scs = gamma / sd
    aff = np.stack([scs, beta - mu * scs, 1 / sd, mu]).astype(np.float32)
    y = (mu + sd * rng.standard_normal((n, geo["ho"], geo["wo"], k))) \
        .astype(np.float32)
    pos = (1, 3, 4, 9)
    y[pos] = np.nan
    gout = rng.standard_normal((n, geo["po"], geo["pw"], k))
    (ty, jy), (tg, jg) = both(y), both(gout)
    taff = torch.from_numpy(aff)
    got = ts.stem_bwd_pool(ty, tg, taff)
    want = js._bwd_pool(jy, jg, jnp.asarray(aff), geo, True)
    dropped = ts.stem_bwd_pool(_negative_prologue(ty, pos, aff[0], aff[1]),
                               tg, taff)
    return got, want, dropped


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("site", SITES)
def test_the_plain_version_carries_nan_as_the_jax_kernel(site, dtype):
    got, want, dropped = _case(site, dtype)
    assert len(got) == len(want)
    names = {"conv1x1": ("out", "s1", "s2"), "conv3x3": ("out", "s1", "s2"),
             "fused": ("out",), "fused_bwd": ("dy", "dsc", "dbb", "dW", "db"),
             "bwd1x1": ("out", "dw", "sums"),
             "bwd3x3": ("out", "dw", "sums"),
             "stem_pool_bwd": ("out", "sums")}[site]
    for name, g, w in zip(names, got, want):
        _close(g, w, dtype, name)
    assert any(np.isnan(_np(w)).any() for w in want)
    # the NaN-dropping stand-in puts NaN elsewhere (or changes the
    # finite gradient where the NaN's windows send none)
    differs = not all(_same(d, w) for d, w in zip(dropped, want))
    if site == "stem_pool_bwd":
        differs = differs or not np.allclose(
            np.nan_to_num(_np(dropped[0])), np.nan_to_num(_np(want[0])))
    assert differs
