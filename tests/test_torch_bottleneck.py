"""The port's fused-bottleneck forward (deeplearning4j_tpu_torch/nn/
layers/bottleneck.py) against the JAX package's, on the CPU.

- The plain conv1x1 (strides 1 and 2, identity and relu prologue) and
  conv3x3 against the JAX ``_fwd_conv_stats`` with its Pallas kernels in
  interpret mode: out, Σout and Σout². f32: within 1e-5. bf16 (the same
  rounding points, sums in other orders): the stored output equal but
  for 1-ulp flips in under 1% of the elements, the sums within 1e-5 of
  Σ|out| (Σout²: of itself).
- ``fused_bottleneck(train=False)``, identity and downsample forms,
  against the JAX ``fused_bottleneck(interpret=True)`` and both
  packages' ``reference_bottleneck``: f32 within 1e-5; bf16 against the
  JAX chain within two ulps of each element.
- The wrappers take the plain versions on CPU tensors, launch nothing,
  and refuse what the kernels do not take (training is
  ``tests/test_torch_bottleneck_train.py``).
- The bf16 kernels' host-side plan (``_fwd_tc_plan``): the grid's block
  rows walk every pixel block once, so every output pixel is stored
  once, in the fewest rounds, at every distinct forward conv of a
  ResNet50 forward at B=128 and at the card's ragged shapes; the bf16
  partials are sized by it.
Inputs are made from a numpy seed; bf16 inputs are bf16 values handed to
both packages exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import bottleneck as jb
from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
from torch_threads import one_thread  # noqa: F401 (autouse)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}

# (taps, act, stride, n, h, w, c, k)
CONV_CASES = {
    "1x1_identity": (1, "identity", 1, 2, 8, 6, 32, 48),
    "1x1_relu": (1, "relu", 1, 2, 7, 5, 24, 40),
    "1x1_stride2_identity": (1, "identity", 2, 2, 8, 6, 32, 16),
    "1x1_stride2_relu": (1, "relu", 2, 3, 4, 4, 16, 24),
    "3x3_relu": (9, "relu", 1, 2, 7, 6, 24, 40),
    "3x3_identity": (9, "identity", 1, 2, 5, 5, 16, 8),
    # the card's ragged cases: C and K no multiple of 8, 9x13 images
    # whose 3x3 patches cross images, a stride-2 1x1 at 10x14
    "1x1_ragged": (1, "relu", 1, 3, 9, 13, 20, 36),
    "1x1_stride2_ragged": (1, "identity", 2, 3, 10, 14, 20, 36),
    "3x3_ragged": (9, "relu", 1, 3, 9, 13, 20, 36),
}


def _both(a, dtype):
    """numpy f32 ``a`` rounded to ``dtype``: (torch tensor, jax array)
    holding the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def _f32(a):
    return torch.from_numpy(np.asarray(a, np.float32)), \
        jnp.asarray(np.asarray(a, np.float32))


def _np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else
                      jnp.asarray(a, jnp.float32), np.float64)


def _conv(x, sc, bb, w, taps, act, stride):
    """The port's conv kernel wrapper of ``taps`` (the JAX
    ``_fwd_conv_stats`` dispatch)."""
    if taps == 1:
        return tb.conv1x1(x, sc, bb, w, act=act, stride=stride)
    return tb.conv3x3(x, sc, bb, w, act=act)


def _conv_inputs(case, dtype, seed=0):
    taps, act, stride, n, h, w, c, k = CONV_CASES[case]
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((n, h, w, c)), dtype)
    if act == "identity":
        sc, bb = _f32(np.ones(c)), _f32(np.zeros(c))
    else:
        sc, bb = _f32(rng.uniform(0.5, 1.5, c)), _f32(rng.normal(0, .5, c))
    wshape = (c, k) if taps == 1 else (9, c, k)
    wt = _both(rng.standard_normal(wshape) / np.sqrt(taps * c), dtype)
    return x, sc, bb, wt, dict(taps=taps, act=act, stride=stride)


def assert_bf16_flips(got, want, max_share=1e-2, ulps=1):
    """bf16 tensors equal but for flips of at most ``ulps`` units in the
    last place, in under ``max_share`` of the elements."""
    got, want = _np(got), _np(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got - want)
    assert np.all(diff <= ulps * ulp), float((diff / ulp).max())
    assert np.mean(diff > 0) < max_share, float(np.mean(diff > 0))


def assert_sums_close(got, want, out, rel=1e-5):
    """(Σo, Σo²) within ``rel`` of Σ|o| and of Σo² per channel."""
    o = _np(out).reshape(-1, out.shape[-1])
    s1, s2 = _np(got[0]), _np(got[1])
    np.testing.assert_array_less(np.abs(s1 - _np(want[0])),
                                 rel * np.abs(o).sum(0) + 1e-30)
    np.testing.assert_array_less(np.abs(s2 - _np(want[1])),
                                 rel * (o * o).sum(0) + 1e-30)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_plain_conv_matches_the_jax_kernel(case, dtype):
    x, sc, bb, w, kw = _conv_inputs(case, dtype)
    out, s1, s2 = _conv(x[0], sc[0], bb[0], w[0], **kw)
    jout, js1, js2 = jb._fwd_conv_stats(x[1], sc[1], bb[1], w[1],
                                        interpret=True, **kw)
    assert out.dtype == x[0].dtype and tuple(out.shape) == jout.shape
    if dtype == "f32":
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5,
                                   rtol=1e-5)
    else:
        assert_bf16_flips(out, jout)
    assert_sums_close((s1, s2), (js1, js2), out)
    # the sums are those of the stored output
    assert_sums_close((s1, s2), tb._stats(out), out, rel=1e-6)


def test_bf16_rounding_of_z_shows():
    """Leaving out the rounding of the activated image before the dot
    (z kept in f32) moves far more than 1% of the bf16 outputs: the
    flip check above can tell the two apart."""
    x, sc, bb, w, kw = _conv_inputs("3x3_relu", "bf16")
    want = jb._fwd_conv_stats(x[1], sc[1], bb[1], w[1], interpret=True,
                              **kw)[0]
    unrounded = tb.conv3x3_plain(x[0], sc[0], bb[0], w[0].float(),
                                 act="relu")[0].to(torch.bfloat16)
    diff = np.abs(_np(unrounded) - _np(want))
    assert np.mean(diff > 0) > 0.05


def _bn(rng, c, dtype):
    """BnParams of non-trivial inference statistics, for both packages."""
    g, b = rng.uniform(0.5, 1.5, c), rng.normal(0, 0.3, c)
    mu, var = rng.normal(0, 0.5, c), rng.uniform(0.5, 2.0, c)
    tg, jg = _both(g, dtype)
    tbeta, jbeta = _both(b, dtype)
    tmu, jmu = _f32(mu)
    tvar, jvar = _f32(var)
    return (tb.BnParams(tg, tbeta, tmu, tvar),
            jb.BnParams(jg, jbeta, jmu, jvar))


def _block(form, dtype, seed=1):
    """Inputs of an identity block (Cin = Cout = 32, Cmid 16, 8x8) or a
    downsample block (Cin 24 -> Cout 40, stride 2, 8x6)."""
    rng = np.random.default_rng(seed)
    if form == "identity":
        n, h, w, cin, cmid, cout, stride = 2, 8, 8, 32, 16, 32, 1
    else:
        n, h, w, cin, cmid, cout, stride = 2, 8, 6, 24, 16, 40, 2
    x = _both(np.maximum(rng.standard_normal((n, h, w, cin)), 0), dtype)

    def wt(shape, fan):
        return _both(rng.standard_normal(shape) * np.sqrt(2.0 / fan), dtype)

    args = [x, wt((cin, cmid), cin), _bn(rng, cmid, dtype),
            wt((9, cmid, cmid), 9 * cmid), _bn(rng, cmid, dtype),
            wt((cmid, cout), cmid), _bn(rng, cout, dtype)]
    kw = [{"stride": stride}, {"stride": stride}]
    if form == "downsample":
        ws, bs = wt((cin, cout), cin), _bn(rng, cout, dtype)
        kw[0].update(w_skip=ws[0], bn_skip=bs[0])
        kw[1].update(w_skip=ws[1], bn_skip=bs[1])
    return ([a[0] for a in args], kw[0]), ([a[1] for a in args], kw[1])


@pytest.mark.parametrize("form", ["identity", "downsample"])
def test_fused_bottleneck_matches_jax_f32(form):
    (targs, tkw), (jargs, jkw) = _block(form, "f32")
    out, stats = tb.fused_bottleneck(*targs, train=False, **tkw)
    jout, jstats = jb.fused_bottleneck(*jargs, train=False, interpret=True,
                                       **jkw)
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    assert len(stats) == len(jstats) == (8 if form == "downsample" else 6)
    for a, b in zip(stats, jstats):
        np.testing.assert_array_equal(_np(a), _np(b))
    for ref in (tb.reference_bottleneck(*targs, train=False, **tkw)[0],
                jb.reference_bottleneck(*jargs, train=False, **jkw)[0]):
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("form", ["identity", "downsample"])
def test_fused_bottleneck_matches_jax_bf16(form):
    (targs, tkw), (jargs, jkw) = _block(form, "bf16")
    out, _ = tb.fused_bottleneck(*targs, train=False, **tkw)
    jout, _ = jb.fused_bottleneck(*jargs, train=False, interpret=True,
                                  **jkw)
    assert out.dtype == torch.bfloat16
    assert_bf16_flips(out, jout, max_share=5e-2, ulps=2)


def test_reference_bottleneck_matches_jax_in_training():
    """The port's reference (the oracle of the next slice's training
    kernels) with batch statistics and the running-statistics update."""
    (targs, tkw), (jargs, jkw) = _block("downsample", "f32")
    out, stats = tb.reference_bottleneck(*targs, train=True, **tkw)
    jout, jstats = jb.reference_bottleneck(*jargs, train=True, **jkw)
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5, rtol=1e-5)
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=1e-5)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    x, sc, bb, w, kw = _conv_inputs("1x1_relu", "f32")
    before = (tb.CONV1X1.launches, tb.CONV3X3.launches)
    got = tb.conv1x1(x[0], sc[0], bb[0], w[0], act="relu")
    want = tb.conv1x1_plain(x[0], sc[0], bb[0], w[0], act="relu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (targs, tkw), _ = _block("identity", "f32")
    tb.fused_bottleneck(*targs, train=False, **tkw)
    assert (tb.CONV1X1.launches, tb.CONV3X3.launches) == before


def test_what_the_kernels_do_not_take_is_refused():
    x, sc, bb, w, _ = _conv_inputs("1x1_identity", "f32")
    with pytest.raises(ValueError, match="stride"):
        tb.conv1x1(x[0], sc[0], bb[0], w[0], stride=4)
    with pytest.raises(ValueError, match="divide"):
        tb.conv1x1(x[0][:, :7], sc[0], bb[0], w[0], stride=2)
    with pytest.raises(ValueError, match="relu or identity"):
        tb.conv1x1(x[0], sc[0], bb[0], w[0], act="gelu")
    with pytest.raises(ValueError, match=r"\[9, C"):
        tb.conv3x3(x[0], sc[0], bb[0], w[0])
    (targs, tkw), _ = _block("identity", "f32")
    with pytest.raises(ValueError, match="go together"):
        tb.fused_bottleneck(*targs, train=True, bn_skip=targs[2], **tkw)
    with pytest.raises(ValueError, match="conv shortcut"):
        tb.fused_bottleneck(*targs, train=False, stride=2)


@pytest.mark.parametrize("shape,stride,dtype,ok", [
    ((1, 56, 56, 64), 1, "bfloat16", True),
    ((1, 56, 56, 256), 2, "float32", True),
    ((1, 7, 7, 2048), 1, "float32", True),
    ((1, 7, 7, 1024), 2, "bfloat16", False),
    ((1, 8, 8, 64), 3, "float32", False),
    ((1, 8, 8, 64), 1, "float16", False),
    ((8, 8, 64), 1, "float32", False)])
def test_the_gate_refuses_only_what_the_kernels_do_not_take(shape, stride,
                                                             dtype, ok):
    assert tb.fused_bottleneck_supported(shape, 64, 256, dtype,
                                         stride=stride) is ok


# ---------------------------------------------------------------------
# the bf16 forward kernels' launch plan (host side, _fwd_tc_plan)
# ---------------------------------------------------------------------
#: every distinct bottleneck forward conv of a ResNet50 forward at
#: 224x224 (h = w of the input, C, K, stride, taps), and the card's
#: ragged cases at B = 3 (n, h, w, C, K, stride, taps)
RESNET_FWD_CONVS = [(56, 64, 64, 1, 1), (56, 256, 64, 1, 1),
                    (56, 64, 64, 1, 9), (56, 64, 256, 1, 1),
                    (56, 256, 128, 2, 1), (28, 512, 128, 1, 1),
                    (28, 128, 128, 1, 9), (28, 128, 512, 1, 1),
                    (56, 256, 512, 2, 1), (28, 512, 256, 2, 1),
                    (14, 1024, 256, 1, 1), (14, 256, 256, 1, 9),
                    (14, 256, 1024, 1, 1), (28, 512, 1024, 2, 1),
                    (14, 1024, 512, 2, 1), (7, 2048, 512, 1, 1),
                    (7, 512, 512, 1, 9), (7, 512, 2048, 1, 1),
                    (14, 1024, 2048, 2, 1)]
FWD_PLAN_CASES = [(128, hw, hw, c, k, s, t)
                  for hw, c, k, s, t in RESNET_FWD_CONVS] + [
    (3, 9, 13, 20, 36, 1, 1), (3, 10, 14, 20, 36, 2, 1),
    (3, 9, 13, 20, 36, 1, 9), (1, 1, 1, 8, 8, 1, 9)]


def _rounds(q, blocks, cols, cap):
    """Rounds of pixel blocks with q grid rows: a block walks ceil(blocks
    / q) of them, in ceil(q cols / cap) waves of the grid."""
    return -(-q * cols // cap) * -(-blocks // q)


@pytest.mark.parametrize("n, h, w, c, k, stride, taps", FWD_PLAN_CASES)
def test_the_forward_plan_stores_every_pixel_once(n, h, w, c, k, stride,
                                                  taps):
    """On a 132-SM card the grid's block rows (the bf16 partials a
    channel) walk the pixel blocks q, q + rows, ...: every pixel block
    once, so every output pixel once, and no more rows than pixel
    blocks; the rows take the fewest rounds of any choice."""
    sms = 132
    ho, wo = h // stride, w // stride
    plan = tb._fwd_tc_plan(n, h, w, k, stride, taps, sms)
    assert plan.channels == (64 if k <= 64 else 128)
    assert 1 <= plan.tiles <= plan.blocks
    walked = np.zeros(plan.blocks, np.int64)
    for q in range(plan.tiles):
        walked[q::plan.tiles] += 1
    assert (walked == 1).all()
    seen = np.zeros((n * ho, wo), np.int64)
    for p in range(plan.blocks):
        if taps == 9:
            tw, th, cols = plan.patch
            assert th * tw <= 128
            r0, c0 = (p // cols) * th, (p % cols) * tw
            seen[r0:r0 + th, c0:c0 + tw] += 1
        else:
            assert plan.patch is None
            seen.reshape(-1)[128 * p:128 * (p + 1)] += 1
    assert (seen == 1).all()
    cols, cap = -(-k // plan.channels), (2 if k <= 64 else 1) * sms
    best = min(_rounds(q, plan.blocks, cols, cap)
               for q in range(1, plan.blocks + 1))
    assert _rounds(plan.tiles, plan.blocks, cols, cap) == best


def test_the_bf16_partials_follow_the_plan(monkeypatch):
    """The bf16 forward's partials are the plan's block rows: for the s2
    3x3 of one image, its 28 patches, more than the 25 output-row tiles
    of 128 pixels that size the f32 kernel's."""
    monkeypatch.setattr(tb, "_sm_count", lambda device: 132)
    x = torch.zeros((1, 56, 56, 64), dtype=torch.bfloat16)
    out, part, tiles, sums = tb._conv_outputs(x, 1, 56, 56, 64, 1, 9)
    plan = tb._fwd_tc_plan(1, 56, 56, 64, 1, 9, 132)
    assert tiles == plan.tiles == plan.blocks == 28 > -(-56 * 56 // 128)
    assert tuple(part.shape) == (2, 64, 28)
    assert tuple(out.shape) == (1, 56, 56, 64) and out.dtype == x.dtype
    assert tuple(sums.shape) == (2, 64) and not sums.any()
