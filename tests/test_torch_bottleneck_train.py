"""The port's fused-bottleneck backward (deeplearning4j_tpu_torch/nn/
layers/bottleneck.py) against the JAX package's, on the CPU.

- The plain backward stages ``conv1x1_bwd_plain`` (strides 1 and 2,
  relu and identity prologues, down to a one-pixel output) and
  ``conv3x3_bwd_plain`` (down to a one-row image, where the padded taps
  dominate) against the JAX ``_bwd_stage`` (``gmode="dz0"``, the form
  every caller uses) with its Pallas kernels in interpret mode: dz0, dW
  and the sums. f32: within 1e-5 of
  each output's largest magnitude (sums in other orders). bf16 (the same
  rounding points): dz0 equal but for 1-ulp flips in under 1% of the
  elements, dW and the sums (f32) within 1e-5 of their largest
  magnitude.
- The traps: a padded tap reads 0 after the prologue (in the 3x3's dz
  pass, not the BN-backward affine of zero; in its dW pass, not
  relu(bb)); a stride-2 1x1 writes 0 where the conv never read and sums
  the read positions only; the sums are over the f32 dz before its
  rounding. Each is pinned by a case that fails the same limit when the
  trap is sprung.
- ``fused_bottleneck(train=True)``, identity and downsample forms: the
  output, the running statistics and the gradient of every input
  (torch autograd through ``BottleneckTrain``) against ``jax.vjp`` of
  the JAX ``fused_bottleneck(train=True, interpret=True)``. f32: within
  1e-5 of each tensor's largest magnitude. bf16: equal but for 1-ulp
  flips in under 5% of the elements. And against torch autograd of the
  port's unfused ``reference_bottleneck`` in f32, within 1e-5.
- The backward wrappers take the plain versions on CPU tensors, launch
  nothing, and refuse what the kernels do not take.
- The bf16 kernels' host-side plan (``_patch_tiling``, ``_bwd_tc_plan``):
  the 3x3's patches at ResNet50's widths, patches that hold every pixel
  exactly once, and dW splits that cover every chunk, at every distinct
  backward stage of a ResNet50 step. The stage cases include the card's
  ragged shapes (C and K no multiple of 8, M = 147) and a 7x7 3x3.
Inputs are made from a numpy seed; bf16 inputs are bf16 values handed to
both packages exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import bottleneck as jb
from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
from test_torch_bottleneck import _block, _both, assert_bf16_flips
from torch_threads import one_thread  # noqa: F401 (autouse)

F32_REL = 1e-5

# (taps, act_prev, stride, n, h, w, c, k)
STAGE_CASES = {
    "1x1_relu": (1, "relu", 1, 2, 6, 5, 24, 40),
    "1x1_relu_stride2": (1, "relu", 2, 2, 6, 8, 16, 24),
    "1x1_relu_stride2_one_pixel": (1, "relu", 2, 3, 2, 2, 16, 32),
    "1x1_identity": (1, "identity", 1, 2, 5, 6, 32, 16),
    "1x1_identity_stride2": (1, "identity", 2, 3, 8, 6, 24, 40),
    "3x3_relu": (9, "relu", 1, 2, 7, 6, 24, 16),
    "3x3_relu_one_row": (9, "relu", 1, 2, 1, 7, 16, 24),
    # the card's ragged cases (C and K no multiple of 8, M = 147 no
    # multiple of a row tile) and s5's small image
    "1x1_relu_stride2_ragged": (1, "relu", 2, 3, 14, 14, 20, 36),
    "3x3_relu_ragged": (9, "relu", 1, 3, 7, 7, 20, 36),
    "3x3_relu_7x7": (9, "relu", 1, 2, 7, 7, 24, 24),
}


def _np(a):
    if torch.is_tensor(a):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _stage_inputs(case, dtype, seed=0):
    """A stage's inputs for both packages: yk, g, yprev and w in
    ``dtype``; aff_k (sc, bb, inv > 0, mu, m1, m2) and aff_p (sc, bb,
    inv > 0, mu) f32."""
    taps, act, stride, n, h, w, c, k = STAGE_CASES[case]
    rng = np.random.default_rng(seed)
    ho, wo = h // stride, w // stride
    yk = _both(rng.standard_normal((n, ho, wo, k)), dtype)
    g = _both(rng.standard_normal((n, ho, wo, k)), dtype)
    yprev = _both(rng.standard_normal((n, h, w, c)), dtype)
    wshape = (c, k) if taps == 1 else (9, c, k)
    wt = _both(rng.standard_normal(wshape) / np.sqrt(taps * c), dtype)
    aff_k = np.stack([rng.uniform(0.5, 1.5, k), rng.normal(0, 0.3, k),
                      rng.uniform(0.5, 2.0, k), rng.normal(0, 0.3, k),
                      rng.normal(0, 0.2, k), rng.normal(0, 0.2, k)])
    aff_p = np.stack([rng.uniform(0.5, 1.5, c), rng.normal(0, 0.5, c),
                      rng.uniform(0.5, 2.0, c), rng.normal(0, 0.3, c)])
    affs = [(torch.from_numpy(a.astype(np.float32)),
             jnp.asarray(a.astype(np.float32))) for a in (aff_k, aff_p)]
    args = [yk, g, yprev, wt] + affs
    kw = dict(act_prev=act)
    return ([a[0] for a in args], [a[1] for a in args], kw,
            dict(taps=taps, stride=stride))


def _port_stage(targs, kw, taps, stride):
    if taps == 1:
        return tb.conv1x1_bwd(*targs, stride=stride, **kw)
    return tb.conv3x3_bwd(*targs, **kw)


def _jax_stage(jargs, kw, taps, stride):
    return jb._bwd_stage(*jargs, taps=taps, stride=stride, gmode="dz0",
                         interpret=True, **kw)


def rel_err(got, want):
    """The largest |got - want| over the largest |want|."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_plain_backward_stage_matches_the_jax_kernel(case, dtype):
    targs, jargs, kw, geo = _stage_inputs(case, dtype)
    dz, dw, sums = _port_stage(targs, kw, **geo)
    jdz, jdw, jsums = _jax_stage(jargs, kw, **geo)
    assert dz.dtype == targs[2].dtype and tuple(dz.shape) == jdz.shape
    assert dw.dtype == sums.dtype == torch.float32
    assert tuple(dw.shape) == jdw.shape
    assert tuple(sums.shape) == (2, dz.shape[3])
    if dtype == "f32":
        assert rel_err(dz, jdz) < F32_REL
    else:
        assert_bf16_flips(dz, jdz)
    assert rel_err(dw, jdw) < F32_REL
    if kw["act_prev"] == "identity":
        assert not bool(sums.any()) and not np.any(np.asarray(jsums))
    else:
        assert rel_err(sums, jsums) < F32_REL


def test_stride2_writes_zero_where_the_conv_never_read():
    targs, jargs, kw, geo = _stage_inputs("1x1_relu_stride2", "f32")
    dz, _, sums = _port_stage(targs, kw, **geo)
    read = torch.zeros(dz.shape[1:3], dtype=torch.bool)
    read[::2, ::2] = True
    assert not bool(dz[:, ~read].any())
    assert bool(dz[:, read].any())
    # the sums run over the read positions: the same dz0 at full
    # resolution summed with the full-resolution yhat would differ there
    yhat = (targs[2].float() - targs[5][3]) * targs[5][2]
    full = (dz.float() * yhat).reshape(-1, dz.shape[3]).sum(0)
    assert torch.allclose(full, sums[1], rtol=1e-5, atol=1e-5)


def _faulty_3x3(targs, kw, *, dz_pad_affine=False, dw_pad_relu_bb=False):
    """The plain 3x3 backward with one padding trap sprung: the dz pass
    pads dy with the BN-backward affine of a zero pixel, or the dW pass
    pads z with relu(bb), the prologue of a zero pixel."""
    yk, g, yprev, w, aff_k, aff_p = targs
    pad = torch.nn.functional.pad
    n, h, wd, c = yprev.shape
    k = yk.shape[3]
    if dz_pad_affine:
        dyp = tb._dy(pad(yk, (0, 0, 1, 1, 1, 1)), pad(g, (0, 0, 1, 1, 1, 1)),
                     aff_k)
    else:
        dyp = pad(tb._dy(yk, g, aff_k), (0, 0, 1, 1, 1, 1))
    dy = dyp[:, 1:-1, 1:-1, :].reshape(-1, k)
    ypad = pad(yprev.float(), (0, 0, 1, 1, 1, 1))
    z = torch.clamp_min(ypad * aff_p[0] + aff_p[1], 0.0)
    if not dw_pad_relu_bb:
        z = pad(z[:, 1:-1, 1:-1, :], (0, 0, 1, 1, 1, 1))
    dw = torch.stack([z[:, kh:kh + h, kw_:kw_ + wd, :].reshape(-1, c).t() @ dy
                      for kh, kw_ in (divmod(t, 3) for t in range(9))])
    dz = sum(dyp[:, 2 - kh:2 - kh + h, 2 - kw_:2 - kw_ + wd, :]
             .reshape(-1, k) @ w.float()[kh * 3 + kw_].t()
             for kh in range(3) for kw_ in range(3))
    return dz.reshape(n, h, wd, c), dw


@pytest.mark.parametrize("trap", ["dz_pad_affine", "dw_pad_relu_bb"])
def test_padded_taps_read_zero_after_the_prologue(trap):
    """A padded tap reads 0 in both passes of the 3x3. Springing either
    trap moves the output far beyond the limit the port meets."""
    targs, jargs, kw, geo = _stage_inputs("3x3_relu", "f32")
    jdz, jdw, _ = _jax_stage(jargs, kw, **geo)
    z0 = targs[2].float() * targs[5][0] + targs[5][1]
    dz, dw = _faulty_3x3(targs, kw, **{trap: True})
    dz = torch.where(z0 > 0, dz, 0.0)
    if trap == "dz_pad_affine":
        assert rel_err(dz, jdz) > 100 * F32_REL
    else:
        assert rel_err(dw, jdw) > 100 * F32_REL
    # the same helper with no trap sprung is the port
    dz0, dw0 = _faulty_3x3(targs, kw)
    assert rel_err(torch.where(z0 > 0, dz0, 0.0), jdz) < F32_REL
    assert rel_err(dw0, jdw) < F32_REL


def test_sums_take_the_f32_dz_before_its_rounding():
    """bf16: sums over the stored (rounded) dz0, the forward epilogue's
    habit, fail the limit the port meets."""
    targs, jargs, kw, geo = _stage_inputs("1x1_relu", "bf16")
    _, _, jsums = _jax_stage(jargs, kw, **geo)
    dz, _, sums = _port_stage(targs, kw, **geo)
    assert rel_err(sums, jsums) < F32_REL
    yp, aff_p = targs[2].float(), targs[5]
    yhat = ((yp - aff_p[3]) * aff_p[2]).reshape(-1, yp.shape[3])
    stored = dz.float().reshape(-1, yp.shape[3])
    rounded = torch.stack([stored.sum(0), (stored * yhat).sum(0)])
    assert rel_err(rounded, jsums) > 10 * F32_REL


def _leaves(args, kw):
    """The differentiable inputs of a block: x, wa, wb, wc, the BN
    gammas and betas (and the shortcut's weight, gamma and beta)."""
    x, wa, bn_a, wb, bn_b, wc, bn_c = args
    out = [x, wa, wb, wc, bn_a.gamma, bn_a.beta, bn_b.gamma, bn_b.beta,
           bn_c.gamma, bn_c.beta]
    if "w_skip" in kw and kw["w_skip"] is not None:
        out += [kw["w_skip"], kw["bn_skip"].gamma, kw["bn_skip"].beta]
    return out


def _rebuild(args, kw, leaves):
    x, wa, wb, wc, ga, ba, gb, bb, gc, bc, *sk = leaves
    a = [x, wa, args[2]._replace(gamma=ga, beta=ba), wb,
         args[4]._replace(gamma=gb, beta=bb), wc,
         args[6]._replace(gamma=gc, beta=bc)]
    kw = dict(kw)
    if sk:
        kw.update(w_skip=sk[0],
                  bn_skip=kw["bn_skip"]._replace(gamma=sk[1], beta=sk[2]))
    return a, kw


def _port_train(targs, tkw, ct, fn=tb.fused_bottleneck):
    leaves = [t.clone().requires_grad_() for t in _leaves(targs, tkw)]
    a, kw = _rebuild(targs, tkw, leaves)
    out, stats = fn(*a, train=True, **kw)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ct)
                                .to(out.dtype))
    return out, stats, grads


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["identity", "downsample"])
def test_fused_bottleneck_training_matches_jax_vjp(form, dtype):
    (targs, tkw), (jargs, jkw) = _block(form, dtype)

    def jfn(*leaves):
        a, kw = _rebuild(jargs, jkw, leaves)
        return jb.fused_bottleneck(*a, train=True, interpret=True, **kw)

    (jout, jstats), vjp = jax.vjp(jfn, *_leaves(jargs, jkw))
    ct = np.random.default_rng(3).standard_normal(jout.shape) \
        .astype(np.float32)
    jgrads = vjp((jnp.asarray(ct).astype(jout.dtype),
                  tuple(jnp.zeros_like(s) for s in jstats)))
    out, stats, grads = _port_train(targs, tkw, ct)
    assert len(stats) == len(jstats) == (8 if form == "downsample" else 6)
    for a, b in zip(stats, jstats):
        assert a.dtype == torch.float32 and not a.requires_grad
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    pairs = [(out, jout)] + list(zip(grads, jgrads))
    for i, (a, b) in enumerate(pairs):
        assert tuple(a.shape) == b.shape, i
        if dtype == "f32":
            assert rel_err(a, b) < F32_REL, i
        else:
            assert a.dtype == torch.bfloat16, i
            assert_bf16_flips(a.detach(), b, max_share=5e-2)


@pytest.mark.parametrize("form", ["identity", "downsample"])
def test_fused_bottleneck_training_matches_autograd_of_the_reference(form):
    (targs, tkw), _ = _block(form, "f32")
    ct = np.random.default_rng(4).standard_normal(
        tb.fused_bottleneck(*targs, train=False, **tkw)[0].shape) \
        .astype(np.float32)
    out, stats, grads = _port_train(targs, tkw, ct)
    rout, rstats, rgrads = _port_train(targs, tkw, ct,
                                       fn=tb.reference_bottleneck)
    for a, b in [(out, rout)] + list(zip(stats, rstats)) + \
            list(zip(grads, rgrads)):
        assert rel_err(a, b) < F32_REL


def test_backward_wrappers_take_the_plain_versions_on_the_cpu():
    targs, _, kw, geo = _stage_inputs("3x3_relu", "f32")
    before = (tb.BWD1X1.launches, tb.BWD3X3.launches)
    got = tb.conv3x3_bwd(*targs, **kw)
    want = tb.conv3x3_bwd_plain(*targs, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (bargs, bkw), _ = _block("downsample", "f32")
    _port_train(bargs, bkw, np.ones((2, 4, 3, 40), np.float32))
    assert (tb.BWD1X1.launches, tb.BWD3X3.launches) == before


def test_backward_refuses_what_the_kernels_do_not_take():
    targs, _, kw, _ = _stage_inputs("1x1_relu", "f32")
    with pytest.raises(ValueError, match="stride"):
        tb.conv1x1_bwd(*targs, stride=4, **kw)
    with pytest.raises(ValueError, match="must be"):
        tb.conv1x1_bwd(*targs, stride=2, **kw)       # yk is not H/2 x W/2
    with pytest.raises(ValueError, match="relu or identity"):
        tb.conv1x1_bwd(*targs, act_prev="gelu")
    t3, _, kw3, _ = _stage_inputs("3x3_relu", "f32")
    with pytest.raises(ValueError, match="prologue is relu"):
        tb.conv3x3_bwd(*t3, act_prev="identity")
    with pytest.raises(ValueError, match=r"\(9, 24, 16\)"):
        tb.conv3x3_bwd(*t3[:3], t3[3][0], *t3[4:], **kw3)
    with pytest.raises(ValueError, match="aff_k"):
        tb.conv3x3_bwd(*t3[:4], t3[4][:4], t3[5], **kw3)


# ---------------------------------------------------------------------
# the bf16 kernels' launch plan (host side, _bwd_tc_plan)
# ---------------------------------------------------------------------
#: every distinct backward stage of a ResNet50 step at 224x224:
#: (kernel taps, h = w of y_{k-1}, C, K, stride)
RESNET_STAGES = [(1, 56, 64, 256, 1), (9, 56, 64, 64, 1),
                 (1, 56, 64, 64, 1), (1, 56, 256, 64, 1),
                 (1, 28, 128, 512, 1), (9, 28, 128, 128, 1),
                 (1, 56, 256, 128, 2), (1, 28, 512, 128, 1),
                 (1, 56, 256, 512, 2), (1, 14, 256, 1024, 1),
                 (9, 14, 256, 256, 1), (1, 28, 512, 256, 2),
                 (1, 14, 1024, 256, 1), (1, 28, 512, 1024, 2),
                 (1, 7, 512, 2048, 1), (9, 7, 512, 512, 1),
                 (1, 14, 1024, 512, 2), (1, 7, 2048, 512, 1),
                 (1, 14, 1024, 2048, 2)]


@pytest.mark.parametrize("hw, dz, dw", [(56, (14, 9), (8, 8)),
                                        (28, (14, 9), (7, 9)),
                                        (14, (14, 9), (7, 9)),
                                        (7, (7, 18), (7, 9))])
def test_the_3x3_patches_at_resnet50s_widths(hw, dz, dw):
    """The dz pass's 128-pixel and the dW pass's 64-pixel patches of
    the 3x3 at each stage's width: the ones whose halo wastes least."""
    assert tb._patch_tiling(128 * hw, hw, 128)[:2] == dz
    assert tb._patch_tiling(128 * hw, hw, 64)[:2] == dw


@pytest.mark.parametrize("n, h, w, pp", [(2, 7, 7, 128), (3, 7, 7, 64),
                                         (2, 1, 7, 128), (1, 5, 1, 64),
                                         (2, 6, 17, 128), (1, 3, 2, 64)])
def test_patches_cover_every_pixel_once(n, h, w, pp):
    """The patches of the tall image [N H, W] (the images stacked) hold
    every pixel exactly once, none more than ``pp`` pixels."""
    tw, th, cols, patches = tb._patch_tiling(n * h, w, pp)
    assert 1 <= tw <= min(w, 16) and th * tw <= pp and th <= 64
    seen = np.zeros((n * h, w), np.int64)
    for p in range(patches):
        r0, c0 = (p // cols) * th, (p % cols) * tw
        seen[r0:r0 + th, c0:c0 + tw] += 1
    assert (seen == 1).all()
    assert patches == -(-(n * h) // th) * cols


@pytest.mark.parametrize("taps, hw, c, k, stride", RESNET_STAGES)
def test_the_plan_covers_every_chunk_in_whole_splits(taps, hw, c, k,
                                                     stride):
    """At B=128 on a 132-SM card: one dz block per 128 output pixels (the
    3x3: per patch), and splits of the dW chunks that cover them all,
    none empty, each at least 8 chunks where there are enough."""
    n, sms = 128, 132
    ho = hw // stride
    tiles, chunk, splits = tb._bwd_tc_plan(n, hw, hw, c, k, stride, taps,
                                           sms)
    if taps == 9:
        dz = tb._patch_tiling(n * ho, ho, 128)[3]
        dw = tb._patch_tiling(n * ho, ho, 64)[3]
    else:
        dz, dw = -(-n * ho * ho // 128), -(-n * ho * ho // 64)
    assert tiles == dz
    assert chunk * splits >= dw > chunk * (splits - 1)
    assert chunk >= min(8, dw)
    assert splits <= 2 * sms
