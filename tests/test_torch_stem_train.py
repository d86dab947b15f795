"""The port's fused-stem training (deeplearning4j_tpu_torch/nn/layers/
stem.py: the three backward passes and ``StemTrain``) against the JAX
package's, on the CPU.

- The plain backward versions against the JAX Pallas kernels in
  interpret mode (``_bwd_pool``, ``_bwd_dw``, ``_bwd_dx``), at an even
  and an odd size (16x16, 15x17; C=3, K=8), f32 and bf16, on the same
  inputs. f32: within 1e-5 of each output's largest magnitude (sums in
  other orders; XLA fuses the pool's ``y sc + bb`` into one multiply-add,
  1 ulp of f32). bf16 (the same rounding points): dz0, dy and dx equal
  but for 1-ulp flips in under 1% of the elements; dW and the sums (f32)
  within 1e-5 of the sum of their terms' magnitudes.
- ``fused_stem(train=True)`` (``StemTrain``) against ``jax.vjp`` of the
  JAX ``fused_stem(train=True, interpret=True)``: the output, dx, the
  OIHW dW, dgamma, dbeta (f32 within 1e-5 of each tensor's largest
  magnitude; bf16 equal but for 1-ulp flips in under 5% of the
  elements, two ulps for dx and dW: a sum over pixels, rounded) and the
  decayed running statistics (within 1e-6, the bf16 decay rounding
  included); and against torch autograd of the port's unfused
  ``reference_stem`` in f32 on tie-free data, within 1e-5.
- A tie planted in bf16 (two pixels of one pool window whose f32 values
  differ but round to one bf16 value) sends the window's gradient to
  both, as the JAX kernel does; the maxima compared in f32 send it to
  one.
- The ragged cases of the card's tensor-core checks (9x13 and 15x17,
  C=4, K=36, B=3) for dW and dx; the weight and input gradients' routes
  by dtype, C and K; their grid plans cover every output (dW) and every
  s2d pixel (dx) once, dx's in the fewest rounds.
- The pool backward kernel's tiling, mirrored in torch (each tile's y
  and halo staged, zc once, each window's maximum once, the gather in
  window order): dz0 equal to the plain version's bit for bit and held
  against the JAX ``_bwd_pool`` as above, at conv outputs of 9x13,
  15x17 (tiles cutting windows: the kernel's 8 x 8 windows and 2 x 3)
  and 112x112, bf16 with planted ties and f32; its plan stores every
  pixel once and sizes the partials to its grid.
- The CPU wrappers launch nothing; the backward runs bwd_dx only when x
  needs its gradient.
Inputs come from a numpy seed; bf16 inputs are bf16 values handed to both
packages exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import stem as js
from deeplearning4j_tpu.nn.layers.bottleneck import BnParams as JBn
from deeplearning4j_tpu_torch.nn.layers import stem as ts
from deeplearning4j_tpu_torch.nn.layers.bottleneck import BnParams

from test_torch_bottleneck import _both, _np, assert_bf16_flips
from torch_threads import one_thread  # noqa: F401 (autouse)

SIZES = [(16, 16), (15, 17)]
N, C, K = 2, 3, 8
F32_REL = 1e-5


def _close(got, want, rel=F32_REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def _sums_close(got, want, terms, rel=F32_REL):
    """Each sum within ``rel`` of the sum of its terms' magnitudes."""
    got, want = _np(got), _np(want)
    mag = np.stack([np.abs(_np(t)).reshape(-1, K).sum(0) for t in terms])
    np.testing.assert_array_less(np.abs(got - want), rel * mag + 1e-30)


def _check(got, want, dtype, share=1e-2, ulps=1):
    if dtype == "f32":
        _close(got, want)
    else:
        assert got.dtype == torch.bfloat16
        assert_bf16_flips(got, want, max_share=share, ulps=ulps)


def _rows(rng, *extra):
    """BN rows of a raw conv output drawn with per-channel statistics:
    (sc, bb, inv, mu) and the ``extra`` rows, f32 for both packages."""
    mu, sd = rng.normal(0, 0.3, K), rng.uniform(0.5, 1.5, K)
    gamma, beta = rng.uniform(0.5, 1.5, K), rng.normal(0, 0.3, K)
    inv = 1 / sd
    sc = gamma * inv
    rows = np.stack([sc, beta - mu * sc, inv, mu, *extra]).astype(np.float32)
    return (torch.from_numpy(rows), jnp.asarray(rows)), mu, sd


def _pool_inputs(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    g = ts.stem_geometry(h, w)
    aff, mu, sd = _rows(rng)
    y = _both(mu + sd * rng.standard_normal((N, g["ho"], g["wo"], K)),
              dtype)
    gout = _both(rng.standard_normal((N, g["po"], g["pw"], K)), dtype)
    return g, y, gout, aff


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_bwd_pool_matches_the_jax_kernel(h, w, dtype):
    g, y, gout, aff = _pool_inputs(h, w, dtype, seed=h + w)
    dz, sums = ts.stem_bwd_pool(y[0], gout[0], aff[0])
    jdz, jsums = js._bwd_pool(y[1], gout[1], aff[1], g, True)
    assert tuple(dz.shape) == jdz.shape and dz.dtype == y[0].dtype
    _check(dz, jdz, dtype)
    yhat = (y[0].float() - aff[0][3]) * aff[0][2]
    _sums_close(sums, jsums, [dz, dz.float() * yhat])
    # the sums are those of the stored dz0
    d = dz.float().reshape(-1, K)
    stored = torch.stack([d.sum(0), (d * yhat.reshape(-1, K)).sum(0)])
    _sums_close(sums, stored, [dz, dz.float() * yhat], rel=1e-6)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_bwd_dw_matches_the_jax_kernel(h, w, dtype):
    rng = np.random.default_rng(h * w)
    g = ts.stem_geometry(h, w)
    aff, mu, sd = _rows(rng, rng.normal(0, 0.05, K), rng.normal(0, 0.05, K))
    x = _both(rng.standard_normal((N, h, w, C)), dtype)
    y = _both(mu + sd * rng.standard_normal((N, g["ho"], g["wo"], K)),
              dtype)
    dz = _both(rng.standard_normal((N, g["ho"], g["wo"], K))
               * (rng.uniform(size=(N, g["ho"], g["wo"], K)) > 0.5), dtype)
    dy, dw = ts.stem_bwd_dw(x[0], y[0], dz[0], aff[0])
    jdy, jdw = js._bwd_dw(x[1], y[1], dz[1], aff[1], (64 * C, K), g, True)
    assert tuple(dw.shape) == jdw.shape == (64 * C, K)
    assert dw.dtype == torch.float32 and dy.dtype == y[0].dtype
    _check(dy, jdy, dtype)
    # dW: each entry within 1e-5 of the sum of its terms' magnitudes
    ic = ts._im2col(ts._s2d_image(x[0].float(), g), g)
    mag = _np(ic.abs().t() @ dy.float().abs().reshape(-1, K))
    np.testing.assert_array_less(np.abs(_np(dw) - _np(jdw)),
                                 F32_REL * mag + 1e-30)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", SIZES)
def test_plain_bwd_dx_matches_the_jax_kernel(h, w, dtype):
    rng = np.random.default_rng(h + 2 * w)
    g = ts.stem_geometry(h, w)
    dy = _both(rng.standard_normal((N, g["ho"], g["wo"], K)), dtype)
    w7 = rng.standard_normal((K, C, 7, 7)) * 0.2
    ws = _both(_np(ts.stem_weight_s2d(torch.from_numpy(w7))), dtype)
    dx = ts.stem_bwd_dx(dy[0], ws[0], (N, h, w, C))
    jdx = js._bwd_dx(dy[1], ws[1], (N, h, w, C), g, True)
    assert tuple(dx.shape) == jdx.shape == (N, h, w, C)
    _check(dx, jdx, dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plain_bwd_dw_matches_the_jax_kernel_ragged(dtype):
    """The ragged case of the tensor-core route's checks on the card: an
    odd 9x13 image, C = 4 (RGBA, a tap's 16 channels all real), K = 36
    (no multiple of 8)."""
    n, h, w, c, k = 3, 9, 13, 4, 36
    rng = np.random.default_rng(913)
    g = ts.stem_geometry(h, w)
    mu, sd = rng.normal(0, 0.3, k), rng.uniform(0.5, 1.5, k)
    gamma, beta = rng.uniform(0.5, 1.5, k), rng.normal(0, 0.3, k)
    sc = gamma / sd
    rows = np.stack([sc, beta - mu * sc, 1 / sd, mu, rng.normal(0, 0.05, k),
                     rng.normal(0, 0.05, k)]).astype(np.float32)
    aff = (torch.from_numpy(rows), jnp.asarray(rows))
    x = _both(rng.standard_normal((n, h, w, c)), dtype)
    shape = (n, g["ho"], g["wo"], k)
    y = _both(mu + sd * rng.standard_normal(shape), dtype)
    dz = _both(rng.standard_normal(shape)
               * (rng.uniform(size=shape) > 0.5), dtype)
    dy, dw = ts.stem_bwd_dw(x[0], y[0], dz[0], aff[0])
    jdy, jdw = js._bwd_dw(x[1], y[1], dz[1], aff[1], (64 * c, k), g, True)
    assert tuple(dw.shape) == jdw.shape == (64 * c, k)
    _check(dy, jdy, dtype)
    ic = ts._im2col(ts._s2d_image(x[0].float(), g), g)
    mag = _np(ic.abs().t() @ dy.float().abs().reshape(-1, k))
    np.testing.assert_array_less(np.abs(_np(dw) - _np(jdw)),
                                 F32_REL * mag + 1e-30)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", [(9, 13), (15, 17)])
def test_plain_bwd_dx_matches_the_jax_kernel_ragged(h, w, dtype):
    """The ragged cases of the tensor-core route's checks on the card:
    odd images, C = 4 (RGBA, a tap's 16 outputs all real), K = 36 (no
    multiple of 8: the halo copied element by element), B = 3."""
    n, c, k = 3, 4, 36
    rng = np.random.default_rng(h * w)
    g = ts.stem_geometry(h, w)
    dy = _both(rng.standard_normal((n, g["ho"], g["wo"], k)), dtype)
    w7 = rng.standard_normal((k, c, 7, 7)) * 0.2
    ws = _both(_np(ts.stem_weight_s2d(torch.from_numpy(w7))), dtype)
    dx = ts.stem_bwd_dx(dy[0], ws[0], (n, h, w, c))
    jdx = js._bwd_dx(dy[1], ws[1], (n, h, w, c), g, True)
    assert tuple(dx.shape) == jdx.shape == (n, h, w, c)
    _check(dx, jdx, dtype)


# ---------------------------------------------------------------------
# the tensor-core weight and input gradients' routes and plans (host
# side)
# ---------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8])
def test_the_dw_route_takes_the_tensor_cores_for_bf16_up_to_rgba(c):
    want = ts.TENSOR_CORES if c <= 4 else ts.CUDA_CORES
    assert ts.stem_dw_route(torch.bfloat16, c) == want
    assert ts.stem_dw_route(torch.float32, c) == ts.CUDA_CORES
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ts.stem_dw_route(torch.float16, c)


#: (n, h, w, K): the training shape at B = 128 and the card's ragged
#: cases at B = 3; a K of two column tiles; one image on a 132-SM card
STEM_DW_PLANS = [(128, 224, 224, 64), (3, 9, 13, 36), (3, 15, 17, 36),
                 (2, 64, 64, 160), (1, 32, 32, 64)]


@pytest.mark.parametrize("n, h, w, k", STEM_DW_PLANS)
def test_the_dw_plan_takes_every_output_pixel_once(n, h, w, k):
    """The grid's block rows walk the patches q, q + rows, ...: every
    patch once, each patch's 8 x 16 pixels (within the image) once, so
    every output pixel of every image once; the partials (the rows) are
    no more than the patches and fill the card's SMs over the column
    tiles."""
    sms = 132
    g = ts.stem_geometry(h, w)
    plan = ts._stem_dw_plan(n, h, w, k, sms)
    (th, tw), down, across = ts._TC_DW_PATCH, *plan.grid
    assert plan.patches == n * down * across
    assert plan.cols == -(-k // ts._TC_DW_COLS)
    assert 1 <= plan.tiles <= plan.patches
    assert plan.tiles == min(plan.patches, max(1, sms // plan.cols))
    walked = np.zeros(plan.patches, np.int64)
    for q in range(plan.tiles):
        walked[q::plan.tiles] += 1
    assert (walked == 1).all()
    seen = np.zeros((n, g["ho"], g["wo"]), np.int64)
    for p in range(plan.patches):
        img, rem = divmod(p, down * across)
        r, c = divmod(rem, across)
        seen[img, th * r:th * (r + 1), tw * c:tw * (c + 1)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("c", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("k", [1, 36, 64, 65, 128])
def test_the_dx_route_takes_the_tensor_cores_for_bf16_up_to_rgba_and_k64(
        c, k):
    want = ts.TENSOR_CORES if c <= 4 and k <= 64 else ts.CUDA_CORES
    assert ts.stem_dx_route(torch.bfloat16, c, k) == want
    assert ts.stem_dx_route(torch.float32, c, k) == ts.CUDA_CORES
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ts.stem_dx_route(torch.float16, c, k)


#: (n, h, w): the training shape at B = 128, the card's ragged cases at
#: B = 3, the calibration's B, one image on a 132-SM card, a batch whose
#: patches are not a whole number of rounds
STEM_DX_PLANS = [(128, 224, 224), (3, 9, 13), (3, 15, 17), (16, 224, 224),
                 (1, 32, 32), (7, 100, 60)]


@pytest.mark.parametrize("n, h, w", STEM_DX_PLANS)
def test_the_dx_plan_stores_every_s2d_pixel_once_in_the_fewest_rounds(
        n, h, w):
    """The blocks walk the patches q, q + blocks, ...: every patch once,
    so every s2d pixel that touches the image once (and with it every dx
    pixel: the un-shuffle is one to one); no block takes more patches
    than the fewest rounds a 132-SM card allows, and one block fewer
    would need another round."""
    sms = 132
    plan = ts._stem_dx_plan(n, h, w, sms)
    (th, tw), (down, across) = ts._TC_DX_PATCH, plan.grid
    us, vs = (h + 2) // 2, (w + 2) // 2
    assert plan.patches == n * down * across
    assert plan.rounds == -(-plan.patches // sms)
    assert 1 <= plan.tiles <= sms
    assert -(-plan.patches // plan.tiles) == plan.rounds
    assert -(-plan.patches // (plan.tiles - 1 or 1)) > plan.rounds or \
        plan.tiles == 1
    walked = np.zeros(plan.patches, np.int64)
    for q in range(plan.tiles):
        walked[q::plan.tiles] += 1
    assert (walked == 1).all()
    seen = np.zeros((n, us + 1, vs + 1), np.int64)
    for p in range(plan.patches):
        img, rem = divmod(p, down * across)
        r, c = divmod(rem, across)
        seen[img, 1 + th * r:1 + th * (r + 1),
             1 + tw * c:1 + tw * (c + 1)] += 1
    assert (seen[:, 1:, 1:] == 1).all()
    # the un-shuffle: s2d pixel (u, v), phase (a, b) is dx pixel (2u - 3
    # + a, 2v - 3 + b), so the pixels 1..us x 1..vs cover the image
    rows = {2 * u - 3 + a for u in range(1, us + 1) for a in (0, 1)}
    cols = {2 * v - 3 + b for v in range(1, vs + 1) for b in (0, 1)}
    assert set(range(h)) <= rows and set(range(w)) <= cols


# ---------------------------------------------------------------------
# the pool backward's tiling (csrc/stem_bwd.cu bwd_pool_kernel)
# ---------------------------------------------------------------------
def _pool_tiling_mirror(y, g, aff, windows=ts._POOL_WINDOWS):
    """The pool backward kernel's tiling in torch on the CPU. For each
    tile of ``windows`` pooled windows of each image: the y rows under
    it staged with their halo (one pixel row and column before, two
    after), converted to zc once (relu(y sc + bb) rounded to y's dtype,
    -inf outside the image); the maximum of each window the tile reads
    (its own and the next tile's first row and column) once; then each
    pixel of the tile takes g from the windows that cover it, in window
    order, where its zc ties their maximum, masked by z0 > 0 and stored;
    each tile's sums in f32, the tiles' in f64 in order. Returns (dz0,
    sums, the positions that tie a window's maximum beyond one a
    window)."""
    n, ho, wo, k = y.shape
    po, pw = g.shape[1], g.shape[2]
    wh, ww = windows
    sc, bb, inv, mu = aff
    hh, hw, mh, mw = 2 * wh + 3, 2 * ww + 3, wh + 1, ww + 1
    dz = torch.zeros_like(y)
    parts, ties = [], 0
    for img, tr, tc in np.ndindex(n, -(-po // wh), -(-pw // ww)):
        p0, q0 = tr * wh, tc * ww
        rows = torch.arange(2 * p0 - 1, 2 * p0 - 1 + hh)
        cols = torch.arange(2 * q0 - 1, 2 * q0 - 1 + hw)
        inside = (((rows >= 0) & (rows < ho))[:, None]
                  & ((cols >= 0) & (cols < wo))[None, :])[..., None]
        ys = y[img][rows.clamp(0, ho - 1)][:, cols.clamp(0, wo - 1)]
        z0 = ys.float() * sc + bb
        zc = torch.where(inside, torch.clamp_min(z0, 0.0).to(y.dtype)
                         .float(), -float("inf"))
        views = [zc[i:i + 2 * mh - 1:2, j:j + 2 * mw - 1:2]
                 for i in range(3) for j in range(3)]
        mx = views[0]
        for v in views[1:]:
            mx = torch.maximum(mx, v)
        wa, wb = torch.arange(mh), torch.arange(mw)
        live = ((p0 + wa < po)[:, None] & (q0 + wb < pw)[None, :])[..., None]
        ties += int(((sum((v == mx).int() for v in views) - 1)
                     * live).clamp_min(0).sum())
        gt = g[img][(p0 + wa).clamp(max=po - 1)][:, (q0 + wb)
                                                   .clamp(max=pw - 1)]
        gt = torch.where(live, gt.float(), 0.0)
        own = zc[1:1 + 2 * wh, 1:1 + 2 * ww]
        acc = torch.zeros((2 * wh, 2 * ww, k))
        for t in range(9):
            i, j = divmod(t, 3)
            lr, lc = 2 * wa + i - 1, 2 * wb + j - 1
            ka = (lr >= 0) & (lr < 2 * wh) & (p0 + wa < po)
            kb = (lc >= 0) & (lc < 2 * ww) & (q0 + wb < pw)
            if not (ka.any() and kb.any()):
                continue
            r_, c_ = lr[ka][:, None], lc[kb][None, :]
            a_, b_ = wa[ka][:, None], wb[kb][None, :]
            acc[r_, c_] += torch.where(own[r_, c_] == mx[a_, b_],
                                       gt[a_, b_], 0.0)
        r1, c1 = min(ho, 2 * p0 + 2 * wh), min(wo, 2 * q0 + 2 * ww)
        nr, nc = r1 - 2 * p0, c1 - 2 * q0
        z0o = z0[1:1 + nr, 1:1 + nc]
        d = torch.where(z0o > 0, acc[:nr, :nc], 0.0).to(y.dtype)
        dz[img, 2 * p0:r1, 2 * q0:c1] = d
        yhat = (ys[1:1 + nr, 1:1 + nc].float() - mu) * inv
        df = d.float().reshape(-1, k)
        parts.append(torch.stack([df.sum(0), (df * yhat.reshape(-1, k))
                                  .sum(0)]))
    sums = torch.stack(parts).double().sum(0).float()
    return dz, sums, ties


def _tiling_inputs(n, ho, wo, dtype, seed):
    """y [n, ho, wo, K] with per-channel statistics, g, and the BN rows,
    for both packages; bf16 y on a grid of quarter steps so that window
    maxima tie often (after the affine and the rounding too)."""
    rng = np.random.default_rng(seed)
    aff, mu, sd = _rows(rng)
    draw = rng.standard_normal((n, ho, wo, K))
    if dtype == "bf16":
        draw = np.round(draw * 4) / 4
    y = _both(mu + sd * draw, dtype)
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    gout = _both(rng.standard_normal((n, po, pw, K)), dtype)
    return y, gout, aff


#: (n, ho, wo, windows a tile): the conv outputs of the ragged cases, cut
#: by the kernel's tile and by one of 2 x 3 windows, and the main path's
#: 112 x 112 (7 x 7 tiles)
TILINGS = [(2, 9, 13, (8, 8)), (2, 9, 13, (2, 3)), (2, 15, 17, (8, 8)),
           (2, 15, 17, (2, 3)), (1, 112, 112, (8, 8))]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n, ho, wo, windows", TILINGS)
def test_the_pool_tiling_mirror_matches_the_jax_kernel(n, ho, wo, windows,
                                                       dtype):
    y, gout, aff = _tiling_inputs(n, ho, wo, dtype, seed=ho * wo)
    dz, sums, ties = _pool_tiling_mirror(y[0], gout[0], aff[0], windows)
    pdz, psums = ts.stem_bwd_pool_plain(y[0], gout[0], aff[0])
    assert torch.equal(dz, pdz)
    if dtype == "bf16":
        assert ties > 0
    g = {"po": gout[0].shape[1], "pw": gout[0].shape[2]}
    jdz, jsums = js._bwd_pool(y[1], gout[1], aff[1], g, True)
    _check(dz, jdz, dtype)
    yhat = (y[0].float() - aff[0][3]) * aff[0][2]
    _sums_close(sums, jsums, [dz, dz.float() * yhat])
    _sums_close(sums, psums, [dz, dz.float() * yhat], rel=1e-6)


#: (n, ho, wo, K): the training shape at B = 128, the ragged cases'
#: conv outputs at B = 3 (K = 36), a channel chunk and a half
STEM_POOL_PLANS = [(128, 112, 112, 64), (3, 5, 7, 36), (3, 8, 9, 36),
                   (2, 17, 33, 96), (1, 1, 1, 8)]


@pytest.mark.parametrize("n, ho, wo, k", STEM_POOL_PLANS)
def test_the_pool_plan_stores_every_pixel_once(n, ho, wo, k):
    """Tile (i, j) of each image stores the pixels 16 i .. 16 i + 15 by
    16 j .. 16 j + 15 inside it, and reads the windows 8 i .. 8 i + 8 by
    8 j .. 8 j + 8: every pixel once, every window that covers a stored
    pixel among those read; one partial a tile, so the partials' rows
    are the grid's blocks, and the channel chunks cover K."""
    plan = ts._stem_pool_plan(n, ho, wo, k)
    (wh, ww), (down, across) = ts._POOL_WINDOWS, plan.grid
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    assert plan.tiles == n * down * across
    assert (plan.chunks - 1) * ts._POOL_CHANNELS < k <= \
        plan.chunks * ts._POOL_CHANNELS
    seen = np.zeros((n, ho, wo), np.int64)
    for t in range(plan.tiles):
        img, rem = divmod(t, down * across)
        i, j = divmod(rem, across)
        seen[img, 2 * wh * i:2 * wh * (i + 1), 2 * ww * j:2 * ww * (j + 1)] += 1
        for r in range(2 * wh * i, min(ho, 2 * wh * (i + 1))):
            for p in {r // 2, (r + 1) // 2}:
                assert p >= po or wh * i <= p <= wh * (i + 1)
    assert (seen == 1).all()
    assert -(-po // wh) == down and -(-pw // ww) == across


# ---------------------------------------------------------------------
# the training stem
# ---------------------------------------------------------------------
def _stem_inputs(h, w, dtype, seed, n=N):
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((n, h, w, C)), dtype)
    w7 = _both(rng.standard_normal((K, C, 7, 7)) * np.sqrt(2 / (49 * C)),
               dtype)
    gamma = _both(rng.uniform(0.5, 1.5, K), dtype)
    beta = _both(rng.normal(0, 0.3, K), dtype)
    rm = rng.normal(0, 0.5, K).astype(np.float32)
    rv = rng.uniform(0.5, 2.0, K).astype(np.float32)
    return x, w7, gamma, beta, (rm, rv), rng.standard_normal


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("h,w", SIZES)
def test_stem_train_matches_the_jax_vjp(h, w, dtype):
    x, w7, gamma, beta, (rm, rv), draw = _stem_inputs(h, w, dtype,
                                                      seed=5 * h + w)
    tdt = x[0].dtype
    leaves = [t[0].clone().requires_grad_() for t in (x, w7, gamma, beta)]
    bn = BnParams(leaves[2], leaves[3], torch.from_numpy(rm),
                  torch.from_numpy(rv))
    out, (nm, nv) = ts.fused_stem(leaves[0], leaves[1], bn, train=True)
    gout = _both(draw(tuple(out.shape)), dtype)
    grads = torch.autograd.grad(out, leaves, gout[0])

    def jfn(xx, ww, gg, bb):
        return js.fused_stem(xx, ww, JBn(gg, bb, jnp.asarray(rm),
                                         jnp.asarray(rv)),
                             train=True, interpret=True)

    (jout, (jm, jv)), vjp = jax.vjp(jfn, x[1], w7[1], gamma[1], beta[1])
    jgrads = vjp((gout[1], (jnp.zeros_like(jm), jnp.zeros_like(jv))))
    assert out.dtype == tdt and tuple(out.shape) == jout.shape
    _check(out.detach(), jout, dtype)
    for name, got, want in zip(("dx", "dW", "dgamma", "dbeta"), grads,
                               jgrads):
        assert got.dtype == tdt and tuple(got.shape) == want.shape, name
        _check(got, want, dtype, share=5e-2,
               ulps=2 if name in ("dx", "dW") else 1)
    for got, want in ((nm, jm), (nv, jv)):
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def test_stem_train_matches_autograd_of_the_reference():
    x, w7, gamma, beta, (rm, rv), draw = _stem_inputs(15, 17, "f32", seed=9)
    leaves = [t[0].clone().requires_grad_() for t in (x, w7, gamma, beta)]
    bn = BnParams(leaves[2], leaves[3], torch.from_numpy(rm),
                  torch.from_numpy(rv))
    out, stats = ts.fused_stem(leaves[0], leaves[1], bn, train=True)
    ref, rstats = ts.reference_stem(leaves[0], leaves[1], bn, train=True)
    gout = torch.from_numpy(draw(tuple(out.shape)).astype(np.float32))
    grads = torch.autograd.grad(out, leaves, gout)
    rgrads = torch.autograd.grad(ref, leaves, gout)
    _close(out.detach(), ref.detach())
    for got, want in zip(grads, rgrads):
        _close(got, want)
    for got, want in zip(stats, rstats):
        _close(got, want.detach())


def _tie():
    """One channel, a 4x4 conv output: window (0, 0) holds y = 1 and
    1.0078125 (adjacent bf16 values) at (0, 0) and (1, 1), the rest far
    below; sc = 0.01, bb = 1 map them to 1.01 and 1.0100781 in f32,
    which round to one bf16 value. Only window (0, 0) has a gradient."""
    y = torch.full((1, 4, 4, 1), -50.0)
    y[0, 0, 0, 0], y[0, 1, 1, 0] = 1.0, 1.0078125
    g = torch.zeros((1, 2, 2, 1))
    g[0, 0, 0, 0] = 1.0
    aff = torch.tensor([[0.01], [1.0], [1.0], [0.0]])
    return y.to(torch.bfloat16), g.to(torch.bfloat16), aff


def test_a_bf16_tie_sends_the_gradient_to_both_positions():
    y, g, aff = _tie()
    dz, _ = ts.stem_bwd_pool(y, g, aff)
    jdz, _ = js._bwd_pool(jnp.asarray(y.float().numpy(), jnp.bfloat16),
                          jnp.asarray(g.float().numpy(), jnp.bfloat16),
                          jnp.asarray(aff.numpy()), ts.stem_geometry(7, 7),
                          True)
    want = np.zeros((1, 4, 4, 1))
    want[0, 0, 0, 0] = want[0, 1, 1, 0] = 1.0
    np.testing.assert_array_equal(_np(dz), want)
    np.testing.assert_array_equal(_np(jdz), want)
    # the maxima compared in f32 (not the model dtype) pick one
    z0 = y.float() * aff[0] + aff[1]
    one = ts._pool_grad(torch.clamp_min(z0, 0.0), g.float())
    assert float(one.sum()) == 1.0 and float(one[0, 1, 1, 0]) == 1.0


def test_cpu_wrappers_launch_nothing_and_dx_only_when_needed(monkeypatch):
    x, w7, gamma, beta, (rm, rv), draw = _stem_inputs(16, 16, "f32", seed=1)
    counters = (ts.STEM_CONV, ts.STEM_POOL, ts.STEM_BWD_POOL,
                ts.STEM_BWD_DW, ts.STEM_BWD_DX)
    before = [c.launches for c in counters]
    calls = []
    plain = ts.stem_bwd_dx_plain
    monkeypatch.setattr(ts, "stem_bwd_dx_plain",
                        lambda *a: calls.append(1) or plain(*a))
    w = w7[0].clone().requires_grad_()
    bn = BnParams(gamma[0], beta[0], torch.from_numpy(rm),
                  torch.from_numpy(rv))
    out, _ = ts.fused_stem(x[0], w, bn, train=True)
    (dw,) = torch.autograd.grad(out.sum(), [w])
    assert calls == [] and float(dw.abs().max()) > 0
    xg = x[0].clone().requires_grad_()
    out, _ = ts.fused_stem(xg, w, bn, train=True)
    torch.autograd.grad(out.sum(), [xg])
    assert calls == [1]
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match=r"must be \("):
        ts.stem_bwd_pool(torch.zeros(1, 4, 4, K), torch.zeros(1, 3, 2, K),
                         torch.zeros(4, K))
    with pytest.raises(ValueError, match="do not fit"):
        ts.stem_bwd_dx(torch.zeros(1, 8, 8, K), torch.zeros(64 * C, K),
                       (1, 17, 17, C))


# ---------------------------------------------------------------------
# every kernel library's ctypes signatures against its C entry points
# ---------------------------------------------------------------------
def _libraries():
    """Every CudaLibrary of the port, by name."""
    from deeplearning4j_tpu_torch.cuda_library import CudaLibrary
    from deeplearning4j_tpu_torch.nn.layers import (
        bottleneck, flash_attention, fused, lstm_kernel, stem)
    from deeplearning4j_tpu_torch.serving import paged_kernel
    libs = {}
    for mod in (bottleneck, flash_attention, fused, lstm_kernel, stem,
                paged_kernel):
        for value in vars(mod).values():
            if isinstance(value, CudaLibrary):
                libs[value.name] = value
    return libs


LIBRARIES = ["bottleneck", "bottleneck_bwd", "flash_attention", "fused",
             "lstm", "paged_attention", "stem", "stem_bwd"]


def _kind(param):
    """A C parameter's kind: "ptr", "float" or "int"."""
    p = param.strip()
    if "*" in p:
        return "ptr"
    for kind in ("float", "int"):
        if p.startswith(kind + " "):
            return kind
    raise AssertionError(f"unexpected C parameter {p!r}")


def _argtype_kind(t):
    import ctypes
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "ptr"
    return {ctypes.c_float: "float", ctypes.c_int: "int"}[t]


def _c_entry_points(text):
    """{symbol: its parameter list} of the ``int dl4j_*`` definitions in
    ``text``, those written out and those a ``#define X(NAME, T)`` macro
    stamps out as ``X(dl4j_..., T)``."""
    import re
    flat = text.replace("\\\n", " ")
    defs = {m.group(1): m.group(2) for m in re.finditer(
        r"^int (dl4j_\w+)\(([^)]*)\)\s*\{", flat, re.M)}
    for m in re.finditer(r"#define (\w+)\(NAME, \w+\)\s*int NAME\(([^)]*)\)",
                         flat):
        for use in re.finditer(rf"^{m.group(1)}\((dl4j_\w+),", flat, re.M):
            defs[use.group(1)] = m.group(2)
    return defs


@pytest.mark.parametrize("name", LIBRARIES)
def test_every_entry_point_takes_its_c_parameters(name):
    """Each symbol's ctypes argtypes are its C definition's parameters,
    one for one: a short list passes the trailing stream as a 32-bit int
    (the stem's weight gradient had one argtype too few), which a stream
    handle above 2^31 cannot survive."""
    lib = _libraries()[name]
    defs = _c_entry_points("".join(s.read_text() for s in lib.sources))
    assert set(lib.functions) <= set(defs), set(lib.functions) - set(defs)
    for sym, argtypes in lib.functions.items():
        params = [p for p in defs[sym].split(",") if p.strip()]
        assert [_kind(p) for p in params] == \
            [_argtype_kind(t) for t in argtypes], sym
