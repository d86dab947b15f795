"""The stem's forward pool (deeplearning4j_tpu_torch/nn/layers/stem.py
``stem_pool``, csrc/stem.cu ``fwd_pool``) on the CPU.

The CUDA kernel runs only on the card, so its arithmetic is held here
through a torch mirror of its walk: the plan of
``_stem_fwd_pool_plan``, each warp's strip of pooled rows walked down
with the halo row loaded at the strip's head and the row below carried,
each row reduced over its three window columns (column ``2q - 1`` the
left lane group's ``2q + 1``, the warp's first group loading it) and
then the three rows, the raw window's NaN-propagating maximum and
minimum, and ``relu(max(z(hi), z(lo)))``. The mirror must equal
``stem_pool_plain`` bit for bit (NaN where it is NaN), with channels of
every sign of sc, ±inf and NaN planted in y, and match the JAX ``_pool``
(its Pallas kernel in interpret mode) as
``test_torch_stem.py::test_plain_conv_and_pool_match_the_jax_kernels``
does: f32 within 1e-6 (XLA fuses the multiply-add), bf16 equal but for
1-ulp flips; NaN at the same outputs. The plan test enumerates the grid
as the kernel decomposes it: every pooled output stored once, and every
warp's rows and columns read cover its windows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import stem as js
from deeplearning4j_tpu_torch.nn.layers import stem as ts

from test_torch_bottleneck import DTYPES, _np, assert_bf16_flips
from torch_threads import one_thread  # noqa: F401 (autouse)

#: (n, ho, wo, k): the pool's input y
SHAPES = [(2, 9, 13, 36), (2, 15, 17, 36), (1, 112, 112, 64)]


def _inputs(n, ho, wo, k, dtype, seed=0, nonfinite=False):
    """y, sc, bb: sc of both signs with one zero channel; with
    ``nonfinite`` NaN, +inf and -inf planted in y (the zero channel gets
    an inf too)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, ho, wo, k)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, k).astype(np.float32)
    sc[1::3] *= -1.0
    sc[2] = 0.0
    bb = rng.normal(0, 0.5, k).astype(np.float32)
    if nonfinite:
        flat = y.reshape(-1)
        for value, count in ((np.nan, 7), (np.inf, 5), (-np.inf, 5)):
            flat[rng.choice(flat.size, count, replace=False)] = value
        y[0, 1, 1, 2] = np.inf
    yt = torch.from_numpy(y).to(DTYPES[dtype][0])
    return yt, torch.from_numpy(sc), torch.from_numpy(bb)


def _left(c):
    """The value of the pooled column to the left (the lane group 8
    lanes below; ``__shfl_up_sync``): column q gets q - 1's."""
    return torch.roll(c, 1, dims=1)


def mirror(y, sc, bb, record=None):
    """The kernel's walk in torch, every warp at once along the pooled
    columns (the padded quads, masked as the kernel masks them) and
    channels; ``record`` (a dict) collects the pooled rows stored and
    the image rows read, per strip."""
    n, ho, wo, k = y.shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    plan = ts._stem_fwd_pool_plan(n, ho, wo, k, y.element_size())
    q = torch.arange(plan.quads * 4)
    on = q < pw
    first = q % 4 == 0
    has_a = q > 0
    has_c = 2 * q + 1 < wo
    col_b = torch.where(on, 2 * q, 0)
    col_c = torch.where(has_c & on, 2 * q + 1, 0)
    col_a = torch.where(has_a & on, 2 * q - 1, 0)
    m = lambda t: t[..., None, :, None]   # noqa: E731  [1, Q, 1] masks

    def load_row(r):
        if record is not None:
            record["rows"].append(r)
        row = y[:, r]
        b = row[:, col_b]
        c = torch.where(m(has_c), row[:, col_c], b)
        a = torch.where(m(first & has_a), row[:, col_a], b)
        return a, b, c

    def reduce_row(raw):
        a, b, c = raw
        a = torch.where(m(first), a, torch.where(m(has_a), _left(c), b))
        return (torch.maximum(torch.maximum(a, b), c),
                torch.minimum(torch.minimum(a, b), c))

    out = torch.empty((n, po, pw, k), dtype=y.dtype)
    for strip in range(plan.strips):
        p0 = strip * plan.rows
        up = reduce_row(load_row(2 * p0 - 1)) if p0 > 0 else None
        for p in range(p0, min(p0 + plan.rows, po)):
            has_dn = 2 * p + 1 < ho
            mid = reduce_row(load_row(2 * p))
            dn = reduce_row(load_row(2 * p + 1)) if has_dn else mid
            u = up if p > 0 else mid
            hi = torch.maximum(torch.maximum(u[0], mid[0]), dn[0])
            lo = torch.minimum(torch.minimum(u[1], mid[1]), dn[1])
            up = dn
            z1 = hi.float() * sc + bb
            z2 = lo.float() * sc + bb
            res = torch.clamp_min(torch.maximum(z1, z2), 0.0)
            out[:, p] = res[:, :pw].to(y.dtype)
            if record is not None:
                record["stored"].append(p)
    return out


def assert_bits_equal(got, want):
    """Equal bit for bit outside NaN, NaN at the same elements."""
    nan = torch.isnan(want.float())
    assert torch.equal(torch.isnan(got.float()), nan)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    g, w = got.view(bits[got.dtype]), want.view(bits[want.dtype])
    assert torch.equal(g[~nan], w[~nan])


def _jax_pool(y, sc, bb):
    _, ho, wo, _ = y.shape
    jy = jnp.asarray(y.float().numpy()).astype(
        jnp.bfloat16 if y.dtype == torch.bfloat16 else jnp.float32)
    g = {"po": (ho - 1) // 2 + 1, "pw": (wo - 1) // 2 + 1}
    return js._pool(jy, jnp.asarray(sc.numpy()), jnp.asarray(bb.numpy()),
                    g, True)


def assert_matches_jax(out, jout):
    """The JAX kernel's tolerance (one f32 ulp for XLA's multiply-add;
    bf16 1-ulp flips), NaN at the same outputs."""
    got, want = _np(out), _np(jout)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    same = nan | (got == want)            # NaN, and the infinities
    got, want = np.where(same, 0.0, got), np.where(same, 0.0, want)
    if out.dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        assert_bf16_flips(torch.from_numpy(got), torch.from_numpy(want))


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_kernels_walk_is_the_plain_version_bit_for_bit(shape, dtype,
                                                           nonfinite):
    y, sc, bb = _inputs(*shape, dtype, seed=sum(shape),
                        nonfinite=nonfinite)
    got = mirror(y, sc, bb)
    want = ts.stem_pool(y, sc, bb)            # CPU: the plain version
    assert_bits_equal(got, want)
    if nonfinite:
        assert bool(torch.isnan(want.float()).any())
    assert_matches_jax(got, _jax_pool(y, sc, bb))


def shortcut(y, sc, bb, fault=None):
    """The kernel's arithmetic without its walk: the raw window's
    maximum and minimum (padding that neither extreme takes), then
    ``relu(max(z(hi), z(lo)))``. The card's check plants two faults in
    it: ``max_only`` (z(hi) alone, as if sc were never negative) and
    ``nan_dropped`` (fmaxf / fminf, which drop NaN)."""
    _, ho, wo, _ = y.shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    big, small = (torch.fmax, torch.fmin) if fault == "nan_dropped" else \
        (torch.maximum, torch.minimum)
    hi = lo = None
    for pad, acc, red in ((-float("inf"), "hi", big),
                          (float("inf"), "lo", small)):
        zp = torch.nn.functional.pad(y.float(), (0, 0, 1, 1, 1, 1),
                                     value=pad)
        m = None
        for i in range(3):
            for j in range(3):
                w = zp[:, i:i + 2 * po - 1:2, j:j + 2 * pw - 1:2]
                m = w if m is None else red(m, w)
        hi, lo = (m, lo) if acc == "hi" else (hi, m)
    z1, z2 = hi * sc + bb, lo * sc + bb
    z = z1 if fault == "max_only" else big(z1, z2)
    return big(z, torch.zeros(())).to(y.dtype)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_the_shortcut_needs_both_extremes_and_nan_propagation(dtype):
    """The planted faults of the card's check fail its exact comparison:
    the maximum alone misses the channels with sc < 0, a NaN-dropping
    maximum drops the planted NaN."""
    y, sc, bb = _inputs(2, 15, 17, 36, dtype, seed=5, nonfinite=True)
    want = ts.stem_pool_plain(y, sc, bb)
    assert_bits_equal(shortcut(y, sc, bb), want)
    for fault in ("max_only", "nan_dropped"):
        with pytest.raises(AssertionError):
            assert_bits_equal(shortcut(y, sc, bb, fault), want)
    nan = torch.isnan(want.float())
    assert int(torch.isnan(shortcut(y, sc, bb, "nan_dropped").float())
               .sum()) < int(nan.sum())


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_plain_version_carries_nan_as_the_jax_kernel(dtype):
    y, sc, bb = _inputs(2, 15, 17, 36, dtype, seed=9, nonfinite=True)
    out = ts.stem_pool_plain(y, sc, bb)
    jout = _jax_pool(y, sc, bb)
    assert int(np.isnan(_np(jout)).sum()) > 0
    np.testing.assert_array_equal(np.isnan(_np(out)), np.isnan(_np(jout)))


def test_the_walk_reads_each_image_row_once_a_strip():
    """The mirror's record at 112 x 112: each strip reads its halo row
    (after the first) and its own rows once, and stores each pooled row
    once."""
    y, sc, bb = _inputs(1, 112, 112, 8, "bf16")
    rec = {"rows": [], "stored": []}
    mirror(y, sc, bb, rec)
    assert sorted(rec["stored"]) == list(range(56))
    rows = np.bincount(rec["rows"], minlength=112)
    halo = [2 * 8 * s - 1 for s in range(1, 7)]
    assert all(rows[r] == 2 for r in halo)
    assert all(rows[r] == 1 for r in range(112) if r not in halo)


@pytest.mark.parametrize("shape,itemsize,aligned", [
    ((128, 112, 112, 64), 2, True), ((128, 112, 112, 64), 4, True),
    ((3, 111, 113, 36), 2, True), ((3, 111, 113, 36), 4, True),
    ((3, 8, 9, 36), 2, True), ((3, 9, 13, 34), 4, True),
    ((2, 16, 16, 64), 2, False)])
def test_the_plan_stores_every_output_once_and_covers_its_windows(
        shape, itemsize, aligned):
    n, ho, wo, k = shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    plan = ts._stem_fwd_pool_plan(n, ho, wo, k, itemsize, aligned)
    vector = k % (16 // itemsize) == 0 and aligned
    assert plan.route == ("vector" if vector else "element")
    assert plan.vec == (16 // itemsize if vector else 1)
    chunk = 8 * plan.vec
    assert (plan.grid[1] - 1) * chunk < k <= plan.grid[1] * chunk
    # the grid as the kernel decomposes it: 8 warps a block, quads fastest
    warps = n * plan.strips * plan.quads
    gw = np.arange(plan.grid[0] * 8)
    assert gw.size - 8 < warps <= gw.size
    gw = gw[gw < warps]
    quad, rest = gw % plan.quads, gw // plan.quads
    strip, img = rest % plan.strips, rest // plan.strips
    p = strip[:, None] * plan.rows + np.arange(plan.rows)       # [W, rows]
    q = quad[:, None] * 4 + np.arange(4)                        # [W, 4]
    stored = np.zeros((n, po, pw), np.int64)
    pp = np.broadcast_to(p[:, :, None], (gw.size, plan.rows, 4))
    qq = np.broadcast_to(q[:, None, :], (gw.size, plan.rows, 4))
    ii = np.broadcast_to(img[:, None, None], pp.shape)
    ok = (pp < po) & (qq < pw)
    np.add.at(stored, (ii[ok], pp[ok], qq[ok]), 1)
    assert (stored == 1).all()
    # each warp's rows and columns read cover the windows it stores (the
    # first image's warps: the others repeat them)
    p0 = strip * plan.rows
    for w in np.flatnonzero(img == 0):
        ps = p[w][p[w] < po]
        qs = q[w][q[w] < pw]
        if not ps.size or not qs.size:
            continue
        rows = {2 * p0[w] - 1} if p0[w] > 0 else set()
        rows |= {r for x in ps for r in (2 * x, 2 * x + 1) if r < ho}
        cols = {2 * qs[0] - 1} if qs[0] > 0 else set()
        cols |= {c for x in qs for c in (2 * x, 2 * x + 1) if c < wo}
        for x in ps:
            assert {r for r in (2 * x - 1, 2 * x, 2 * x + 1)
                    if 0 <= r < ho} <= rows
        for x in qs:
            assert {c for c in (2 * x - 1, 2 * x, 2 * x + 1)
                    if 0 <= c < wo} <= cols
