"""The bf16 stem conv's tensor-core route (deeplearning4j_tpu_torch/nn/
layers/csrc/stem.cu ``conv_tc``, its plan and route in ``nn/layers/
stem.py``) against the JAX package's ``_conv_stats``, on the CPU.

- A torch mirror of the kernel's tiling: per 8 x 16-pixel output patch,
  the 22 raw x rows under its s2d halo, rearranged into the 11 x 19 halo
  tile of 16 channels (zeros outside the image and past 4 C); the 16
  taps as shifted windows of the tile, one k16 product each, in f32,
  promoted per tap column (4 taps); the stored y rounded to bf16; each
  block's sums over the stored values in the kernel's order (its 16 row
  groups over its patches, then the groups in order), the blocks' in
  f64. Held against the JAX ``_conv_stats`` in interpret mode at 9x13,
  15x17 and 224x224 (B = 1), C in {1, 3, 4}: y equal but for bf16
  flips (summation order) in under 1% of the elements, each within one
  ulp of its row's largest value (2^-7 of it), checked per
  row (one pixel's channels) and per 64-row tile by ``agreement``
  within the phase's limits (2^-6, 1e-4); the sums within 1e-5
  (``CONV_SUMS``) of each channel's Σ|y| (Σy²: of itself) of the sums
  of the mirror's own stored y, and of JAX's sums but for the flips
  (a flip moves a channel's sum by its size: at 15 x 17 one flip is
  more than 1e-5 of Σ|y|).
- The plan (``_stem_conv_plan``, the mirror of ``conv_tc::geometry``):
  the grid's block rows walk every patch once and every patch's pixels
  inside the image once, on 1 and 132 SMs, at the main shape and the
  ragged ones.
- The route (``stem_conv_route``) is the weight gradient's
  (``stem_dw_route``): bf16 at 4 C <= 16 on the tensor cores, f32 and
  wider inputs on the CUDA cores.
Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import stem as js
from deeplearning4j_tpu_torch.nn.layers import bottleneck as tb
from deeplearning4j_tpu_torch.nn.layers import stem as ts
from deeplearning4j_tpu_torch.nn.layers.flash_attention import agreement

from test_torch_bottleneck import _both, assert_sums_close
from torch_threads import one_thread  # noqa: F401 (autouse)

#: the card's limits on a conv's output and its sums (chip_smoke.py
#: CONV_ROW, CONV_TILE in bf16, CONV_SUMS)
ROW, TILE, CONV_SUMS = 2 ** -6, 1e-4, 1e-5


def _conv_tiling_mirror(x, ws, sms=132):
    """The tensor-core conv's tiling in torch: (y, Σy, Σy²)."""
    n, h, w, c = x.shape
    k = ws.shape[1]
    g = ts.stem_geometry(h, w)
    ho, wo = g["ho"], g["wo"]
    plan = ts._stem_conv_plan(n, h, w, k, sms)
    th, tw = ts._TC_CONV_PATCH
    down, across = plan.grid
    c4 = 4 * c
    wt = torch.zeros(16, 16, k)
    wt[:, :c4] = ws.float().reshape(16, c4, k)
    xf = x.float()
    y = torch.zeros(n, ho, wo, k, dtype=x.dtype)
    parts = []
    for slot in range(plan.tiles):
        groups = torch.zeros(2, 16, k)   # the 16 row groups' sums
        for p in range(slot, plan.patches, plan.tiles):
            img, rem = divmod(p, down * across)
            pr, pc = divmod(rem, across)
            oh0, ow0 = pr * th, pc * tw
            # the raw x rows under the halo (zeros outside the image)
            raw = torch.zeros(2 * (th + 3), 2 * (tw + 3), c)
            r0, q0 = 2 * oh0 - 3, 2 * ow0 - 3
            rs = slice(max(r0, 0), min(r0 + raw.shape[0], h))
            cs = slice(max(q0, 0), min(q0 + raw.shape[1], w))
            raw[rs.start - r0:rs.stop - r0, cs.start - q0:cs.stop - q0] = \
                xf[img, rs, cs]
            # the s2d halo tile: channel (2 pr + pc) C + cc of pixel (hu,
            # hv) is raw[2 hu + pr, 2 hv + pc, cc]
            halo = torch.zeros(th + 3, tw + 3, 16)
            halo[..., :c4] = raw.reshape(th + 3, 2, tw + 3, 2, c) \
                .permute(0, 2, 1, 3, 4).reshape(th + 3, tw + 3, c4)
            tot = torch.zeros(th, tw, k)
            for j in range(4):
                acc = torch.zeros(th, tw, k)
                for i in range(4):
                    acc = acc + halo[i:i + th, j:j + tw] @ wt[4 * i + j]
                tot = tot + acc
            out = tot.to(x.dtype)
            nr, nc = min(th, ho - oh0), min(tw, wo - ow0)
            y[img, oh0:oh0 + nr, ow0:ow0 + nc] = out[:nr, :nc]
            # the epilogue's thread (row group gr) takes pixels gr + 16 jj
            of = torch.where(
                ((torch.arange(th) < nr)[:, None]
                 & (torch.arange(tw) < nc)[None, :])[..., None],
                out.float(), 0.0).reshape(th * tw, k)
            for jj in range(th * tw // 16):
                v = of[16 * jj:16 * jj + 16]
                groups[0] += v
                groups[1] += v * v
        part = torch.zeros(2, k)
        for gr in range(16):
            part += groups[:, gr]
        parts.append(part)
    sums = torch.stack(parts).double().sum(0).float()
    return y, sums[0], sums[1]


def _inputs(n, h, w, c, k, seed):
    rng = np.random.default_rng(seed)
    x = _both(rng.standard_normal((n, h, w, c)), "bf16")
    w7 = _both(rng.standard_normal((k, c, 7, 7)) * np.sqrt(2 / (49 * c)),
               "bf16")
    return x, w7


def _agree(got, want):
    k = got.shape[-1]
    return agreement(got.float().reshape(1, 1, -1, k),
                     torch.as_tensor(np.asarray(want, np.float32))
                     .reshape(1, 1, -1, k))


#: (n, h, w, K): the ragged cases (K a chunk short of 64: masked
#: columns) and the main path's 224 x 224
TILINGS = [(1, 9, 13, 36), (1, 15, 17, 36), (1, 224, 224, 64)]


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("n, h, w, k", TILINGS)
def test_the_stem_conv_tiling_mirror_matches_the_jax_kernel(n, h, w, k, c):
    x, w7 = _inputs(n, h, w, c, k, seed=h * w + c)
    tw = ts.stem_weight_s2d(w7[0])
    y, s1, s2 = _conv_tiling_mirror(x[0], tw)
    g = ts.stem_geometry(h, w)
    jy, js1, js2 = js._conv_stats(x[1], js.stem_weight_s2d(w7[1]), g, True)
    assert tuple(y.shape) == jy.shape and y.dtype == torch.bfloat16
    # flips in under 1% of the elements, each within an ulp of its row's
    # largest value (one that cancels to near 0 flips by more than one of
    # its own ulps)
    yf, jf = y.float().reshape(-1, k), torch.tensor(
        np.asarray(jy, np.float32)).reshape(-1, k)
    assert float(((yf - jf) != 0).float().mean()) < 1e-2
    rowmax = jf.abs().amax(1, keepdim=True)
    assert bool(((yf - jf).abs() <= 2.0 ** -7 * rowmax).all())
    row_rel, tile_rel = _agree(y, jy)
    assert row_rel <= ROW and tile_rel <= TILE, (row_rel, tile_rel)
    # the sums are those of the stored y, in the kernel's order
    assert_sums_close((s1, s2), tb._stats(y), y, rel=CONV_SUMS)
    # and part from JAX's by the flips in y
    flips = (yf - jf).abs().sum(0)
    assert bool(((s1 - torch.tensor(np.asarray(js1))).abs()
                 <= CONV_SUMS * yf.abs().sum(0) + flips).all())
    assert bool(((s2 - torch.tensor(np.asarray(js2))).abs()
                 <= CONV_SUMS * (yf * yf).sum(0)
                 + ((yf * yf) - (jf * jf)).abs().sum(0)).all())
    # the plain version the card holds the kernel against, by its limits
    # (a value that cancels to near 0 flips by more than one of its own
    # ulps under another summation order)
    py, _, _ = ts.stem_conv_plain(x[0], tw)
    row_rel, tile_rel = _agree(y, py.float().numpy())
    assert row_rel <= ROW and tile_rel <= TILE, (row_rel, tile_rel)


#: (n, h, w, K): the main shape at B = 128, the card's ragged cases at B
#: = 3 (223 x 225 and 15 x 17), a K of two column tiles, one image
STEM_CONV_PLANS = [(128, 224, 224, 64), (3, 223, 225, 64), (3, 15, 17, 36),
                   (2, 64, 64, 160), (1, 9, 13, 36)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n, h, w, k", STEM_CONV_PLANS)
def test_the_stem_conv_plan_stores_every_pixel_once(n, h, w, k, sms):
    """The grid's block rows walk the patches q, q + rows, ...: every
    patch once, each patch's 8 x 16 pixels (within the image) once, so
    every output pixel of every image once; the rows (the sums'
    partials) are no more than the patches and fill two blocks an SM
    over the column tiles."""
    g = ts.stem_geometry(h, w)
    plan = ts._stem_conv_plan(n, h, w, k, sms)
    (th, tw), (down, across) = ts._TC_CONV_PATCH, plan.grid
    assert plan.patches == n * down * across
    assert plan.cols == -(-k // ts._TC_CONV_COLS)
    assert 1 <= plan.tiles <= plan.patches
    assert plan.tiles == min(plan.patches, max(1, 2 * sms // plan.cols))
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


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 8])
def test_the_stem_conv_route_is_the_weight_gradients(c):
    for dtype in (torch.bfloat16, torch.float32):
        assert ts.stem_conv_route(dtype, c) == ts.stem_dw_route(dtype, c)
    want = ts.TENSOR_CORES if c <= 4 else ts.CUDA_CORES
    assert ts.stem_conv_route(torch.bfloat16, c) == want
    assert ts.stem_conv_route(torch.float32, c) == ts.CUDA_CORES
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ts.stem_conv_route(torch.float16, c)
