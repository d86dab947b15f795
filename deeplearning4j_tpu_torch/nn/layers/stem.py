"""The fused ResNet stem, forward and backward: space-to-depth 7x7/2
conv with its sums, then BN affine + relu + 3x3/2 max pool in one pass,
and the three backward passes.

Counterpart of ``deeplearning4j_tpu/nn/layers/stem.py``. The 7x7/2 conv
over the input zero-padded by 3 is a 4x4/1 conv over the space-to-depth
image (2x2 pixel phases become channels, phase-major), so it is one GEMM
``[ho wo, 64C] @ [64C, K]`` whose contraction matrix is
:func:`stem_weight_s2d`; its kernel emits the per-channel sum and sum of
squares of the stored output. The output stage normalizes, applies relu
and max-pools (3x3/2, pad 1, the padding -inf after the relu) in one
read of the conv output.

The kernels are hand-written CUDA C++ for Hopper: ``csrc/stem.cu`` (the
conv and the pool) replaces the TPU kernels ``_stem_conv_kernel`` and
``_stem_pool_kernel``. The pool reads y once: each warp walks a strip of
pooled rows, reducing the raw y over each window (NaN-propagating maximum
and minimum), and takes ``relu(y sc + bb)`` at the two extremes, which is
exact because that function is monotone in y for either sign of sc; its
grid is planned by :func:`_stem_fwd_pool_plan`. The conv has two routes, :func:`stem_conv_route`:
bf16 at ``4 C <= 16`` runs on the tensor cores (a 16-tap conv in s2d
coordinates over the s2d halo tile of ``csrc/stem_s2d.cuh``, the weight
resident in shared memory; its persistent grid planned by
:func:`_stem_conv_plan`), f32 and wider inputs the implicit GEMM of
``csrc/conv_gemm.cuh``, which builds the im2col from the raw image as it
goes, on the f32 CUDA cores. ``csrc/
stem_bwd.cu`` replaces ``_stem_bwd_pool_kernel`` (the pool and relu
backward with the BN-backward sums: a tiled gather that reads y once,
its grid planned by :func:`_stem_pool_plan`), ``_stem_bwd_dw_kernel``
(the BN backward and the weight gradient) and ``_stem_bwd_dx_kernel``
(the input gradient); the source notes say what bounds each and what its design
does about that. The weight gradient has two routes,
:func:`stem_dw_route`: bf16 at ``4 C <= 16`` (RGB or RGBA input) runs
one pass on the tensor cores (``mma.sync`` tiles over ``csrc/
conv_mma.cuh``; its grid planned by :func:`_stem_dw_plan`), f32 and
wider inputs a dy pass and an f32 CUDA-core GEMM. So has the input
gradient, :func:`stem_dx_route`: bf16 at ``4 C <= 16`` and ``K <= 64``
on the tensor cores (its grid planned by :func:`_stem_dx_plan`), f32
and the rest the f32 CUDA cores. Each wrapper launches
its kernel on CUDA tensors (or raises on what it does not take) and
takes the plain version beside it on CPU tensors, written as the JAX
kernel body over the batch.

Training (``fused_stem(train=True)``) normalizes with the batch
statistics from the conv kernel's sums and differentiates through
:class:`StemTrain`, the counterpart of the JAX ``_stem_core`` with its
``custom_vjp``. As there, the pool backward sends the gradient to EVERY
tied window maximum, compared in the model dtype (XLA's and torch's
max-pool gradients pick one): in bf16 ties are common, so the fused
stem's gradient differs from the unfused plan's there by design.

The gate is the port's own: the JAX package's ``fused_stem_supported``
encodes the TPU's VMEM budget (it refuses the f32 stem at 224x224); the
kernels tile any image, so :func:`fused_stem_supported` asks only for an
NHWC input in f32 or bf16 with at most 192 channels (the input
gradient's kernel keeps the weight in shared memory).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
    _TC_MAX_ELEMENTS, BnParams, _affine, _bn_affine, _dtype_ok, _dw_splits,
    _finalize_stats, _outputs, _rows, _sm_count, _stats, _stream)
from deeplearning4j_tpu_torch.nn.layers.flash_attention import (
    CUDA_CORES, TENSOR_CORES)
from deeplearning4j_tpu_torch.nn.layers.normalization import decayed

__all__ = ["STEM_BWD_DW", "STEM_BWD_DX", "STEM_BWD_POOL", "STEM_CONV",
           "STEM_POOL", "StemTrain", "fused_stem", "fused_stem_supported",
           "reference_stem", "stem_bwd_dw", "stem_bwd_dw_plain",
           "stem_bwd_dx", "stem_bwd_dx_plain", "stem_bwd_pool",
           "stem_bwd_pool_plain", "stem_conv", "stem_conv_plain",
           "stem_conv_route", "stem_dw_route", "stem_dx_route",
           "stem_geometry", "stem_pool", "stem_pool_plain",
           "stem_weight_s2d"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = [_P] * 7 + [_I] * 6 + [_P]
_POOL_ARGS = [_P] * 4 + [_I] * 4 + [_P]
_POOL_PLAN_ARGS = [_I] * 5 + [ctypes.POINTER(ctypes.c_int)]
_BWD_POOL_ARGS = [_P] * 8 + [_I] * 5 + [_P]
_BWD_DW_ARGS = [_P] * 7 + [_I] * 7 + [_P]
_BWD_DW_TC_ARGS = [_P] * 7 + [_I] * 6 + [_P]
_BWD_DX_ARGS = [_P] * 3 + [_I] * 5 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)
#: the input gradient's kernel holds the [64 C, K] weight in 48 KB of
#: shared memory, at least one reduction row of it: C <= 192
_MAX_CHANNELS = 192
#: the bf16 conv's and its weight and input gradients' tensor-core
#: routes: a tap's 4 C channels padded to 16 (RGB or RGBA input)
_TC_MAX_CHANNELS = 4
#: the tensor-core conv's output patch (rows, columns), output channels
#: a block, and blocks an SM (csrc/stem.cu's conv_tc::kCols and its
#: launch bounds; the patch is csrc/stem_s2d.cuh's kTh, kTw)
_TC_CONV_PATCH, _TC_CONV_COLS, _TC_CONV_BLOCKS_PER_SM = (8, 16), 64, 2
#: its output patch (rows, columns) and output channels a block
#: (csrc/stem_bwd.cu's dw_tc::kTh, kTw, kCols)
_TC_DW_PATCH, _TC_DW_COLS = (8, 16), 64
#: the bf16 input gradient's tensor-core route: the s2d weight resident
#: in shared memory, K <= 64 dy channels a halo pixel (dx_tc::kK); its
#: patch of s2d pixels (dx_tc::kTh, kTw)
_TC_DX_MAX_K = 64
_TC_DX_PATCH = (24, 16)
#: the forward pool's walk (csrc/stem.cu's fwd_pool): lanes a pixel,
#: pooled columns a warp, pooled rows a strip, warps a block (kLanes,
#: kCols, kRows, kThreads / 32)
_FWD_POOL_LANES, _FWD_POOL_COLS, _FWD_POOL_ROWS, _FWD_POOL_WARPS = 8, 4, 8, 8
#: the pool backward's tile of pooled windows (rows, columns) and its
#: chunk of channels a block (csrc/stem_bwd.cu's kPoolWh, kPoolWw,
#: kPoolC)
_POOL_WINDOWS, _POOL_CHANNELS = (8, 8), 64


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


def _route_symbols(stem):
    """A backward kernel's entry points by (dtype, route)."""
    return {(torch.float32, CUDA_CORES): f"dl4j_{stem}_f32",
            (torch.bfloat16, CUDA_CORES): f"dl4j_{stem}_bf16",
            (torch.bfloat16, TENSOR_CORES): f"dl4j_{stem}_bf16_mma"}


_LIBRARY = CudaLibrary(
    "stem", ["nn/layers/csrc/stem.cu"],
    {**{s: _CONV_ARGS for s in _route_symbols("stem_conv").values()},
     **{s: _POOL_ARGS for s in _symbols("stem_pool").values()},
     "dl4j_conv_row_tile": [], "dl4j_stem_conv_tc_smem": [],
     "dl4j_stem_conv_kernel_launches": [ctypes.POINTER(ctypes.c_int)],
     "dl4j_stem_pool_plan": _POOL_PLAN_ARGS,
     "dl4j_stem_pool_kernel_launches": [ctypes.POINTER(ctypes.c_int)]},
    headers=["nn/layers/csrc/conv_gemm.cuh", "nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh",
             "nn/layers/csrc/stem_s2d.cuh"])

_BWD_LIBRARY = CudaLibrary(
    "stem_bwd", ["nn/layers/csrc/stem_bwd.cu"],
    {**{s: _BWD_POOL_ARGS for s in _symbols("stem_bwd_pool").values()},
     **{s: _BWD_DW_ARGS for s in _symbols("stem_bwd_dw").values()},
     "dl4j_stem_bwd_dw_bf16_mma": _BWD_DW_TC_ARGS,
     **{s: _BWD_DX_ARGS for s in _route_symbols("stem_bwd_dx").values()},
     "dl4j_stem_bwd_dw_tc_smem": [], "dl4j_stem_bwd_dx_tc_smem": [],
     "dl4j_stem_bwd_pool_smem": [ctypes.POINTER(ctypes.c_int)],
     "dl4j_stem_bwd_dw_kernel_launches": [ctypes.POINTER(ctypes.c_int)],
     "dl4j_stem_bwd_dx_kernel_launches": [ctypes.POINTER(ctypes.c_int)]},
    headers=["nn/layers/csrc/conv_gemm.cuh", "nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh",
             "nn/layers/csrc/stem_s2d.cuh"])

#: the five kernels; each ``.launches`` counts its launches (an entry
#: point that launches a pass and its reduction counts once)
STEM_CONV = CudaKernel(_LIBRARY, "stem_conv", _route_symbols("stem_conv"))
STEM_POOL = CudaKernel(_LIBRARY, "stem_pool", _symbols("stem_pool"))
STEM_BWD_POOL = CudaKernel(_BWD_LIBRARY, "stem_bwd_pool",
                           _symbols("stem_bwd_pool"))
STEM_BWD_DW = CudaKernel(_BWD_LIBRARY, "stem_bwd_dw",
                         _route_symbols("stem_bwd_dw"))
STEM_BWD_DX = CudaKernel(_BWD_LIBRARY, "stem_bwd_dx",
                         _route_symbols("stem_bwd_dx"))


def stem_geometry(h: int, w: int) -> dict:
    """Static geometry of the stem at input ``[*, h, w, *]`` (NHWC), as
    the JAX package computes it: the 7x7/2 conv pads 3; space-to-depth
    needs the padded extent even, so the bottom/right pad is 5 (even) or
    4 (odd); the pool is 3x3/2 pad 1."""
    pad_b = 5 if h % 2 == 0 else 4
    pad_r = 5 if w % 2 == 0 else 4
    hp, wp = h + 3 + pad_b, w + 3 + pad_r
    hs, ws = hp // 2, wp // 2
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1        # conv out
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1      # pool out
    return {"pad_b": pad_b, "pad_r": pad_r, "hp": hp, "wp": wp,
            "hs": hs, "ws": ws, "ho": ho, "wo": wo, "po": po, "pw": pw}


def stem_weight_s2d(w4: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight ``[K, C, 7, 7]`` to the space-to-depth
    contraction matrix ``[64 C, K]``: row ``(i 4 + j) 4C + (pi 2 + pj) C
    + c`` pairs tap (i, j) of the 4x4 conv with pixel phase (pi, pj),
    original tap ``(2i + pi, 2j + pj)`` of the zero-extended 8x8
    kernel."""
    k, c = w4.shape[0], w4.shape[1]
    w8 = torch.nn.functional.pad(w4, (0, 1, 0, 1))       # [K,C,8,8]
    w8 = w8.reshape(k, c, 4, 2, 4, 2)                    # [K,C,i,pi,j,pj]
    return w8.permute(2, 4, 3, 5, 1, 0).reshape(64 * c, k).contiguous()


def stem_conv_route(dtype, c: int) -> str:
    """The conv's route for ``dtype`` and ``c`` input channels:
    TENSOR_CORES for bf16 at ``4 C <= 16`` (each tap's 4 C channels
    padded to one 16-channel row of the s2d halo tile, as the weight
    gradient's route, :func:`stem_dw_route`), else CUDA_CORES (f32
    stays exact f32; wider bf16 inputs take the CUDA-core implicit
    GEMM). Raises on a dtype no route takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"stem_conv kernels take float32 or bfloat16, "
                         f"got {dtype}")
    if dtype == torch.bfloat16 and 1 <= c <= _TC_MAX_CHANNELS:
        return TENSOR_CORES
    return CUDA_CORES


class StemConvPlan(NamedTuple):
    """The tensor-core conv's launch plan, as ``csrc/stem.cu``'s
    ``conv_tc::geometry`` chooses it: ``patches`` output patches of 8 x
    16 pixels (``grid = (down, across)`` an image), ``cols`` column tiles
    of 64 output channels, and ``tiles`` block rows of the grid (the
    sums' partials a channel): row q walks the patches q, q + tiles,
    ..."""
    tiles: int
    patches: int
    cols: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def _stem_conv_plan(n, h, w, k, sms) -> StemConvPlan:
    """The plan for x ``[n, h, w, C]`` to ``k`` channels on a card of
    ``sms`` SMs: two blocks an SM over the column tiles, at most one a
    patch (at least one)."""
    g = stem_geometry(h, w)
    th, tw = _TC_CONV_PATCH
    down, across = -(-g["ho"] // th), -(-g["wo"] // tw)
    patches = n * down * across
    cols = -(-k // _TC_CONV_COLS)
    return StemConvPlan(
        max(1, min(patches, _TC_CONV_BLOCKS_PER_SM * sms // cols)), patches,
        cols, (down, across))


def stem_dw_route(dtype, c: int) -> str:
    """The weight gradient's route for ``dtype`` and ``c`` input
    channels: TENSOR_CORES for bf16 at ``4 C <= 16`` (each tap's 4 C
    channels padded to one 16-channel row), else CUDA_CORES (f32 stays
    exact f32; wider bf16 inputs take the CUDA-core GEMM). Raises on a
    dtype no route takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"stem_bwd_dw kernels take float32 or bfloat16, "
                         f"got {dtype}")
    if dtype == torch.bfloat16 and 1 <= c <= _TC_MAX_CHANNELS:
        return TENSOR_CORES
    return CUDA_CORES


class StemDwPlan(NamedTuple):
    """The tensor-core weight gradient's launch plan, as ``csrc/
    stem_bwd.cu``'s ``dw_tc::geometry`` chooses it: ``patches`` output
    patches of 8 x 16 pixels (``grid = (down, across)`` an image),
    ``cols`` column tiles of 64 output channels, and ``tiles`` block
    rows of the grid (the partials' rows): row q walks the patches q, q
    + tiles, ..."""
    tiles: int
    patches: int
    cols: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def _stem_dw_plan(n, h, w, k, sms) -> StemDwPlan:
    """The plan for x ``[n, h, w, C]`` to ``k`` channels on a card of
    ``sms`` SMs: one block an SM over the column tiles, at most one a
    patch (at least one)."""
    g = stem_geometry(h, w)
    th, tw = _TC_DW_PATCH
    down, across = -(-g["ho"] // th), -(-g["wo"] // tw)
    patches = n * down * across
    cols = -(-k // _TC_DW_COLS)
    return StemDwPlan(max(1, min(patches, sms // cols)), patches, cols,
                      (down, across))


class StemPoolPlan(NamedTuple):
    """The pool backward's launch plan, as ``csrc/stem_bwd.cu``'s
    ``stem_bwd_pool`` chooses it: ``tiles`` blocks of 8 x 8 pooled
    windows (``grid = (down, across)`` an image; tile (i, j) stores the
    pixel rows ``16 i .. 16 i + 15`` and columns ``16 j .. 16 j + 15``
    inside the image), each over ``chunks`` chunks of 64 channels; one
    partial sum a tile and channel, so the partials' rows are
    ``tiles``."""
    tiles: int
    chunks: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def _stem_pool_plan(n, ho, wo, k) -> StemPoolPlan:
    """The plan for y ``[n, ho, wo, k]``."""
    wh, ww = _POOL_WINDOWS
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    down, across = -(-po // wh), -(-pw // ww)
    return StemPoolPlan(n * down * across, -(-k // _POOL_CHANNELS),
                        (down, across))


class StemFwdPoolPlan(NamedTuple):
    """The forward pool's launch plan, as ``csrc/stem.cu``'s
    ``fwd_pool::geometry`` chooses it: ``route`` "vector" (16-byte loads
    and stores, ``vec`` channels a lane: K a whole number of 16-byte
    vectors and y and the output aligned) or "element" (``vec`` 1); a
    warp walks pooled rows ``rows s .. rows s + rows - 1`` (strip s of
    ``strips`` an image) at pooled columns ``4 u .. 4 u + 3`` (quad u of
    ``quads``), 8 warps a block along (image, strip, quad), quads
    fastest; ``grid = (blocks, channel chunks of 8 vec)``."""
    route: str
    vec: int
    strips: int
    quads: int
    rows: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def _stem_fwd_pool_plan(n, ho, wo, k, itemsize, aligned=True
                        ) -> StemFwdPoolPlan:
    """The plan for y ``[n, ho, wo, k]`` of ``itemsize``-byte elements,
    y and the output 16-byte aligned or not."""
    vec = 16 // itemsize
    route = "vector" if k % vec == 0 and aligned else "element"
    vec = vec if route == "vector" else 1
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    strips, quads = -(-po // _FWD_POOL_ROWS), -(-pw // _FWD_POOL_COLS)
    warps = n * strips * quads
    return StemFwdPoolPlan(route, vec, strips, quads, _FWD_POOL_ROWS,
                           (-(-warps // _FWD_POOL_WARPS),
                            -(-k // (_FWD_POOL_LANES * vec))))


def stem_dx_route(dtype, c: int, k: int) -> str:
    """The input gradient's route for ``dtype``, ``c`` input channels
    and ``k`` output channels: TENSOR_CORES for bf16 at ``4 C <= 16``
    and ``1 <= K <= 64`` (a tap's 4 C outputs padded to 16, a halo
    pixel's K channels to 64), else CUDA_CORES (f32 stays exact f32).
    Raises on a dtype no route takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"stem_bwd_dx kernels take float32 or bfloat16, "
                         f"got {dtype}")
    if dtype == torch.bfloat16 and 1 <= c <= _TC_MAX_CHANNELS and \
            1 <= k <= _TC_DX_MAX_K:
        return TENSOR_CORES
    return CUDA_CORES


class StemDxPlan(NamedTuple):
    """The tensor-core input gradient's launch plan, as ``csrc/
    stem_bwd.cu``'s ``dx_tc::geometry`` chooses it: ``patches`` patches
    of 24 x 16 s2d pixels (``grid = (down, across)`` an image, over the
    s2d pixels ``1 <= u <= (h + 2) // 2``, ``1 <= v <= (w + 2) // 2``
    that touch the image), walked by ``tiles`` blocks in ``rounds``
    rounds: block q takes the patches q, q + tiles, ..."""
    tiles: int
    patches: int
    rounds: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=64)
def _stem_dx_plan(n, h, w, sms) -> StemDxPlan:
    """The plan for dx ``[n, h, w, C]`` on a card of ``sms`` SMs: the
    fewest rounds one block an SM allows, then the fewest blocks that
    keep them."""
    th, tw = _TC_DX_PATCH
    down, across = -(-((h + 2) // 2) // th), -(-((w + 2) // 2) // tw)
    patches = n * down * across
    rounds = -(-patches // sms)
    tiles = -(-patches // rounds) if rounds else 0
    return StemDxPlan(tiles, patches, rounds, (down, across))


def fused_stem_supported(x_shape, n_out: int, dtype) -> bool:
    """Whether the kernels take this stem: NHWC ``[N, H, W, C]`` in f32
    or bf16, ``C <= 192``. Any size fits (the JAX gate's VMEM budget does
    not apply)."""
    return len(x_shape) == 4 and x_shape[3] <= _MAX_CHANNELS and \
        _dtype_ok(dtype)


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def _check(name, **tensors):
    """Raise on what a kernel does not take: the first tensor sets the
    device and dtype; ``sc``, ``bb`` and ``aff`` are f32."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{first.device}")
    if first.dtype not in _DTYPES:
        raise ValueError(f"{name} kernel takes f32 or bf16, got "
                         f"{first.dtype}")
    for key, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{first.device}")
        want = torch.float32 if key in ("sc", "bb", "aff") else first.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def stem_conv(x, w):
    """The stem conv: x ``[N, H, W, C]``, w the ``[64 C, K]`` matrix of
    :func:`stem_weight_s2d`. Returns ``(y, Σy, Σy²)``, y ``[N, ho, wo,
    K]`` in x's dtype, the sums ``[K]`` f32 over the stored y. The kernel
    of :func:`stem_conv_route` on CUDA tensors, :func:`stem_conv_plain`
    on CPU tensors."""
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != 64 * x.shape[3]:
        raise ValueError(f"stem_conv: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} [64 C, K]")
    if x.device.type == "cpu":
        return stem_conv_plain(x, w)
    _check("stem_conv", x=x, w=w)
    n, h, wd, c = x.shape
    k = w.shape[1]
    g = stem_geometry(h, wd)
    route = stem_conv_route(x.dtype, c)
    tiles = None
    if route == TENSOR_CORES:
        if max(x.numel(), n * g["ho"] * g["wo"] * k, 64 * c * k) \
                >= _TC_MAX_ELEMENTS:
            raise ValueError(f"stem_conv: the bf16 kernel indexes with "
                             f"32-bit ints; x, y and w must each hold "
                             f"fewer than {_TC_MAX_ELEMENTS} elements")
        tiles = _stem_conv_plan(n, h, wd, k, _sm_count(x.device)).tiles
    y, part, tiles, sums = _outputs(_LIBRARY, x, n, g["ho"], g["wo"], k,
                                    tiles)
    if y.numel():
        STEM_CONV.launch((x.dtype, route), x.data_ptr(), w.data_ptr(),
                         y.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), sums[0].data_ptr(),
                         sums[1].data_ptr(), n, h, wd, c, k, tiles,
                         _stream(x))
    return y, sums[0], sums[1]


def stem_pool(y, sc, bb):
    """The output stage: ``maxpool3x3/2,pad1(relu(y sc + bb))``, the
    affine and relu in f32 and the padding -inf after the relu; y ``[N,
    ho, wo, K]``, sc and bb ``[K]`` f32; the output in y's dtype. The
    kernel on CUDA tensors, :func:`stem_pool_plain` on CPU tensors."""
    if y.dim() != 4 or tuple(sc.shape) != (y.shape[3],) or \
            tuple(bb.shape) != (y.shape[3],):
        raise ValueError(f"stem_pool: y {tuple(y.shape)} must be NHWC with "
                         f"sc, bb [K]")
    if y.device.type == "cpu":
        return stem_pool_plain(y, sc, bb)
    _check("stem_pool", y=y, sc=sc, bb=bb)
    n, ho, wo, k = y.shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    out = torch.empty((n, po, pw, k), dtype=y.dtype, device=y.device)
    if out.numel():
        STEM_POOL.launch(y.dtype, y.data_ptr(), sc.data_ptr(), bb.data_ptr(),
                         out.data_ptr(), n, ho, wo, k, _stream(y))
    return out


def _nhwc4(name, **tensors):
    for key, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{name}: {key} must be NHWC, got "
                             f"{tuple(t.shape)}")


def stem_bwd_pool(y, g, aff):
    """The pool and relu backward: y ``[N, ho, wo, K]`` the raw conv
    output, g ``[N, po, pw, K]`` the pooled output's gradient in y's
    dtype, aff ``[4, K]`` f32 rows (sc, bb, inv, mu). Every window sends
    its gradient to every position whose ``relu(y sc + bb)``, rounded to
    y's dtype, ties its maximum; the relu' mask on the unrounded ``y sc
    + bb``. Returns ``(dz0, sums)``: dz0 ``[N, ho, wo, K]`` in y's dtype
    and sums ``[2, K]`` f32, ``(Σdz0, Σdz0 ŷ)`` over the stored dz0, ``ŷ
    = (y - mu) inv``. The kernel on CUDA tensors,
    :func:`stem_bwd_pool_plain` on CPU tensors."""
    _nhwc4("stem_bwd_pool", y=y, g=g)
    n, ho, wo, k = y.shape
    want = (n, (ho - 1) // 2 + 1, (wo - 1) // 2 + 1, k)
    if tuple(g.shape) != want or tuple(aff.shape) != (4, k):
        raise ValueError(f"stem_bwd_pool: g {tuple(g.shape)} and aff "
                         f"{tuple(aff.shape)} must be {want} and (4, {k})")
    if y.device.type == "cpu":
        return stem_bwd_pool_plain(y, g, aff)
    _check("stem_bwd_pool", y=y, g=g, aff=aff)
    f32 = torch.float32
    dz = torch.empty_like(y)
    sums = torch.zeros((2, k), dtype=f32, device=y.device)
    if not dz.numel():
        return dz, sums
    tiles = _stem_pool_plan(n, ho, wo, k).tiles
    part = torch.empty((2, k, tiles), dtype=f32, device=y.device)
    STEM_BWD_POOL.launch(y.dtype, y.data_ptr(), g.data_ptr(), aff.data_ptr(),
                         dz.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), sums[0].data_ptr(),
                         sums[1].data_ptr(), n, ho, wo, k, tiles, _stream(y))
    return dz, sums


def stem_bwd_dw(x, y, dz, aff):
    """The BN backward and the weight gradient: x ``[N, H, W, C]`` the
    stem's input, y and dz ``[N, ho, wo, K]`` the raw conv output and
    dz0 (y's dtype), aff ``[6, K]`` f32 rows (sc, bb, inv, mu, m1, m2).
    Returns ``(dy, dW)``: ``dy = sc (dz0 - m1 - ŷ m2)`` in f32, stored in
    y's dtype; dW ``[64 C, K]`` f32, the space-to-depth window of x
    against the stored dy, summed over the pixels. The kernel on CUDA
    tensors, :func:`stem_bwd_dw_plain` on CPU tensors."""
    _nhwc4("stem_bwd_dw", x=x, y=y, dz=dz)
    n, h, wd, c = x.shape
    g = stem_geometry(h, wd)
    k = y.shape[3]
    want = (n, g["ho"], g["wo"], k)
    if tuple(y.shape) != want or tuple(dz.shape) != want or \
            tuple(aff.shape) != (6, k):
        raise ValueError(f"stem_bwd_dw: y {tuple(y.shape)}, dz "
                         f"{tuple(dz.shape)} and aff {tuple(aff.shape)} "
                         f"must be {want}, {want} and (6, {k})")
    if x.device.type == "cpu":
        return stem_bwd_dw_plain(x, y, dz, aff)
    _check("stem_bwd_dw", x=x, y=y, dz=dz, aff=aff)
    route = stem_dw_route(x.dtype, c)
    if route == TENSOR_CORES and max(x.numel(), y.numel(), 64 * c * k) \
            >= _TC_MAX_ELEMENTS:
        raise ValueError(f"stem_bwd_dw: the bf16 kernel indexes with "
                         f"32-bit ints; x, y and dW must each hold fewer "
                         f"than {_TC_MAX_ELEMENTS} elements")
    f32 = torch.float32
    dy = torch.empty_like(y)
    dw = torch.zeros((64 * c, k), dtype=f32, device=x.device)
    rows = n * g["ho"] * g["wo"]
    if not (rows and c and k):
        return dy, dw
    if route == TENSOR_CORES:
        tiles = _stem_dw_plan(n, h, wd, k, _sm_count(x.device)).tiles
        split = [tiles]
    else:
        chunk, tiles = _dw_splits(rows, -(-(64 * c) // 128) * -(-k // 64),
                                  x.device)
        split = [chunk, tiles]
    dw_part = torch.empty((tiles, 64 * c, k), dtype=f32, device=x.device)
    STEM_BWD_DW.launch((x.dtype, route), x.data_ptr(), y.data_ptr(),
                       dz.data_ptr(), aff.data_ptr(), dy.data_ptr(),
                       dw.data_ptr(), dw_part.data_ptr(), n, h, wd, c, k,
                       *split, _stream(x))
    return dy, dw


def stem_bwd_dx(dy, w, x_shape):
    """The input gradient: dy ``[N, ho, wo, K]``, w the ``[64 C, K]``
    matrix of :func:`stem_weight_s2d` in dy's dtype, x_shape the input's
    ``(N, H, W, C)``. Returns dx ``[N, H, W, C]`` in dy's dtype, the
    transposed 4x4 correlation in space-to-depth coordinates un-shuffled
    to pixels, f32 sums rounded once. The kernel of
    :func:`stem_dx_route` on CUDA tensors, :func:`stem_bwd_dx_plain` on
    CPU tensors."""
    n, h, wd, c = (int(v) for v in x_shape)
    g = stem_geometry(h, wd)
    _nhwc4("stem_bwd_dx", dy=dy)
    k = dy.shape[3]
    if tuple(dy.shape) != (n, g["ho"], g["wo"], k) or \
            tuple(w.shape) != (64 * c, k):
        raise ValueError(f"stem_bwd_dx: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} do not fit x {tuple(x_shape)}")
    if dy.device.type == "cpu":
        return stem_bwd_dx_plain(dy, w, x_shape)
    if c > _MAX_CHANNELS:
        raise ValueError(f"stem_bwd_dx: the kernel takes at most "
                         f"{_MAX_CHANNELS} input channels, got {c}")
    _check("stem_bwd_dx", dy=dy, w=w)
    route = stem_dx_route(dy.dtype, c, k)
    if route == TENSOR_CORES and max(dy.numel(), n * h * wd * c) \
            >= _TC_MAX_ELEMENTS:
        raise ValueError(f"stem_bwd_dx: the bf16 kernel indexes with "
                         f"32-bit ints; dy and dx must each hold fewer "
                         f"than {_TC_MAX_ELEMENTS} elements")
    dx = torch.empty((n, h, wd, c), dtype=dy.dtype, device=dy.device)
    if dx.numel():
        STEM_BWD_DX.launch((dy.dtype, route), dy.data_ptr(), w.data_ptr(),
                           dx.data_ptr(), n, h, wd, c, k, _stream(dy))
    return dx


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------
def _s2d_image(xf, g):
    """``[N, h, w, c]`` f32 to the padded space-to-depth grid ``[N, hs,
    ws, 4c]`` (pixel phases as channels, phase-major)."""
    n, _, _, c = xf.shape
    p = torch.nn.functional.pad(xf, (0, 0, 3, g["pad_r"], 3, g["pad_b"]))
    return p.reshape(n, g["hs"], 2, g["ws"], 2, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(n, g["hs"], g["ws"], 4 * c)


def _im2col(s, g):
    """The s2d grid to the im2col ``[N ho wo, 64 c]``, tap-major column
    blocks."""
    ho, wo = g["ho"], g["wo"]
    cols = [s[:, i:i + ho, j:j + wo, :].reshape(-1, s.shape[3])
            for i in range(4) for j in range(4)]
    return torch.cat(cols, dim=1)


def stem_conv_plain(x, w):
    """The plain PyTorch version of :func:`stem_conv`: the s2d im2col in
    f32, rounded to w's dtype, one f32 matmul, rounded to x's dtype; sums
    over the stored output."""
    n, h, wd, _ = x.shape
    g = stem_geometry(h, wd)
    ic = _im2col(_s2d_image(x.float(), g), g).to(w.dtype).float()
    y = (ic @ w.float()).to(x.dtype).reshape(n, g["ho"], g["wo"],
                                             w.shape[1])
    return (y, *_stats(y))


def stem_pool_plain(y, sc, bb):
    """The plain PyTorch version of :func:`stem_pool`: relu of the f32
    affine, padded by one with -inf, the max over the nine strided
    window views, rounded to y's dtype."""
    _, ho, wo, _ = y.shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    z = torch.clamp_min(y.float() * sc + bb, 0.0)
    zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1), value=-float("inf"))
    out = None
    for i in range(3):
        for j in range(3):
            win = zp[:, i:i + 2 * po - 1:2, j:j + 2 * pw - 1:2, :]
            out = win if out is None else torch.maximum(out, win)
    return out.to(y.dtype)


def _pool_grad(zc, g):
    """The 3x3/2 pad-1 max pool's gradient as the TPU kernel takes it:
    zc ``[N, ho, wo, K]`` and g ``[N, po, pw, K]`` f32; every window
    sends g to every position equal to its maximum (over the -inf
    padding), the windows' shares added in the kernel's order of window
    offsets. Returns dz ``[N, ho, wo, K]`` f32."""
    n, ho, wo, k = zc.shape
    po, pw = g.shape[1], g.shape[2]
    zp = torch.nn.functional.pad(zc, (0, 0, 1, 1, 1, 1),
                                 value=-float("inf"))
    wins = [zp[:, i:i + 2 * po - 1:2, j:j + 2 * pw - 1:2, :]
            for i in range(3) for j in range(3)]
    m = wins[0]
    for win in wins[1:]:
        m = torch.maximum(m, win)
    acc = torch.zeros((n, ho + 2, wo + 2, k), dtype=torch.float32,
                      device=zc.device)
    for t, win in enumerate(wins):
        i, j = divmod(t, 3)
        acc[:, i:i + 2 * po - 1:2, j:j + 2 * pw - 1:2, :] += \
            torch.where(win == m, g, 0.0)
    return acc[:, 1:1 + ho, 1:1 + wo, :]


def stem_bwd_pool_plain(y, g, aff):
    """The plain PyTorch version of :func:`stem_bwd_pool`, written as the
    JAX ``_stem_bwd_pool_kernel``: z0 in f32, the window maxima compared
    on relu(z0) rounded to y's dtype, the mask on z0, dz0 stored, the
    sums over the stored values."""
    sc, bb, inv, mu = aff
    k = y.shape[3]
    yf = y.float()
    z0 = yf * sc + bb
    zc = torch.clamp_min(z0, 0.0).to(y.dtype).float()
    dz0 = torch.where(z0 > 0, _pool_grad(zc, g.float()), 0.0).to(y.dtype)
    d = dz0.float().reshape(-1, k)
    yhat = ((yf - mu) * inv).reshape(-1, k)
    return dz0, torch.stack([d.sum(0), (d * yhat).sum(0)])


def stem_bwd_dw_plain(x, y, dz, aff):
    """The plain PyTorch version of :func:`stem_bwd_dw`, written as the
    JAX ``_stem_bwd_dw_kernel``: dy op by op in f32, rounded to y's dtype;
    dW one f32 matmul of the s2d im2col (x rounded to y's dtype) against
    the rounded dy."""
    sc, _, inv, mu, m1, m2 = aff
    n, h, wd, _ = x.shape
    g = stem_geometry(h, wd)
    yhat = (y.float() - mu) * inv
    dy = (sc * (dz.float() - m1 - yhat * m2)).to(y.dtype)
    ic = _im2col(_s2d_image(x.float(), g), g).to(y.dtype).float()
    return dy, ic.t() @ dy.float().reshape(-1, y.shape[3])


def stem_bwd_dx_plain(dy, w, x_shape):
    """The plain PyTorch version of :func:`stem_bwd_dx`, written as the
    JAX ``_stem_bwd_dx_kernel``: dy padded in s2d coordinates, sixteen
    f32 tap products against w's tap blocks summed in tap order, the
    un-shuffle and the crop, rounded to dy's dtype."""
    n, h, wd, c = (int(v) for v in x_shape)
    g = stem_geometry(h, wd)
    hs, ws, ho, wo = g["hs"], g["ws"], g["ho"], g["wo"]
    k, c4 = dy.shape[3], 4 * c
    dyp = torch.nn.functional.pad(dy.float(),
                                  (0, 0, 3, ws - wo, 3, hs - ho))
    wf = w.float()
    acc = None
    for t in range(16):
        i, j = divmod(t, 4)
        gs = dyp[:, 3 - i:3 - i + hs, 3 - j:3 - j + ws, :] \
            .reshape(n, hs * ws, k).to(w.dtype).float()
        tap = gs @ wf[t * c4:(t + 1) * c4].t()
        acc = tap if acc is None else acc + tap
    p = acc.reshape(n, hs, ws, 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * hs, 2 * ws, c)
    return p[:, 3:3 + h, 3:3 + wd, :].to(dy.dtype)


# ---------------------------------------------------------------------
# the stem
# ---------------------------------------------------------------------
class StemTrain(torch.autograd.Function):
    """The training stem: the JAX ``_stem_core`` with its ``custom_vjp``.

    ``apply(eps, x, ws, gamma, beta)``, ws the ``[64 C, K]`` matrix of
    :func:`stem_weight_s2d`, returns ``(out, mean, var)``: the conv
    kernel, the batch statistics from its sums over ``count = N ho wo``,
    the affine, the pool kernel. The statistics are non-differentiable
    outputs (the JAX vjp ignores their cotangents; they feed the running
    averages only). x, the raw conv output y, the statistics and the
    weights are saved; the backward runs bwd_pool, bwd_dw and, only when
    x needs its gradient, bwd_dx."""

    @staticmethod
    def forward(ctx, eps, x, ws, gamma, beta):
        n, h, wd, _ = x.shape
        g = stem_geometry(h, wd)
        count = n * g["ho"] * g["wo"]
        y, s1, s2 = stem_conv(x, ws)
        mean, var = _finalize_stats(s1, s2, count)
        sc, bb, _ = _affine(gamma, beta, mean, var, eps)
        out = stem_pool(y, sc.float().contiguous(), bb.float().contiguous())
        ctx.eps, ctx.count = eps, count
        ctx.save_for_backward(x, y, ws, gamma, beta, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, gout, *_stat_grads):
        x, y, ws, gamma, beta, mean, var = ctx.saved_tensors
        sc, bb, inv = _affine(gamma, beta, mean, var, ctx.eps)
        dz0, sums = stem_bwd_pool(y, gout.to(y.dtype).contiguous(),
                                  _rows(sc, bb, inv, mean))
        aff_k = _rows(sc, bb, inv, mean, sums[0] / ctx.count,
                      sums[1] / ctx.count)
        dy, dw = stem_bwd_dw(x, y, dz0, aff_k)
        dx = stem_bwd_dx(dy, ws, x.shape) if ctx.needs_input_grad[1] \
            else None
        return (None, dx, dw.to(ws.dtype), sums[1].to(gamma.dtype),
                sums[0].to(beta.dtype))


def fused_stem(x, w, bn: BnParams, *, train: bool, eps: float = 1e-5,
               decay: float = 0.9
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The fused ResNet stem. x ``[N, H, W, C]`` NHWC raw input; w the
    OIHW conv weight ``[K, C, 7, 7]`` (rearranged here, so the parameter
    keeps its layout and its gradient) or its :func:`stem_weight_s2d`
    matrix ``[64 C, K]`` (a caller that keeps the rearranged copy).
    Zero-pad 3, 7x7/2 conv (no bias), BN, relu, 3x3/2 pad-1 max pool.

    Returns ``(out, (running mean, running var))``. Training
    (``train=True``) normalizes with the batch statistics, differentiates
    through :class:`StemTrain`, and decays the running statistics as the
    unfused ``BatchNormalization`` does, ``decay * old + (1 - decay) *
    batch`` with ``decay * old`` rounded in x's dtype (``normalization.
    decayed``), f32. Inference uses the running statistics and returns
    them unchanged."""
    ws = stem_weight_s2d(w) if w.dim() == 4 else w
    if train:
        out, mean, var = StemTrain.apply(eps, x, ws, bn.gamma, bn.beta)
        return out, (decayed(bn.running_mean.to(x.dtype), mean,
                             decay).float(),
                     decayed(bn.running_var.to(x.dtype), var,
                             decay).float())
    sc, bb = _bn_affine(bn, eps)
    y, _, _ = stem_conv(x, ws)
    return stem_pool(y, sc, bb), (bn.running_mean, bn.running_var)


def reference_stem(x, w, bn: BnParams, *, train, eps=1e-5, decay=0.9):
    """The unfused composition with the same semantics (the JAX
    package's ``reference_stem``): pad-3 7x7/2 conv in f32, BN (batch
    statistics under ``train``), relu rounded to x's dtype, 3x3/2 pad-1
    max pool. Returns ``(out, new running (mean, var))``."""
    F = torch.nn.functional
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), stride=2,
                 padding=3).permute(0, 2, 3, 1).to(x.dtype)
    yf = y.float()
    if train:
        mean = yf.mean(dim=(0, 1, 2))
        var = torch.clamp_min((yf * yf).mean(dim=(0, 1, 2)) - mean * mean,
                              0.0)
    else:
        mean, var = bn.running_mean, bn.running_var
    z = (yf - mean) * torch.rsqrt(var + eps) * bn.gamma.float() \
        + bn.beta.float()
    z = torch.clamp_min(z, 0.0).to(x.dtype)
    out = F.max_pool2d(z.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    if not train:
        return out, (bn.running_mean, bn.running_var)
    new_mean = decay * bn.running_mean.to(x.dtype).float() \
        + (1 - decay) * mean
    new_var = decay * bn.running_var.to(x.dtype).float() + (1 - decay) * var
    return out, (new_mean, new_var)
