"""The fused ResNet bottleneck, forward and backward: the CUDA kernels'
wrappers, their plain PyTorch versions, and the block built from them.

Counterpart of ``deeplearning4j_tpu/nn/layers/bottleneck.py``: the
bottleneck conv1x1 -> BN -> relu -> conv3x3 -> BN -> relu -> conv1x1 ->
BN -> (+ residual) -> relu as a chain of conv kernels, each applying the
previous BN's affine and relu as the PROLOGUE of its input and emitting
its output's per-channel sum and sum of squares as its EPILOGUE. NHWC
throughout; identity blocks (stride 1, identity skip) and downsample
entry blocks (stride on conv_a and on a conv shortcut with its own BN).

The forward kernels are hand-written CUDA C++ for Hopper, ``csrc/
bottleneck.cu``; they replace the TPU kernels ``_fwd1x1_kernel`` and
``_fwd3x3_kernel``, in bf16 on the tensor cores (``csrc/
conv_fwd_tc.cuh``, shared with the fused bn -> act -> 1x1 forward, over
``csrc/conv_mma.cuh``: ``mma.sync`` tiles staged through the activation
prologue, planned here by :func:`_fwd_tc_plan`), in f32 on the CUDA
cores over the implicit GEMM of ``csrc/conv_gemm.cuh``. The backward
kernels, ``csrc/bottleneck_bwd.cu``, replace ``_bwd1x1_kernel`` and
``_bwd3x3_kernel``: one entry point per stage computes the stage's dW,
the previous stage's dz0 and that stage's BN-backward sums, in bf16 on
the tensor cores (staged through the BN-backward and activation
prologues, planned by :func:`_bwd_tc_plan`), in f32 on the CUDA cores
over ``conv_gemm.cuh``'s tiles (the source notes say what bounds each
kernel and what its design does about that). The JAX package's channel-
split variant of the backward (grid ``(split, n)``) exists only for the
TPU's VMEM budget and is not ported: the CUDA kernels tile any shape.
Each wrapper dispatches on where its tensors lie: CUDA tensors launch
the kernel (or raise on what it does not take), CPU tensors take the
plain version beside it, written as the JAX kernel body (f32 products of
dtype-rounded operands, the same rounding points). There is no fallback
from the kernel to the plain version.

Training (``fused_bottleneck(train=True)``) takes the batch statistics
from the forward kernels' sums and differentiates the block with
:class:`BottleneckTrain`, the ``torch.autograd.Function`` counterpart of
the JAX ``custom_vjp`` (``_bottleneck_core`` / ``_bottleneck_ds_core``):
its backward recomputes the f32 tail from the saved raw conv outputs and
runs stages c, b, a (and the conv shortcut) through the backward
kernels.

The gate is the port's own. The JAX package's
``fused_bottleneck_supported`` encodes the TPU's VMEM budget (whole
images and weights resident per grid step); these kernels tile any
image, so :func:`fused_bottleneck_supported` refuses only what they do
not take: a stride other than 1 or 2, a height or width the stride does
not divide, a dtype other than f32 or bf16.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.nn.layers.normalization import decayed

__all__ = ["BWD1X1", "BWD3X3", "BnParams", "BottleneckTrain", "CONV1X1",
           "CONV3X3", "conv1x1", "conv1x1_bwd", "conv1x1_bwd_plain",
           "conv1x1_plain", "conv3x3", "conv3x3_bwd", "conv3x3_bwd_plain",
           "conv3x3_plain", "fused_bottleneck", "fused_bottleneck_supported",
           "reference_bottleneck"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV1X1_ARGS = [_P] * 9 + [_I] * 8 + [_P]
_CONV3X3_ARGS = [_P] * 9 + [_I] * 7 + [_P]
_CONV_TC_SMEM_ARGS = [_I] * 6
_BWD1X1_ARGS = [_P] * 13 + [_I] * 10 + [_P]
_BWD3X3_ARGS = [_P] * 13 + [_I] * 9 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


_LIBRARY = CudaLibrary(
    "bottleneck", ["nn/layers/csrc/bottleneck.cu"],
    {**{s: _CONV1X1_ARGS for s in _symbols("conv1x1").values()},
     **{s: _CONV3X3_ARGS for s in _symbols("conv3x3").values()},
     "dl4j_conv_row_tile": [], "dl4j_conv_tc_smem": _CONV_TC_SMEM_ARGS},
    headers=["nn/layers/csrc/conv_gemm.cuh", "nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh",
             "nn/layers/csrc/conv_fwd_tc.cuh"])

_BWD_LIBRARY = CudaLibrary(
    "bottleneck_bwd", ["nn/layers/csrc/bottleneck_bwd.cu"],
    {**{s: _BWD1X1_ARGS for s in _symbols("bwd1x1").values()},
     **{s: _BWD3X3_ARGS for s in _symbols("bwd3x3").values()},
     "dl4j_bwd_row_tile": []},
    headers=["nn/layers/csrc/conv_gemm.cuh", "nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh",
             "nn/layers/csrc/conv_bwd_tc.cuh"])

#: the four kernels; each ``.launches`` counts its launches (a backward
#: stage's entry point, which launches its dz and dW passes, counts once)
CONV1X1 = CudaKernel(_LIBRARY, "conv1x1", _symbols("conv1x1"))
CONV3X3 = CudaKernel(_LIBRARY, "conv3x3", _symbols("conv3x3"))
BWD1X1 = CudaKernel(_BWD_LIBRARY, "bwd1x1", _symbols("bwd1x1"))
BWD3X3 = CudaKernel(_BWD_LIBRARY, "bwd3x3", _symbols("bwd3x3"))

#: the f32 backward kernels' reduction step: a dW split covers whole steps
_BWD_STEP = 16
#: the bf16 forward kernels' output pixels per block (csrc/bottleneck.cu's
#: kPixels)
_TC_FWD_PIXELS = 128
#: the bf16 backward kernels' output pixels per dz block and pixels per dW
#: chunk (csrc/bottleneck_bwd.cu's kDzPixels, kDwPixels)
_TC_DZ_PIXELS, _TC_DW_PIXELS = 128, 64
#: the bf16 dW pass's grid: about this many blocks per SM in all
_TC_DW_BLOCKS_PER_SM = 2
#: the bf16 kernels index elements with 32-bit ints
_TC_MAX_ELEMENTS = 2 ** 31 - 1


class BnParams(NamedTuple):
    gamma: torch.Tensor          # [C]
    beta: torch.Tensor           # [C]
    running_mean: torch.Tensor   # [C] f32
    running_var: torch.Tensor    # [C] f32


def _dtype_ok(dtype) -> bool:
    if isinstance(dtype, str):
        return dtype in ("float32", "bfloat16", "bf16")
    return dtype in _DTYPES


def fused_bottleneck_supported(x_shape, c_mid: int, c_out: int, dtype,
                               stride: int = 1,
                               has_skip: bool = False) -> bool:
    """Whether the kernels take this block: NHWC ``[N, H, W, C]``, a
    stride of 1 or 2 that divides H and W (the strided 1x1 subsamples
    exactly), f32 or bf16. Any size fits: the kernels tile the images
    (the JAX gate's VMEM budget does not apply), any width and any
    alignment of the tensors (the bf16 kernels copy 16 bytes at a time
    where C and K are multiples of 8 and the pointers 16-byte aligned,
    element by element otherwise); only a bf16 conv or backward stage
    whose activations or weight hold 2^31 - 1 elements or more is
    refused when it runs (its kernels index with 32-bit ints)."""
    if len(x_shape) != 4 or stride not in (1, 2) or not _dtype_ok(dtype):
        return False
    _, h, w, _ = x_shape
    return h % stride == 0 and w % stride == 0


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def _check(name, x, sc, bb, w, c, k, out_numel):
    """Raise on what the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"{name} kernel takes f32 or bf16 x with w of the "
                         f"same dtype, got {x.dtype} and {w.dtype}")
    for key, t, dtype, shape in (("sc", sc, torch.float32, (c,)),
                                 ("bb", bb, torch.float32, (c,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for key, t in (("x", x), ("sc", sc), ("bb", bb), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if w.shape[-1] != k:
        raise ValueError(f"{name}: w {tuple(w.shape)} has no {k} columns")
    if x.dtype == torch.bfloat16 and max(x.numel(), w.numel(), out_numel) \
            >= _TC_MAX_ELEMENTS:
        raise ValueError(f"{name}: the bf16 kernel indexes with 32-bit "
                         f"ints; x, w and the output must each hold fewer "
                         f"than {_TC_MAX_ELEMENTS} elements")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _outputs(library, x, n, ho, wo, k, tiles=None):
    """The output, the partial sums (``tiles`` per channel; by default
    one per output-row tile of ``library``'s conv kernels, the tile read
    from the library), their length per channel, and the sums."""
    out = torch.empty((n, ho, wo, k), dtype=x.dtype, device=x.device)
    if tiles is None:
        tiles = -(-(n * ho * wo) // library.load().dl4j_conv_row_tile())
    part = torch.empty((2, k, tiles), dtype=torch.float32, device=x.device)
    sums = torch.zeros((2, k), dtype=torch.float32, device=x.device)
    return out, part, tiles, sums


class FwdPlan(NamedTuple):
    """A bf16 forward conv's launch plan, as ``csrc/bottleneck.cu``
    chooses it: the output's ``blocks`` pixel blocks of 128 pixels (the
    1x1: runs of them; the 3x3: ``patch = (tw, th, cols)`` patches of the
    tall image, ``None`` for the 1x1), column tiles of ``channels``
    output channels, and ``tiles`` block rows of the grid (the sums'
    partials a channel): row q walks the pixel blocks q, q + tiles, ..."""
    tiles: int
    blocks: int
    channels: int
    patch: Optional[Tuple[int, int, int]]


def _fwd_rows(blocks, cols, cap):
    """The grid's block rows over ``blocks`` pixel blocks and ``cols``
    column tiles on a card that holds ``cap`` blocks at once, as
    ``csrc/bottleneck.cu``'s ``fwd_slots`` picks them: the fewest rounds
    ``w ceil(blocks / q)`` over the waves w, q = w cap // cols rows (at
    least 1, at most ``blocks``), ties to fewer waves."""
    best, best_rounds, w = 1, None, 1
    while True:
        q = min(max(w * cap // cols, 1), blocks)
        rounds = w * -(-blocks // q)
        if best_rounds is None or rounds < best_rounds:
            best, best_rounds = q, rounds
        if q == blocks:
            return best
        w += 1


@functools.lru_cache(maxsize=256)
def _fwd_tc_plan(n, h, w, k, stride, taps, sms) -> FwdPlan:
    """The plan of a bf16 forward conv of ``taps`` (1 or 9) over x ``[n,
    h, w, C]`` to ``k`` channels on a card of ``sms`` SMs: 128-pixel runs
    of the output (the 1x1) or the patches of :func:`_patch_tiling` (the
    3x3); 64 output channels a block up to K = 64 (two blocks an SM),
    else 128 (one); the block rows of :func:`_fwd_rows`."""
    ho, wo = h // stride, w // stride
    channels, per_sm = (64, 2) if k <= 64 else (128, 1)
    patch = None
    if taps == 9:
        tw, th, cols, blocks = _patch_tiling(n * ho, wo, _TC_FWD_PIXELS)
        patch = (tw, th, cols)
    else:
        blocks = -(-(n * ho * wo) // _TC_FWD_PIXELS)
    tiles = _fwd_rows(blocks, -(-k // channels), per_sm * sms) \
        if blocks and k else 1
    return FwdPlan(tiles, blocks, channels, patch)


def _conv_outputs(x, n, h, w, k, stride, taps):
    """:func:`_outputs` of a forward conv: the bf16 kernels' partials are
    their grid's block rows (:func:`_fwd_tc_plan`), the f32 kernels'
    their output-row tiles."""
    tiles = _fwd_tc_plan(n, h, w, k, stride, taps,
                         _sm_count(x.device)).tiles \
        if x.dtype == torch.bfloat16 else None
    return _outputs(_LIBRARY, x, n, h // stride, w // stride, k, tiles)


def conv1x1(x, sc, bb, w, *, act: str = "identity", stride: int = 1):
    """``o = act(x[:, ::s, ::s] * sc + bb)`` rounded to w's dtype, times
    ``w`` ``[C, K]``, rounded to x's dtype, and ``(o, Σo, Σo²)`` with the
    sums ``[K]`` f32 over the stored o. x ``[N, H, W, C]``; sc, bb ``[C]``
    f32 (``(1, 0)`` for the identity prologue). The kernel on CUDA
    tensors, :func:`conv1x1_plain` on CPU tensors."""
    n, h, wd, c = _nhwc(x, "conv1x1")
    if stride not in (1, 2) or h % stride or wd % stride:
        raise ValueError(f"conv1x1: stride {stride} must be 1 or 2 and "
                         f"divide H={h}, W={wd}")
    if tuple(w.shape[:1]) != (c,) or w.dim() != 2:
        raise ValueError(f"conv1x1: w {tuple(w.shape)} is not [C={c}, K]")
    if x.device.type == "cpu":
        return conv1x1_plain(x, sc, bb, w, act=act, stride=stride)
    k = w.shape[1]
    _check("conv1x1", x, sc, bb, w, c, k, n * (h // stride) * (wd // stride)
           * k)
    out, part, tiles, sums = _conv_outputs(x, n, h, wd, k, stride, 1)
    if out.numel():
        CONV1X1.launch(x.dtype, x.data_ptr(), sc.data_ptr(), bb.data_ptr(),
                       w.data_ptr(), out.data_ptr(), part[0].data_ptr(),
                       part[1].data_ptr(), sums[0].data_ptr(),
                       sums[1].data_ptr(), n, h, wd, c, k, stride,
                       int(_relu(act)), tiles, _stream(x))
    return out, sums[0], sums[1]


def conv3x3(x, sc, bb, w, *, act: str = "identity"):
    """The 3x3 same-pad conv of ``act(x * sc + bb)``: the activated image
    ``z`` rounded to w's dtype and zero-padded by one, nine shifted
    ``[HW, C] @ [C, K]`` taps of ``w`` ``[9, C, K]`` (tap ``t = kh * 3 +
    kw``), rounded to x's dtype; ``(o, Σo, Σo²)`` as :func:`conv1x1`.
    The kernel on CUDA tensors, :func:`conv3x3_plain` on CPU tensors."""
    n, h, wd, c = _nhwc(x, "conv3x3")
    if w.dim() != 3 or tuple(w.shape[:2]) != (9, c):
        raise ValueError(f"conv3x3: w {tuple(w.shape)} is not [9, C={c}, "
                         f"K]")
    if x.device.type == "cpu":
        return conv3x3_plain(x, sc, bb, w, act=act)
    k = w.shape[2]
    _check("conv3x3", x, sc, bb, w, c, k, n * h * wd * k)
    out, part, tiles, sums = _conv_outputs(x, n, h, wd, k, 1, 9)
    if out.numel():
        CONV3X3.launch(x.dtype, x.data_ptr(), sc.data_ptr(), bb.data_ptr(),
                       w.data_ptr(), out.data_ptr(), part[0].data_ptr(),
                       part[1].data_ptr(), sums[0].data_ptr(),
                       sums[1].data_ptr(), n, h, wd, c, k, int(_relu(act)),
                       tiles, _stream(x))
    return out, sums[0], sums[1]


def _nhwc(x, name):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NHWC [N, H, W, C], got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape)


def _relu(act) -> bool:
    if act not in ("relu", "identity"):
        raise ValueError(f"prologue activation must be relu or identity, "
                         f"got {act!r}")
    return act == "relu"


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------
def _prologue(x, sc, bb, act, dtype):
    """``act(x * sc + bb)`` in f32 (two roundings), rounded to ``dtype``
    and widened back to f32."""
    z = x.float() * sc + bb
    if _relu(act):
        z = torch.clamp_min(z, 0.0)
    return z.to(dtype).float()


def _stats(out):
    of = out.float().reshape(-1, out.shape[-1])
    return of.sum(dim=0), (of * of).sum(dim=0)


def conv1x1_plain(x, sc, bb, w, *, act: str = "identity", stride: int = 1):
    """The plain PyTorch version of :func:`conv1x1`: subsample, prologue,
    one f32 matmul, rounded to x's dtype; sums over the stored output."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    n, ho, wo, c = x.shape
    z = _prologue(x, sc, bb, act, w.dtype).reshape(-1, c)
    out = (z @ w.float()).to(x.dtype).reshape(n, ho, wo, w.shape[1])
    return (out, *_stats(out))


def conv3x3_plain(x, sc, bb, w, *, act: str = "identity"):
    """The plain PyTorch version of :func:`conv3x3`: the prologue, the
    zero padding of the activated image, nine f32 tap matmuls summed in
    tap order, rounded to x's dtype; sums over the stored output."""
    n, h, wd, c = x.shape
    zp = torch.nn.functional.pad(_prologue(x, sc, bb, act, w.dtype),
                                 (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        tap = zp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) @ wf[t]
        acc = tap if acc is None else acc + tap
    out = acc.to(x.dtype).reshape(n, h, wd, w.shape[2])
    return (out, *_stats(out))


# ---------------------------------------------------------------------
# the backward stages: wrappers and plain versions
# ---------------------------------------------------------------------
# Stage k's conv read z_{k-1} = act(y_{k-1} * sc_p + bb_p) and wrote y_k.
# Given g = dz0_k (already relu-masked) and aff_k's rows (sc, bb, inv, mu,
# m1, m2) of stage k's BN backward,
#     dy = sc * (g - m1 - yhat * m2),   yhat = (y_k - mu) * inv
# and a stage returns dW_k = z_{k-1}^T dy, dz0_{k-1} = (dy W^T) * relu'(
# z0_{k-1}) at full resolution and the sums (Σdz0_{k-1}, Σdz0_{k-1} *
# yhat_{k-1}) stage k-1's BN backward needs. (The JAX ``_bwd_stage`` also
# takes ``gmode="dy"``, g as dy itself; no caller in either package uses
# it, so it is not ported.)

def _check_bwd(name, yk, g, yprev, w, aff_k, aff_p):
    """Raise on what a backward kernel does not take."""
    if yprev.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{yprev.device}")
    if yprev.dtype not in _DTYPES or any(
            t.dtype != yprev.dtype for t in (yk, g, w)):
        raise ValueError(f"{name} kernel takes yk, g, yprev and w of one "
                         f"dtype, f32 or bf16, got {yk.dtype}, {g.dtype}, "
                         f"{yprev.dtype}, {w.dtype}")
    for key, t in (("yk", yk), ("g", g), ("yprev", yprev), ("w", w),
                   ("aff_k", aff_k), ("aff_p", aff_p)):
        if t.device != yprev.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{yprev.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    for key, t in (("aff_k", aff_k), ("aff_p", aff_p)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be f32, got {t.dtype}")
    if yprev.dtype == torch.bfloat16 and max(
            t.numel() for t in (yk, yprev, w)) >= _TC_MAX_ELEMENTS:
        raise ValueError(f"{name}: the bf16 kernel indexes with 32-bit "
                         f"ints; yk, yprev and w must each hold fewer than "
                         f"{_TC_MAX_ELEMENTS} elements")


def _bwd_shapes(name, yk, g, yprev, w, aff_k, aff_p, taps, stride):
    """Raise on a stage's shapes that do not fit together."""
    n, h, wd, c = _nhwc(yprev, name)
    if stride not in (1, 2) or h % stride or wd % stride:
        raise ValueError(f"{name}: stride {stride} must be 1 or 2 and "
                         f"divide H={h}, W={wd}")
    k = yk.shape[-1] if yk.dim() == 4 else -1
    want = (n, h // stride, wd // stride, k)
    if tuple(yk.shape) != want or tuple(g.shape) != want:
        raise ValueError(f"{name}: yk {tuple(yk.shape)} and g "
                         f"{tuple(g.shape)} must be {want}")
    wshape = (c, k) if taps == 1 else (9, c, k)
    if tuple(w.shape) != wshape:
        raise ValueError(f"{name}: w {tuple(w.shape)} is not {wshape}")
    if tuple(aff_k.shape) != (6, k) or tuple(aff_p.shape) != (4, c):
        raise ValueError(f"{name}: aff_k {tuple(aff_k.shape)} and aff_p "
                         f"{tuple(aff_p.shape)} must be (6, {k}), (4, {c})")


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    """The card's SM count (one query per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dw_splits(rows, tiles, device):
    """(chunk, splits) of a dW pass over ``rows`` reduction rows with
    ``tiles`` output tiles: about four blocks per SM in all, each split
    at least 32 reduction steps, a whole number of steps."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(-(-4 * sms // tiles), -(-rows // (32 * _BWD_STEP))))
    chunk = -(-rows // want)
    chunk = -(-chunk // _BWD_STEP) * _BWD_STEP
    return chunk, -(-rows // chunk)


def _patch_tiling(rows, wo, pp):
    """The bf16 3x3 kernels' patch of at most ``pp`` pixels of the tall
    image ``[rows, wo]`` (the images stacked), as ``csrc/conv_mma.cuh``'s
    ``patch_tiling`` chooses it: ``(tw, th, cols, patches)``, the width
    up to 16 and the height up to 64 whose useful pixels per pixel of
    the patch's one-pixel halo are the most, ``th / (cols (th + 2)(tw +
    2))`` compared exactly, ties to the wider patch."""
    best = None
    for d in range(1, min(wo, 16) + 1):
        th = min(pp // d, 64)
        cols = -(-wo // d)
        halo = (th + 2) * (d + 2)
        if best is None or th * best[2] * best[3] >= best[1] * cols * halo:
            best = (d, th, cols, halo)
    tw, th, cols, _ = best
    return tw, th, cols, -(-rows // th) * cols


class BwdPlan(NamedTuple):
    """A bf16 backward stage's launch plan (the C entry point's ``tiles,
    chunk, splits``): the dz pass's blocks along the pixels (the sums'
    partials a channel), and the dW pass's patches per split and
    splits."""
    tiles: int
    chunk: int
    splits: int


@functools.lru_cache(maxsize=256)
def _bwd_tc_plan(n, h, w, c, k, stride, taps, sms) -> BwdPlan:
    """The plan of a bf16 stage on a card of ``sms`` SMs. dz: one block
    per 128 output pixels (the 3x3: per patch). dW: 64-pixel chunks
    (the 3x3: patches), split so the grid holds about two blocks per SM,
    each split at least 8 chunks; the blocks' shape as the kernel picks
    it (the 3x3: 64 channels of all nine taps x 32 columns; the 1x1: 64
    or 128 channels x 64 to 256 columns)."""
    ho, wo = h // stride, w // stride
    m = n * ho * wo
    if taps == 9:
        dz = _patch_tiling(n * ho, wo, _TC_DZ_PIXELS)[3]
        dw = _patch_tiling(n * ho, wo, _TC_DW_PIXELS)[3]
        br, bn = 64, 32
    else:
        dz, dw = -(-m // _TC_DZ_PIXELS), -(-m // _TC_DW_PIXELS)
        br = 64 if c <= 64 else 128
        bn = 64 if k <= 64 else 128 if (k <= 128 or c > 64) else 256
    blocks = -(-c // br) * -(-k // bn)
    want = max(1, min(-(-_TC_DW_BLOCKS_PER_SM * sms // blocks),
                      -(-dw // 8)))
    chunk = -(-dw // want)
    return BwdPlan(dz, chunk, -(-dw // chunk))


def _stage_bwd(kernel, yk, g, yprev, w, aff_k, aff_p, relu, stride, taps):
    """Allocate a stage's outputs and scratch, launch its entry point."""
    n, h, wd, c = yprev.shape
    k = yk.shape[3]
    rows = n * (h // stride) * (wd // stride)
    dev = yprev.device
    f32 = torch.float32
    dz = torch.empty_like(yprev)
    dw = torch.empty((c, k) if taps == 1 else (9, c, k), dtype=f32,
                     device=dev)
    sums = torch.zeros((2, c), dtype=f32, device=dev)
    if not (rows and c and k):
        return dz.zero_(), dw.zero_(), sums
    if yprev.dtype == torch.bfloat16:
        tiles, chunk, splits = _bwd_tc_plan(n, h, wd, c, k, stride, taps,
                                            _sm_count(dev))
    else:
        tiles = -(-rows // _BWD_LIBRARY.load().dl4j_bwd_row_tile())
        tiles_rk = -(-(taps * c) // 128) * -(-k // 64)
        chunk, splits = _dw_splits(rows, tiles_rk, dev)
    part = torch.empty((2, c, tiles), dtype=f32, device=dev)
    dw_part = torch.empty((splits, taps * c, k), dtype=f32, device=dev)
    args = [yk.data_ptr(), g.data_ptr(), yprev.data_ptr(), w.data_ptr(),
            aff_k.data_ptr(), aff_p.data_ptr(), dz.data_ptr(), dw.data_ptr(),
            dw_part.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            sums[0].data_ptr(), sums[1].data_ptr(), n, h, wd, c, k]
    if taps == 1:
        args.append(stride)
    kernel.launch(yprev.dtype, *args, int(relu), tiles, chunk, splits,
                  _stream(yprev))
    return dz, dw, sums


def conv1x1_bwd(yk, g, yprev, w, aff_k, aff_p, *, act_prev: str,
                stride: int = 1):
    """One 1x1 stage's backward: ``(dz0_prev [N, H, W, C] in yprev's
    dtype, dW [C, K] f32, sums [2, C] f32)``. yk, g ``[N, H/s, W/s, K]``;
    yprev ``[N, H, W, C]``; w ``[C, K]``; aff_k ``[6, K]`` and aff_p
    ``[4, C]`` (rows sc, bb, inv, mu) f32. ``act_prev="identity"``: z_{k-1}
    is yprev itself (no affine, no mask) and the sums stay zero. dz0 is 0
    where a stride-2 conv never read. The kernel on CUDA tensors,
    :func:`conv1x1_bwd_plain` on CPU tensors."""
    relu = _relu(act_prev)
    _bwd_shapes("conv1x1_bwd", yk, g, yprev, w, aff_k, aff_p, 1, stride)
    if yprev.device.type == "cpu":
        return conv1x1_bwd_plain(yk, g, yprev, w, aff_k, aff_p,
                                 act_prev=act_prev, stride=stride)
    _check_bwd("conv1x1_bwd", yk, g, yprev, w, aff_k, aff_p)
    return _stage_bwd(BWD1X1, yk, g, yprev, w, aff_k, aff_p, relu, stride,
                      1)


def conv3x3_bwd(yk, g, yprev, w, aff_k, aff_p, *, act_prev: str = "relu"):
    """The 3x3 same-pad stage's backward, as :func:`conv1x1_bwd` with w
    and dW ``[9, C, K]`` (tap ``t = kh * 3 + kw``): dW per tap over the
    zero-padded z_{k-1}, dz0 by the transposed taps over the zero-padded
    dy. The 3x3 always has a real BN prologue: ``act_prev`` is "relu".
    The kernel on CUDA tensors, :func:`conv3x3_bwd_plain` on CPU
    tensors."""
    if act_prev != "relu":
        raise ValueError(f"conv3x3_bwd: the 3x3 stage's prologue is relu, "
                         f"got {act_prev!r}")
    _bwd_shapes("conv3x3_bwd", yk, g, yprev, w, aff_k, aff_p, 9, 1)
    if yprev.device.type == "cpu":
        return conv3x3_bwd_plain(yk, g, yprev, w, aff_k, aff_p,
                                 act_prev=act_prev)
    _check_bwd("conv3x3_bwd", yk, g, yprev, w, aff_k, aff_p)
    return _stage_bwd(BWD3X3, yk, g, yprev, w, aff_k, aff_p, True, 1, 9)


def _dy(yk, g, aff_k):
    """dy in f32, op by op as the TPU kernel."""
    sc, _, inv, mu, m1, m2 = aff_k
    yhat = (yk.float() - mu) * inv
    return sc * (g.float() - m1 - yhat * m2)


def _z_prev(yprev, aff_p, relu):
    """(z0, z) of the previous stage in f32: ``z0 = yprev * sc + bb`` and
    its relu, or yprev itself under the identity prologue."""
    yp = yprev.float()
    if not relu:
        return yp, yp
    z0 = yp * aff_p[0] + aff_p[1]
    return z0, torch.clamp_min(z0, 0.0)


def _dz_out(dzs, yprev, aff_p, z0, relu, stride):
    """Mask, store and sum a stage's f32 dz at the read positions: dz0
    at full resolution (0 where a strided conv never read) in yprev's
    dtype, and the sums over the f32 values before their rounding."""
    n, h, wd, c = yprev.shape
    if relu:
        dzs = torch.where(z0 > 0, dzs, 0.0)
    dz = torch.zeros_like(yprev)
    dz[:, ::stride, ::stride, :] = dzs.to(yprev.dtype)
    sums = torch.zeros((2, c), dtype=torch.float32, device=yprev.device)
    if relu:
        yhat = (yprev[:, ::stride, ::stride, :].float() - aff_p[3]) \
            * aff_p[2]
        sums = torch.stack([dzs.reshape(-1, c).sum(0),
                            (dzs * yhat).reshape(-1, c).sum(0)])
    return dz, sums


def conv1x1_bwd_plain(yk, g, yprev, w, aff_k, aff_p, *, act_prev: str,
                      stride: int = 1):
    """The plain PyTorch version of :func:`conv1x1_bwd`, written as the
    JAX ``_bwd1x1_kernel``: dW from z_{k-1} and dy each rounded to yk's
    dtype, dz from dy rounded to w's dtype, both products in f32; the
    relu' mask on the unrounded z0; the sums over the f32 dz."""
    relu = _relu(act_prev)
    c, k = yprev.shape[3], yk.shape[3]
    dy = _dy(yk, g, aff_k)
    z0, z = _z_prev(yprev[:, ::stride, ::stride, :], aff_p, relu)
    dw = z.to(yk.dtype).float().reshape(-1, c).t() \
        @ dy.to(yk.dtype).float().reshape(-1, k)
    dzs = (dy.to(w.dtype).float().reshape(-1, k) @ w.float().t()) \
        .reshape(z0.shape)
    dz, sums = _dz_out(dzs, yprev, aff_p, z0, relu, stride)
    return dz, dw, sums


def conv3x3_bwd_plain(yk, g, yprev, w, aff_k, aff_p, *,
                      act_prev: str = "relu"):
    """The plain PyTorch version of :func:`conv3x3_bwd`, written as the
    JAX ``_bwd3x3_kernel``: nine tap products over the zero-padded z_{k-1}
    (dW) and the zero-padded dy at the mirrored offsets (dz), in tap
    order."""
    n, h, wd, c = yprev.shape
    k = yk.shape[3]
    pad = torch.nn.functional.pad
    dy = _dy(yk, g, aff_k)
    z0, z = _z_prev(yprev, aff_p, _relu(act_prev))
    zp = pad(z.to(yk.dtype).float(), (0, 0, 1, 1, 1, 1))
    dyr = dy.to(yk.dtype).float().reshape(-1, k)
    dyp = pad(dy.to(w.dtype).float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    dws, dzs = [], None
    for t in range(9):
        kh, kw = divmod(t, 3)
        dws.append(zp[:, kh:kh + h, kw:kw + wd, :].reshape(-1, c).t() @ dyr)
        tap = dyp[:, 2 - kh:2 - kh + h, 2 - kw:2 - kw + wd, :] \
            .reshape(-1, k) @ wf[t].t()
        dzs = tap if dzs is None else dzs + tap
    dz, sums = _dz_out(dzs.reshape(n, h, wd, c), yprev, aff_p, z0, True, 1)
    return dz, torch.stack(dws), sums


# ---------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------
def _finalize_stats(s1, s2, count):
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean * mean, 0.0)
    return mean, var


def _affine(gamma, beta, mean, var, eps):
    inv = torch.rsqrt(var + eps)
    sc = gamma * inv
    bb = beta - mean * sc
    return sc, bb, inv


def _bn_affine(p: BnParams, eps):
    """The running-statistics affine ``(sc, bb)`` of an inference BN."""
    sc, bb, _ = _affine(p.gamma.float(), p.beta.float(), p.running_mean,
                        p.running_var, eps)
    return sc.contiguous(), bb.contiguous()


def _rows(*rows):
    """Affine rows stacked as the backward kernels read them: [R, C] f32."""
    return torch.stack(rows).float().contiguous()


_SUM = (0, 1, 2)       # the per-channel reductions over N, H, W


class BottleneckTrain(torch.autograd.Function):
    """The training block: the JAX ``_bottleneck_core`` (identity form)
    and ``_bottleneck_ds_core`` (downsample form, ``ws`` given) with
    their ``custom_vjp``.

    ``apply(eps, stride, x, wa, wb, wc, ga, be_a, gb, be_b, gc, be_c, ws,
    gs, be_s)`` returns ``(out, mu_a, var_a, mu_b, var_b, mu_c, var_c[,
    mu_s, var_s])``: the batch statistics, from the forward kernels' sums
    over ``count = N Ho Wo``, are non-differentiable outputs (the JAX vjp
    ignores their cotangents; they feed the running averages only). Only
    the raw conv outputs are saved; the backward recomputes the f32 tail
    ``relu(yc sc + bb + shortcut)`` and runs stages c, b, a (and the conv
    shortcut) through the backward kernels."""

    @staticmethod
    def forward(ctx, eps, stride, x, wa, wb, wc, ga, be_a, gb, be_b, gc,
                be_c, ws, gs, be_s):
        n, h, wd, cin = x.shape
        count = n * (h // stride) * (wd // stride)
        ones = torch.ones(cin, dtype=torch.float32, device=x.device)
        zeros = torch.zeros_like(ones)
        ya, s1, s2 = conv1x1(x, ones, zeros, wa, act="identity",
                             stride=stride)
        mua, vara = _finalize_stats(s1, s2, count)
        sca, bba, _ = _affine(ga, be_a, mua, vara, eps)
        yb, s1, s2 = conv3x3(ya, sca, bba, wb, act="relu")
        mub, varb = _finalize_stats(s1, s2, count)
        scb, bbb, _ = _affine(gb, be_b, mub, varb, eps)
        yc, s1, s2 = conv1x1(yb, scb, bbb, wc, act="relu")
        muc, varc = _finalize_stats(s1, s2, count)
        scc, bbc, _ = _affine(gc, be_c, muc, varc, eps)
        stats = [mua, vara, mub, varb, muc, varc]
        ys = None
        if ws is not None:
            ys, s1, s2 = conv1x1(x, ones, zeros, ws, act="identity",
                                 stride=stride)
            mus, vars_ = _finalize_stats(s1, s2, count)
            scs, bbs, _ = _affine(gs, be_s, mus, vars_, eps)
            shortcut = ys.float() * scs + bbs
            stats += [mus, vars_]
        else:
            shortcut = x.float()
        pre = yc.float() * scc + bbc + shortcut
        out = torch.clamp_min(pre, 0.0).to(x.dtype)
        ctx.eps, ctx.stride, ctx.count = eps, stride, count
        ctx.save_for_backward(x, ya, yb, yc, ys, wa, wb, wc, ws, ga, be_a,
                              gb, be_b, gc, be_c, gs, be_s, *stats)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, g, *_stat_grads):
        (x, ya, yb, yc, ys, wa, wb, wc, ws, ga, be_a, gb, be_b, gc, be_c,
         gs, be_s, *stats) = ctx.saved_tensors
        eps, stride, count = ctx.eps, ctx.stride, ctx.count
        mua, vara, mub, varb, muc, varc = stats[:6]
        sca, bba, inva = _affine(ga, be_a, mua, vara, eps)
        scb, bbb, invb = _affine(gb, be_b, mub, varb, eps)
        scc, bbc, invc = _affine(gc, be_c, muc, varc, eps)
        # the tail: relu' of the recomputed pre-activation, and stage c's
        # BN-backward sums (the same gz is the skip's gradient)
        if ws is not None:
            mus, vars_ = stats[6:]
            scs, bbs, invs = _affine(gs, be_s, mus, vars_, eps)
            shortcut = ys.float() * scs + bbs
        else:
            shortcut = x.float()
        pre = yc.float() * scc + bbc + shortcut
        gz = torch.where(pre > 0, g.float(), 0.0)
        yhat_c = (yc.float() - muc) * invc
        dgc, dbc = (gz * yhat_c).sum(_SUM), gz.sum(_SUM)
        gzt = gz.to(yc.dtype)
        aff_c = _rows(scc, bbc, invc, muc, gz.mean(_SUM),
                      (gz * yhat_c).mean(_SUM))
        dz0b, dwc, sums_b = conv1x1_bwd(yc, gzt, yb, wc, aff_c,
                                        _rows(scb, bbb, invb, mub),
                                        act_prev="relu")
        aff_b = _rows(scb, bbb, invb, mub, sums_b[0] / count,
                      sums_b[1] / count)
        dz0a, dwb, sums_a = conv3x3_bwd(yb, dz0b, ya, wb, aff_b,
                                        _rows(sca, bba, inva, mua),
                                        act_prev="relu")
        # stage a: the identity prologue (z_prev is the block input)
        cin = x.shape[3]
        one = torch.ones(cin, dtype=torch.float32, device=x.device)
        aff_id = _rows(one, 1.0 - one, one, 1.0 - one)
        aff_a = _rows(sca, bba, inva, mua, sums_a[0] / count,
                      sums_a[1] / count)
        dx_main, dwa, _ = conv1x1_bwd(ya, dz0a, x, wa, aff_a, aff_id,
                                      act_prev="identity", stride=stride)
        grads = [dwa.to(wa.dtype), dwb.to(wb.dtype), dwc.to(wc.dtype),
                 sums_a[1].to(ga.dtype), sums_a[0].to(be_a.dtype),
                 sums_b[1].to(gb.dtype), sums_b[0].to(be_b.dtype),
                 dgc.to(gc.dtype), dbc.to(be_c.dtype)]
        if ws is None:
            dx = (dx_main.float() + gz).to(x.dtype)
            return (None, None, dx, *grads, None, None, None)
        yhat_s = (ys.float() - mus) * invs
        aff_s = _rows(scs, bbs, invs, mus, gz.mean(_SUM),
                      (gz * yhat_s).mean(_SUM))
        dx_skip, dws, _ = conv1x1_bwd(ys, gzt, x, ws, aff_s, aff_id,
                                      act_prev="identity", stride=stride)
        dx = (dx_main.float() + dx_skip.float()).to(x.dtype)
        return (None, None, dx, *grads, dws.to(ws.dtype),
                (gz * yhat_s).sum(_SUM).to(gs.dtype),
                gz.sum(_SUM).to(be_s.dtype))


def fused_bottleneck(x, wa, bn_a: BnParams, wb, bn_b: BnParams, wc,
                     bn_c: BnParams, *, train: bool, w_skip=None,
                     bn_skip: BnParams = None, stride: int = 1,
                     eps: float = 1e-5, decay: float = 0.9
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """ResNet bottleneck through the conv kernels.

    x ``[N, H, W, Cin]`` NHWC (the post-relu block input); wa ``[Cin,
    Cmid]``, wb ``[9, Cmid, Cmid]`` (tap-major 3x3), wc ``[Cmid, Cout]``.
    Identity form (``w_skip=None``, stride 1, Cout == Cin): ``relu(
    norm_c(conv_c(...)) + x)``. Downsample form: ``w_skip`` ``[Cin,
    Cout]`` and ``bn_skip`` give the conv shortcut, ``stride`` applies
    to conv_a and the shortcut.

    Returns ``(out, running stats)``: 6 entries (mean and var of a, b,
    c) or 8 (with the skip), f32. Training (``train=True``) normalizes
    with the batch statistics, differentiates through
    :class:`BottleneckTrain`, and decays the running statistics as the
    unfused ``BatchNormalization`` does, ``decay * old + (1 - decay) *
    batch`` with ``decay * old`` rounded in x's dtype (``normalization.
    decayed``). Inference uses the
    running statistics and returns them unchanged."""
    ds = w_skip is not None
    if ds != (bn_skip is not None):
        raise ValueError("w_skip and bn_skip go together")
    if stride != 1 and not ds:
        raise ValueError("stride != 1 requires the conv shortcut")
    bns = (bn_a, bn_b, bn_c) + ((bn_skip,) if ds else ())
    if train:
        outs = BottleneckTrain.apply(
            eps, stride, x, wa, wb, wc, bn_a.gamma, bn_a.beta, bn_b.gamma,
            bn_b.beta, bn_c.gamma, bn_c.beta, w_skip,
            *((bn_skip.gamma, bn_skip.beta) if ds else (None, None)))
        olds = [t for p in bns for t in (p.running_mean, p.running_var)]
        return outs[0], tuple(decayed(old.to(x.dtype), new, decay).float()
                              for old, new in zip(olds, outs[1:]))
    sca, bba = _bn_affine(bn_a, eps)
    scb, bbb = _bn_affine(bn_b, eps)
    scc, bbc = _bn_affine(bn_c, eps)
    ones = torch.ones(x.shape[3], dtype=torch.float32, device=x.device)
    zeros = torch.zeros_like(ones)
    ya, _, _ = conv1x1(x, ones, zeros, wa, act="identity", stride=stride)
    yb, _, _ = conv3x3(ya, sca, bba, wb, act="relu")
    yc, _, _ = conv1x1(yb, scb, bbb, wc, act="relu")
    if ds:
        scs, bbs = _bn_affine(bn_skip, eps)
        ys, _, _ = conv1x1(x, ones, zeros, w_skip, act="identity",
                           stride=stride)
        shortcut = ys.float() * scs + bbs
    else:
        shortcut = x.float()
    pre = yc.float() * scc + bbc + shortcut
    out = torch.clamp_min(pre, 0.0).to(x.dtype)
    return out, tuple(t for p in bns for t in (p.running_mean,
                                               p.running_var))


def reference_bottleneck(x, wa, bn_a, wb, bn_b, wc, bn_c, *, train,
                         w_skip=None, bn_skip=None, stride=1, eps=1e-5,
                         decay=0.9):
    """The unfused composition with the same semantics (the JAX
    package's ``reference_bottleneck``): f32 convs over dtype-rounded
    activations, one-pass batch statistics under ``train``, running
    statistics otherwise. Returns ``(out, new running stats)``."""
    def conv1x1_(z, w, s=1):
        if s > 1:
            z = z[:, ::s, ::s, :]
        return torch.einsum("nhwc,ck->nhwk", z, w)

    def conv3x3_(z, w9):
        zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
        acc = 0
        for t in range(9):
            dy, dx = divmod(t, 3)
            acc = acc + torch.einsum(
                "nhwc,ck->nhwk",
                zp[:, dy:dy + z.shape[1], dx:dx + z.shape[2], :], w9[t])
        return acc

    def bn(y, p):
        yf = y.float()
        if train:
            mean = yf.mean(dim=(0, 1, 2))
            var = torch.clamp_min((yf * yf).mean(dim=(0, 1, 2))
                                  - mean * mean, 0.0)
        else:
            mean, var = p.running_mean, p.running_var
        inv = torch.rsqrt(var + eps)
        out = (yf - mean) * inv * p.gamma.float() + p.beta.float()
        new = (decay * p.running_mean + (1 - decay) * mean,
               decay * p.running_var + (1 - decay) * var)
        return out, new

    dt = x.dtype
    ya = conv1x1_(x.float(), wa.float(), stride).to(dt)
    za, ra = bn(ya, bn_a)
    yb = conv3x3_(torch.clamp_min(za, 0.0).to(dt).float(),
                  wb.float()).to(dt)
    zb, rb = bn(yb, bn_b)
    yc = conv1x1_(torch.clamp_min(zb, 0.0).to(dt).float(),
                  wc.float()).to(dt)
    zc, rc = bn(yc, bn_c)
    if w_skip is not None:
        ys = conv1x1_(x.float(), w_skip.float(), stride).to(dt)
        shortcut, rs = bn(ys, bn_skip)
    else:
        shortcut = x.float()
    out = torch.clamp_min(zc + shortcut, 0.0).to(dt)
    stats = (*ra, *rb, *rc)
    if w_skip is not None:
        stats = stats + rs
    return out, stats
