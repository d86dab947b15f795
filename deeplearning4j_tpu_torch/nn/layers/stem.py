"""The fused ResNet stem, forward (inference): space-to-depth 7x7/2 conv
with its sums, then BN affine + relu + 3x3/2 max pool in one pass.

Counterpart of ``deeplearning4j_tpu/nn/layers/stem.py``. The 7x7/2 conv
over the input zero-padded by 3 is a 4x4/1 conv over the space-to-depth
image (2x2 pixel phases become channels, phase-major), so it is one GEMM
``[ho wo, 64C] @ [64C, K]`` whose contraction matrix is
:func:`stem_weight_s2d`; its kernel emits the per-channel sum and sum of
squares of the stored output. The output stage normalizes, applies relu
and max-pools (3x3/2, pad 1, the padding -inf after the relu) in one
read of the conv output.

The two kernels are hand-written CUDA C++ for Hopper, ``csrc/stem.cu``
(the conv over the implicit GEMM of ``csrc/conv_gemm.cuh``, which builds
the im2col from the raw image as it goes); they replace the TPU kernels
``_stem_conv_kernel`` and ``_stem_pool_kernel`` (the source note there
says what bounds them and what their design does about that). Each
wrapper launches its kernel on CUDA tensors (or raises on what it does
not take) and takes the plain version beside it on CPU tensors, written
as the JAX kernel body.

Inference only: ``fused_stem(train=True)`` and the three backward
kernels (``_stem_bwd_pool_kernel``, ``_stem_bwd_dw_kernel``,
``_stem_bwd_dx_kernel``) are ROADMAP.md's "ResNet50 training with the
stem". ResNet50 trains with the stem unfused (the "fused" plan leaves it
off, as the JAX package does on an uncalibrated crossover store).

The gate is the port's own: the JAX package's ``fused_stem_supported``
encodes the TPU's VMEM budget (it refuses the f32 stem at 224x224); the
kernel tiles any image, so :func:`fused_stem_supported` asks only for an
NHWC input in f32 or bf16.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
    BnParams, _bn_affine, _dtype_ok, _outputs, _stats, _stream)

__all__ = ["STEM_CONV", "STEM_POOL", "fused_stem", "fused_stem_supported",
           "reference_stem", "stem_conv", "stem_conv_plain",
           "stem_geometry", "stem_pool", "stem_pool_plain",
           "stem_weight_s2d"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = [_P] * 7 + [_I] * 6 + [_P]
_POOL_ARGS = [_P] * 4 + [_I] * 4 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


_LIBRARY = CudaLibrary(
    "stem", ["nn/layers/csrc/stem.cu"],
    {**{s: _CONV_ARGS for s in _symbols("stem_conv").values()},
     **{s: _POOL_ARGS for s in _symbols("stem_pool").values()},
     "dl4j_conv_row_tile": []},
    headers=["nn/layers/csrc/conv_gemm.cuh"])

#: the two kernels; each ``.launches`` counts its launches
STEM_CONV = CudaKernel(_LIBRARY, "stem_conv", _symbols("stem_conv"))
STEM_POOL = CudaKernel(_LIBRARY, "stem_pool", _symbols("stem_pool"))


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


def fused_stem_supported(x_shape, n_out: int, dtype) -> bool:
    """Whether the kernels take this stem: NHWC ``[N, H, W, C]`` in f32
    or bf16. Any size fits (the JAX gate's VMEM budget does not
    apply)."""
    return len(x_shape) == 4 and _dtype_ok(dtype)


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def _check(name, **tensors):
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
        want = torch.float32 if key in ("sc", "bb") else first.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def stem_conv(x, w):
    """The stem conv: x ``[N, H, W, C]``, w the ``[64 C, K]`` matrix of
    :func:`stem_weight_s2d`. Returns ``(y, Σy, Σy²)``, y ``[N, ho, wo,
    K]`` in x's dtype, the sums ``[K]`` f32 over the stored y. The kernel
    on CUDA tensors, :func:`stem_conv_plain` on CPU tensors."""
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != 64 * x.shape[3]:
        raise ValueError(f"stem_conv: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} [64 C, K]")
    if x.device.type == "cpu":
        return stem_conv_plain(x, w)
    _check("stem_conv", x=x, w=w)
    n, h, wd, c = x.shape
    k = w.shape[1]
    g = stem_geometry(h, wd)
    y, part, tiles, sums = _outputs(_LIBRARY, x, n, g["ho"], g["wo"], k)
    if y.numel():
        STEM_CONV.launch(x.dtype, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                         part[0].data_ptr(), part[1].data_ptr(),
                         sums[0].data_ptr(), sums[1].data_ptr(), n, h, wd,
                         c, k, tiles, _stream(x))
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


# ---------------------------------------------------------------------
# the stem
# ---------------------------------------------------------------------
def fused_stem(x, w, bn: BnParams, *, train: bool, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The fused ResNet stem, inference. x ``[N, H, W, C]`` NHWC raw
    input; w the OIHW conv weight ``[K, C, 7, 7]`` (rearranged here, so
    the parameter keeps its layout) or its :func:`stem_weight_s2d` matrix
    ``[64 C, K]`` (a caller that keeps the rearranged copy). Zero-pad 3,
    7x7/2 conv (no bias), BN with the running statistics, relu, 3x3/2
    pad-1 max pool. Returns
    ``(out, (running mean, running var))`` unchanged. ``train=True`` is
    not ported yet."""
    if train:
        raise NotImplementedError(
            "fused_stem(train=True) (batch statistics and the three "
            "backward kernels) is not ported yet (ROADMAP.md, ResNet50 "
            "training with the stem)")
    sc, bb = _bn_affine(bn, eps)
    y, _, _ = stem_conv(x, stem_weight_s2d(w) if w.dim() == 4 else w)
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
