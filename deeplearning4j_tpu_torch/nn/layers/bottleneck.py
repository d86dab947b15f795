"""The fused ResNet bottleneck, forward (inference): the CUDA kernels'
wrappers, their plain PyTorch versions, and the block built from them.

Counterpart of ``deeplearning4j_tpu/nn/layers/bottleneck.py``: the
bottleneck conv1x1 -> BN -> relu -> conv3x3 -> BN -> relu -> conv1x1 ->
BN -> (+ residual) -> relu as a chain of conv kernels, each applying the
previous BN's affine and relu as the PROLOGUE of its input and emitting
its output's per-channel sum and sum of squares as its EPILOGUE. NHWC
throughout; identity blocks (stride 1, identity skip) and downsample
entry blocks (stride on conv_a and on a conv shortcut with its own BN).

The two kernels are hand-written CUDA C++ for Hopper, ``csrc/
bottleneck.cu`` over the implicit GEMM of ``csrc/conv_gemm.cuh``; they
replace the TPU kernels ``_fwd1x1_kernel`` and ``_fwd3x3_kernel`` (the
source note there says what bounds them and what their design does
about that). Each wrapper dispatches on where its tensors lie: CUDA
tensors launch the kernel (or raise on what it does not take), CPU
tensors take the plain version beside it, written as the JAX kernel
body (f32 products of dtype-rounded operands, the same rounding points).
There is no fallback from the kernel to the plain version.

Inference only in this slice: ``fused_bottleneck(train=True)`` and the
four backward kernels (``_bwd1x1_kernel``, ``_bwd3x3_kernel`` and their
channel-split variant) are ROADMAP.md's "ResNet50 training". Inference
ignores the sums, but the kernels compute them: training needs them.

The gate is the port's own. The JAX package's
``fused_bottleneck_supported`` encodes the TPU's VMEM budget (whole
images and weights resident per grid step); these kernels tile any
image, so :func:`fused_bottleneck_supported` refuses only what they do
not take: a stride other than 1 or 2, a height or width the stride does
not divide, a dtype other than f32 or bf16.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary

__all__ = ["BnParams", "CONV1X1", "CONV3X3", "conv1x1", "conv1x1_plain",
           "conv3x3", "conv3x3_plain", "fused_bottleneck",
           "fused_bottleneck_supported", "reference_bottleneck"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV1X1_ARGS = [_P] * 9 + [_I] * 8 + [_P]
_CONV3X3_ARGS = [_P] * 9 + [_I] * 7 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


_LIBRARY = CudaLibrary(
    "bottleneck", ["nn/layers/csrc/bottleneck.cu"],
    {**{s: _CONV1X1_ARGS for s in _symbols("conv1x1").values()},
     **{s: _CONV3X3_ARGS for s in _symbols("conv3x3").values()},
     "dl4j_conv_row_tile": []},
    headers=["nn/layers/csrc/conv_gemm.cuh"])

#: the two kernels; each ``.launches`` counts its launches
CONV1X1 = CudaKernel(_LIBRARY, "conv1x1", _symbols("conv1x1"))
CONV3X3 = CudaKernel(_LIBRARY, "conv3x3", _symbols("conv3x3"))


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
    (the JAX gate's VMEM budget does not apply)."""
    if len(x_shape) != 4 or stride not in (1, 2) or not _dtype_ok(dtype):
        return False
    _, h, w, _ = x_shape
    return h % stride == 0 and w % stride == 0


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def _check(name, x, sc, bb, w, c, k):
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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _outputs(library, x, n, ho, wo, k):
    """The output, the partial sums (one per channel and output-row tile
    of ``library``'s conv kernels, the tile read from the library), their
    length per channel, and the sums."""
    out = torch.empty((n, ho, wo, k), dtype=x.dtype, device=x.device)
    tiles = -(-(n * ho * wo) // library.load().dl4j_conv_row_tile())
    part = torch.empty((2, k, tiles), dtype=torch.float32, device=x.device)
    sums = torch.zeros((2, k), dtype=torch.float32, device=x.device)
    return out, part, tiles, sums


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
    _check("conv1x1", x, sc, bb, w, c, k)
    out, part, tiles, sums = _outputs(_LIBRARY, x, n, h // stride,
                                      wd // stride, k)
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
    _check("conv3x3", x, sc, bb, w, c, k)
    out, part, tiles, sums = _outputs(_LIBRARY, x, n, h, wd, k)
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


def fused_bottleneck(x, wa, bn_a: BnParams, wb, bn_b: BnParams, wc,
                     bn_c: BnParams, *, train: bool, w_skip=None,
                     bn_skip: BnParams = None, stride: int = 1,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """ResNet bottleneck through the conv kernels, inference.

    x ``[N, H, W, Cin]`` NHWC (the post-relu block input); wa ``[Cin,
    Cmid]``, wb ``[9, Cmid, Cmid]`` (tap-major 3x3), wc ``[Cmid, Cout]``.
    Identity form (``w_skip=None``, stride 1, Cout == Cin): ``relu(
    norm_c(conv_c(...)) + x)``. Downsample form: ``w_skip`` ``[Cin,
    Cout]`` and ``bn_skip`` give the conv shortcut, ``stride`` applies
    to conv_a and the shortcut. Returns ``(out, running stats)``, the
    stats unchanged (6 entries, or 8 with the skip), as the JAX
    package's inference does. ``train=True`` is not ported yet."""
    ds = w_skip is not None
    if ds != (bn_skip is not None):
        raise ValueError("w_skip and bn_skip go together")
    if stride != 1 and not ds:
        raise ValueError("stride != 1 requires the conv shortcut")
    if train:
        raise NotImplementedError(
            "fused_bottleneck(train=True) (batch statistics and the four "
            "backward kernels) is not ported yet (ROADMAP.md, ResNet50 "
            "training)")
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
    stats = (bn_a.running_mean, bn_a.running_var, bn_b.running_mean,
             bn_b.running_var, bn_c.running_mean, bn_c.running_var)
    if ds:
        stats = stats + (bn_skip.running_mean, bn_skip.running_var)
    return out, stats


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
