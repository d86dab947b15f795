"""Fused BatchNorm -> activation -> 1x1 convolution: the CUDA kernels'
wrappers, their plain PyTorch versions, and the op built from them.

Counterpart of ``deeplearning4j_tpu/nn/layers/fused.py``. For a bn -> act
-> 1x1-conv chain whose normalized tensor has one consumer, the BN's
affine and the activation are the PROLOGUE of the conv: a 1x1 conv is a
channel matmul, so the fused op is ``act(y sc + bb) @ W + b`` with the
per-channel affine ``(sc, bb)`` folded from the BN statistics, and the
normalized tensor is never stored. Its backward is one pass over (y, g)
that recomputes the normalized tensor instead of reading it.

The kernels are hand-written CUDA C++ for Hopper, ``csrc/fused.cu``:
:func:`fused_matmul` replaces the TPU kernel ``_fwd_kernel`` and
:func:`fused_matmul_bwd` replaces ``_bwd_kernel`` (the source notes say
what bounds each on the card and what the design does about that). The
bf16 forward runs on the tensor cores: it is the bottleneck's bf16
conv1x1 kernel (``csrc/conv_fwd_tc.cuh``) as a stride-1 1x1 over ``M``
images of one pixel, with the bias added in its epilogue and no sums;
its grid is planned here with the bottleneck's rule (:func:`_fwd_plan`,
``bottleneck._fwd_tc_plan``). The bf16 backward runs on the tensor cores
too: the bottleneck's bwd1x1 kernels (``csrc/conv_bwd_tc.cuh``) in their
fused mode, g itself the dz product's operand, dy = dz sc and the sums
dz y, dz in its epilogue, db from the g tiles of the dW pass; planned
by :func:`_bwd_tc_plan` (the bottleneck's 1x1 plan over ``M`` one-pixel
images). The f32 forward and the f32 backward run on the f32 CUDA-core
tiles of ``csrc/conv_gemm.cuh``; :func:`bwd_route` names the route a
dtype takes. Each wrapper
dispatches on where its tensors lie: CUDA tensors launch the kernel (or
raise on what it does not take), CPU tensors take the plain version
beside it, written as the JAX kernel body with the same rounding points.
There is no other route and no process-wide switch.

:class:`FusedMatmul` is the ``torch.autograd.Function`` counterpart of
the JAX ``_fused_matmul_pallas`` with its ``custom_vjp``: it saves only
``(y2, sc, bb, w2)``, so the normalized tensor is recomputed in the
backward. :func:`bn_act_conv1x1` keeps the full semantics of the JAX
op: the batch statistics (one f32 pass, ``E[x^2] - mean^2`` clamped at
0), the precision chain of the unfused ``BatchNormalization`` (gamma,
beta and the running statistics rounded through x's dtype, the decay as
``normalization.decayed``), the folded affine in f32. Everything but the
product stays ordinary differentiable PyTorch outside the ``Function``,
so autograd carries ``dsc`` and ``dbb`` back through the mean and the
variance to y, as JAX keeps the statistics outside its ``custom_vjp``.
NHWC (and ``[M, C]``) inputs launch the kernels; NCHW keeps the JAX
branch's einsum formulation, which the JAX package never sends to Pallas
either, so it is no kernel path in either package.

The gate is the port's own. The JAX ``fused_conv1x1_supported`` encodes
the TPU's VMEM budget (``C K <= 512 * 2048``); these kernels tile any
shape, so :func:`fused_conv1x1_supported` refuses only an activation
other than relu or identity and a dtype other than f32 or bf16, and the
wrappers raise on non-contiguous operands or operands on other devices.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
    _TC_MAX_ELEMENTS, BwdPlan, FwdPlan, _dtype_ok, _dw_splits, _fwd_tc_plan,
    _sm_count, _stream)
from deeplearning4j_tpu_torch.nn.layers.bottleneck import \
    _bwd_tc_plan as _stage_bwd_tc_plan
from deeplearning4j_tpu_torch.nn.layers.normalization import decayed

__all__ = ["CUDA_CORES", "FUSED_BWD", "FUSED_FWD", "FusedMatmul",
           "TENSOR_CORES", "bn_act_conv1x1", "bwd_route",
           "fused_conv1x1_supported", "fused_matmul", "fused_matmul_bwd",
           "fused_matmul_bwd_plain", "fused_matmul_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 6 + [_I] * 4 + [_P]
#: the bf16 forward takes its grid's block rows too (:func:`_fwd_plan`)
_FWD_TC_ARGS = [_P] * 6 + [_I] * 5 + [_P]
_BWD_ARGS = [_P] * 13 + [_I] * 7 + [_P]
_ACTS = ("identity", "relu")
#: the backward's two routes: bf16 on the tensor cores (conv_bwd_tc.cuh's
#: fused mode), f32 on the CUDA cores (fused.cu's conv_gemm.cuh tiles)
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


_LIBRARY = CudaLibrary(
    "fused", ["nn/layers/csrc/fused.cu"],
    {"dl4j_fused_fwd_f32": _FWD_ARGS, "dl4j_fused_fwd_bf16": _FWD_TC_ARGS,
     **{s: _BWD_ARGS for s in _symbols("fused_bwd").values()},
     "dl4j_fused_row_tile": [], "dl4j_fused_fwd_tc_smem": [_I, _I],
     "dl4j_fused_bwd_tc_smem": [_I, _I, ctypes.POINTER(ctypes.c_int)]},
    headers=["nn/layers/csrc/conv_gemm.cuh", "nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh",
             "nn/layers/csrc/conv_fwd_tc.cuh",
             "nn/layers/csrc/conv_bwd_tc.cuh"])

#: the two kernels; each ``.launches`` counts its launches (the
#: backward's entry point, which launches its dz and dW passes, counts
#: once)
FUSED_FWD = CudaKernel(_LIBRARY, "fused_fwd", _symbols("fused_fwd"))
FUSED_BWD = CudaKernel(_LIBRARY, "fused_bwd", _symbols("fused_bwd"))


def fused_conv1x1_supported(act: str, dtype) -> bool:
    """Whether the kernels take this op: a relu or identity prologue, f32
    or bf16. Any C and K fit: the kernels tile both (the JAX gate's VMEM
    budget does not apply)."""
    return act in _ACTS and _dtype_ok(dtype)


def bwd_route(dtype) -> str:
    """The backward's route for ``dtype``: TENSOR_CORES for bf16,
    CUDA_CORES for f32. Raises on a dtype no route takes."""
    if not _dtype_ok(dtype):
        raise ValueError(f"fused_matmul_bwd kernels take float32 or "
                         f"bfloat16, got {dtype}")
    return TENSOR_CORES if dtype == torch.bfloat16 else CUDA_CORES


def _bwd_tc_plan(m, c, k, sms) -> BwdPlan:
    """The bf16 backward's launch plan on a card of ``sms`` SMs, as the
    kernel's launcher checks it: the bottleneck's stride-1 1x1 plan
    (:func:`bottleneck._bwd_tc_plan`) over ``m`` images of one pixel, so
    ``tiles`` dz blocks of 128 rows (the sums' partials a channel), and
    the dW pass's 64-row chunks split ``chunk`` a split into ``splits``
    splits (its partials ``[splits, C + 1, K]``, row C holding db)."""
    return _stage_bwd_tc_plan(m, 1, 1, c, k, 1, 1, sms)


def _fwd_plan(m, k, sms) -> FwdPlan:
    """The bf16 forward's launch plan on a card of ``sms`` SMs: the
    bottleneck's stride-1 1x1 plan (:func:`bottleneck._fwd_tc_plan`)
    over ``m`` images of one pixel, so 128-row blocks, 64 or 128 output
    channels a block and the same block rows (``.tiles``), which the
    kernel takes as its grid's rows."""
    return _fwd_tc_plan(m, 1, 1, k, 1, 1, sms)


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def _check(name, y2, sc, bb, w2, act, last):
    """Raise on shapes that do not fit together, on any device; ``last``
    is the third operand's (key, tensor, shape): b or g."""
    if act not in _ACTS:
        raise ValueError(f"{name}: the prologue activation must be relu or "
                         f"identity, got {act!r}")
    if y2.dim() != 2 or w2.dim() != 2 or w2.shape[0] != y2.shape[1]:
        raise ValueError(f"{name}: y2 {tuple(y2.shape)} and w2 "
                         f"{tuple(w2.shape)} are not [M, C] and [C, K]")
    c = w2.shape[0]
    for key, t, shape in (("sc", sc, (c,)), ("bb", bb, (c,)), last):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} is not "
                             f"{shape}")


def _check_cuda(name, y2, w2, f32, same):
    """Raise on what a kernel does not take: y2 f32 or bf16, the
    operands ``same`` (pairs of key and tensor, w2 among them) of its
    dtype and ``f32`` in f32, all contiguous on y2's CUDA device."""
    if not _dtype_ok(y2.dtype) or w2.dtype != y2.dtype:
        raise ValueError(f"{name} kernel takes f32 or bf16 y2 with w2 of "
                         f"the same dtype, got {y2.dtype} and {w2.dtype}")
    if y2.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{y2.device}")
    for key, t, dtype in ([(k, t, y2.dtype) for k, t in same]
                          + [(k, t, torch.float32) for k, t in f32]):
        if t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype}, got "
                             f"{t.dtype}")
        if t.device != y2.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{y2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def fused_matmul(y2, sc, bb, w2, b, act: str = "relu"):
    """``out [M, K] = act(y2 sc + bb) @ w2 + b``: the affine in f32 from
    y2's stored values, rounded to w2's dtype, the product accumulated in
    f32, the f32 bias added, rounded to y2's dtype. y2 ``[M, C]`` (the
    flattened NHWC conv output), sc, bb ``[C]`` f32, w2 ``[C, K]``, b
    ``[K]`` f32. The kernel on CUDA tensors, :func:`fused_matmul_plain`
    on CPU tensors."""
    _check("fused_matmul", y2, sc, bb, w2, act, ("b", b, (w2.shape[1],)))
    if y2.device.type == "cpu":
        return fused_matmul_plain(y2, sc, bb, w2, b, act)
    _check_cuda("fused_matmul", y2, w2,
                (("sc", sc), ("bb", bb), ("b", b)),
                (("y2", y2), ("w2", w2)))
    m, c = y2.shape
    k = w2.shape[1]
    bf16 = y2.dtype == torch.bfloat16
    if bf16 and max(m * c, m * k, c * k) >= _TC_MAX_ELEMENTS:
        raise ValueError(f"fused_matmul: the bf16 kernel indexes with "
                         f"32-bit ints; y2, w2 and the output must each "
                         f"hold fewer than {_TC_MAX_ELEMENTS} elements")
    out = torch.empty((m, k), dtype=y2.dtype, device=y2.device)
    if m and k:
        rows = [_fwd_plan(m, k, _sm_count(y2.device)).tiles] if bf16 else []
        FUSED_FWD.launch(y2.dtype, y2.data_ptr(), sc.data_ptr(),
                         bb.data_ptr(), w2.data_ptr(), b.data_ptr(),
                         out.data_ptr(), m, c, k, int(act == "relu"),
                         *rows, _stream(y2))
    return out


def fused_matmul_bwd(y2, sc, bb, w2, g, act: str = "relu"
                     ) -> Tuple[torch.Tensor, ...]:
    """The one-pass backward of :func:`fused_matmul`: ``(dy [M, C] in
    y2's dtype, dsc [C] f32, dbb [C] f32, dw [C, K] in w2's dtype, db
    [K] f32)`` for the output gradient g ``[M, K]`` (y2's dtype). z0 =
    y2 sc + bb and z = act(z0) are recomputed; dz = g w2^T in f32,
    masked by z0 > 0 under relu; dy = dz sc; dw = z^T g with z rounded to
    g's dtype; dsc = sum dz y2, dbb = sum dz, db = sum g. The kernel on
    CUDA tensors, on the route :func:`bwd_route` names (the same bits
    on every launch: no float atomics), :func:`fused_matmul_bwd_plain`
    on CPU tensors."""
    _check("fused_matmul_bwd", y2, sc, bb, w2, act,
           ("g", g, (y2.shape[0], w2.shape[1])))
    if y2.device.type == "cpu":
        return fused_matmul_bwd_plain(y2, sc, bb, w2, g, act)
    _check_cuda("fused_matmul_bwd", y2, w2, (("sc", sc), ("bb", bb)),
                (("y2", y2), ("w2", w2), ("g", g)))
    m, c = y2.shape
    k = w2.shape[1]
    dev, f32 = y2.device, torch.float32
    dy = torch.empty_like(y2)
    dw = torch.empty((c, k), dtype=w2.dtype, device=dev)
    sums = torch.empty((2, c), dtype=f32, device=dev)
    db = torch.empty(k, dtype=f32, device=dev)
    if not (m and c and k):
        return (dy.zero_(), sums[0].zero_(), sums[1].zero_(), dw.zero_(),
                db.zero_())
    if bwd_route(y2.dtype) == TENSOR_CORES:
        if max(m * c, m * k, (c + 1) * k) >= _TC_MAX_ELEMENTS:
            raise ValueError(f"fused_matmul_bwd: the bf16 kernels index "
                             f"with 32-bit ints; y2, g and the dW partials' "
                             f"rows must each hold fewer than "
                             f"{_TC_MAX_ELEMENTS} elements")
        tiles, chunk, splits = _bwd_tc_plan(m, c, k, _sm_count(dev))
    else:
        tiles = -(-m // _LIBRARY.load().dl4j_fused_row_tile())
        chunk, splits = _dw_splits(m, -(-(c + 1) // 128) * -(-k // 64),
                                   dev)
    part = torch.empty((2, c, tiles), dtype=f32, device=dev)
    dw_part = torch.empty((splits, c + 1, k), dtype=f32, device=dev)
    FUSED_BWD.launch(y2.dtype, y2.data_ptr(), sc.data_ptr(), bb.data_ptr(),
                     w2.data_ptr(), g.data_ptr(), dy.data_ptr(),
                     sums[0].data_ptr(), sums[1].data_ptr(), dw.data_ptr(),
                     db.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
                     dw_part.data_ptr(), m, c, k, int(act == "relu"), tiles,
                     chunk, splits, _stream(y2))
    return dy, sums[0], sums[1], dw, db


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------
def fused_matmul_plain(y2, sc, bb, w2, b, act: str = "relu"):
    """The plain PyTorch version of :func:`fused_matmul`, written as the
    JAX ``_fwd_kernel``: z in sc's dtype (f32) from y2's values, rounded
    to w2's dtype, one product in that accumulation dtype, plus b,
    rounded to y2's dtype."""
    acc = sc.dtype
    z = y2.to(acc) * sc + bb
    if act == "relu":
        z = torch.clamp_min(z, 0.0)
    out = z.to(w2.dtype).to(acc) @ w2.to(acc)
    return (out + b.to(acc)).to(y2.dtype)


def fused_matmul_bwd_plain(y2, sc, bb, w2, g, act: str = "relu"):
    """The plain PyTorch version of :func:`fused_matmul_bwd`, written as
    the JAX ``_bwd_kernel``: dz and dw as products of the stored g and w2
    (or z rounded to g's dtype) in the accumulation dtype, the relu' mask
    on the unrounded z0, dy rounded once, the sums over the unrounded
    dz."""
    acc = sc.dtype
    yf = y2.to(acc)
    gf = g.to(acc)
    z0 = yf * sc + bb
    z = torch.clamp_min(z0, 0.0) if act == "relu" else z0
    dz = gf @ w2.to(acc).t()
    if act == "relu":
        dz = torch.where(z0 > 0, dz, 0.0)
    dy = (dz * sc).to(y2.dtype)
    dw = (z.to(g.dtype).to(acc).t() @ gf).to(w2.dtype)
    return dy, (dz * yf).sum(0), dz.sum(0), dw, gf.sum(0)


# ---------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------
class FusedMatmul(torch.autograd.Function):
    """``apply(act, y2, sc, bb, w2, b)``: :func:`fused_matmul` forward,
    :func:`fused_matmul_bwd` backward (the JAX ``_fused_matmul_pallas``
    and its ``custom_vjp``). Saves only ``(y2, sc, bb, w2)``: z is
    recomputed, never stored."""

    @staticmethod
    def forward(ctx, act, y2, sc, bb, w2, b):
        ctx.act = act
        ctx.save_for_backward(y2, sc, bb, w2)
        return fused_matmul(y2, sc, bb, w2, b, act)

    @staticmethod
    def backward(ctx, g):
        y2, sc, bb, w2 = ctx.saved_tensors
        dy, dsc, dbb, dw, db = fused_matmul_bwd(y2, sc, bb, w2,
                                                g.contiguous(), ctx.act)
        return None, dy, dsc, dbb, dw, db


def bn_act_conv1x1(x, gamma, beta, running_mean, running_var, w,
                   b: Optional[torch.Tensor], *, train: bool,
                   eps: float = 1e-5, decay: float = 0.9,
                   act: str = "relu", data_format: str = "NCHW"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BatchNorm -> activation -> 1x1 conv (stride 1, no padding) in one
    op, as the JAX ``bn_act_conv1x1``.

    x: the RAW preceding conv output, ``[N, C, H, W]``, ``[N, H, W, C]``
    (``data_format="NHWC"``) or ``[M, C]``; w ``[O, I, 1, 1]`` (I == C);
    b ``[O]`` or None. The BN's affine folds into the conv's prologue:
    ``y_hat gamma + beta == x sc + bb`` with ``sc = gamma rsqrt(var +
    eps)``, ``bb = beta - mean sc`` in f32. Training normalizes with the
    batch statistics (one f32 pass) and decays the running statistics,
    rounded through x's dtype first, as the unfused layer does;
    inference normalizes with the running statistics (rounded through
    x's dtype) and returns them as they are. Returns ``(out, new running
    mean, new running var)``, the statistics f32.

    NHWC and ``[M, C]`` inputs run :class:`FusedMatmul` (the kernels on
    the card, their plain versions on the CPU; relu or identity only);
    NCHW runs the einsum formulation, any activation."""
    ch_axis = 3 if (data_format == "NHWC" and x.dim() == 4) else 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    # the unfused layer's precision chain: parameters and running
    # statistics rounded through x's dtype
    gamma32 = gamma.to(x.dtype).to(acc)
    beta32 = beta.to(x.dtype).to(acc)
    rm_q = running_mean.to(x.dtype)
    rv_q = running_var.to(x.dtype)
    if train:
        xf = x.to(acc)
        mean = xf.mean(dim=axes)
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        new_mean = decayed(rm_q, mean, decay)
        new_var = decayed(rv_q, var, decay)
    else:
        mean, var = rm_q.to(acc), rv_q.to(acc)
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps)
    sc = gamma32 * inv
    bb = beta32 - mean * sc
    o, i = w.shape[0], w.shape[1]
    bias = (torch.zeros(o, dtype=acc, device=x.device) if b is None
            else b.to(acc))
    if ch_axis == 3 or x.dim() == 2:
        y2 = x.reshape(-1, x.shape[-1]).contiguous()
        w2 = w.reshape(o, i).t().to(x.dtype).contiguous()
        out = FusedMatmul.apply(act, y2, sc.float().contiguous(),
                                bb.float().contiguous(), w2, bias.float())
        out = out.reshape(*x.shape[:-1], o)
    else:
        z = x.to(acc) * sc.reshape(1, -1, 1, 1) + bb.reshape(1, -1, 1, 1)
        z = torch.clamp_min(z, 0.0) if act == "relu" else \
            activations.get(act)(z)
        out = torch.einsum("nchw,oc->nohw", z.to(x.dtype).to(acc),
                           w.reshape(o, i).to(acc))
        out = (out + bias.reshape(1, -1, 1, 1)).to(x.dtype)
    return out, new_mean.to(torch.float32), new_var.to(torch.float32)
