"""Flash attention: the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd function that joins them.

Counterpart of ``deeplearning4j_tpu/nn/layers/pallas_attention.py``
(``flash_attention`` and its recompute-form custom VJP). Layout
``[B, H, T, D]``; ``Tq`` may differ from ``Tk`` unless causal; the key
mask ``[B, Tk]`` is nonzero for valid keys. The three kernels are
hand-written CUDA C++ for Hopper, ``csrc/flash_attention.cu`` (it
replaces the TPU kernels ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``; the source note there says what bounds them and
what their design does about that).

The three kernels have two routes, chosen by dtype and head dim in one
place, :func:`kernel_route`: bf16 at a head dim that is a multiple of 16
up to 128 runs on the tensor cores (``mma.sync`` tiles, the C entry
points ``*_bf16_mma``); f32 (exact, no TF32) and every other head dim up
to 256 run on the CUDA cores. Both routes of a kernel count under the
same :class:`CudaKernel`. A launch on the tensor-core route that fails
raises; nothing drops to the other route.

:class:`FlashAttention` saves ``(q, k, v, o, lse)`` in the forward. Its
backward computes ``delta = rowsum(dO * O)`` in f32 as a plain torch op
(the JAX package also computes it outside any kernel), then runs the dq
kernel and the dk/dv kernel.

Each wrapper dispatches on where its tensors lie: CUDA tensors launch
the kernel (or raise on what it does not take: the dtype, a head dim
over 256, a non-contiguous tensor, on the tensor-core route a tensor
off a 16-byte boundary; a launch error, such as shared memory
the card refuses, comes back from the kernel's launcher and is raised
too), CPU tensors take the plain version beside it. There is no
fallback from the kernel to the plain version and no switch between
them. The plain versions build the whole ``[B, H, Tq, Tk]`` score
matrix and keep the kernels' masking (the finite -1e30 before the
exponential, masked probabilities zeroed after it, so a fully masked
row gives 0 and zero gradients) and rounding points (p to V's dtype before P.V, to dO's before p^T.dO; ds
to K's before ds.K, to Q's before ds^T.Q; f32 elsewhere). The CPU tests
hold them against the JAX package; ``chip_smoke.py`` holds the kernels
against them on the card.

Not in this slice: sliding windows (``window``, ROADMAP.md A6), the
query offset and the differentiable-lse variant that only ring
attention uses (``q_offset``, ``flash_attention_lse``, A9).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary

NEG_INF = -1e30   # finite: a fully masked row must stay finite
LOG2E = float(np.log2(np.e))   # the scores run in base 2, as on the TPU
LN2 = float(np.log(2.0))

MAX_HEAD_DIM = 256
#: the tensor-core kernels take bf16 head dims that are multiples of
#: TC_HEAD_DIM_STEP up to TC_MAX_HEAD_DIM
TC_MAX_HEAD_DIM = 128
TC_HEAD_DIM_STEP = 16
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"

__all__ = ["CUDA_CORES", "FLASH_BWD_DKV", "FLASH_BWD_DQ", "FLASH_FWD",
           "FlashAttention", "TENSOR_CORES", "agreement", "flash_attention",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dkv_plain",
           "flash_attention_bwd_dq", "flash_attention_bwd_dq_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_lse", "kernel_route"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 6 + [_I] * 6 + [_F, _P]
_BWD_DQ_ARGS = [_P] * 8 + [_I] * 6 + [_F, _F, _P]
_BWD_DKV_ARGS = [_P] * 9 + [_I] * 6 + [_F, _F, _P]


def _symbols(stem):
    """A kernel's entry points by (dtype, route)."""
    return {(torch.float32, CUDA_CORES): f"dl4j_{stem}_f32",
            (torch.bfloat16, CUDA_CORES): f"dl4j_{stem}_bf16",
            (torch.bfloat16, TENSOR_CORES): f"dl4j_{stem}_bf16_mma"}


_LIBRARY = CudaLibrary(
    "flash_attention", ["nn/layers/csrc/flash_attention.cu"],
    {**{s: _FWD_ARGS for s in _symbols("flash_fwd").values()},
     **{s: _BWD_DQ_ARGS for s in _symbols("flash_bwd_dq").values()},
     **{s: _BWD_DKV_ARGS for s in _symbols("flash_bwd_dkv").values()}},
    headers=["nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh"])

#: the three kernels; each ``.launches`` counts its launches on either
#: route
FLASH_FWD = CudaKernel(_LIBRARY, "flash_fwd", _symbols("flash_fwd"))
FLASH_BWD_DQ = CudaKernel(_LIBRARY, "flash_bwd_dq",
                          _symbols("flash_bwd_dq"))
FLASH_BWD_DKV = CudaKernel(_LIBRARY, "flash_bwd_dkv",
                           _symbols("flash_bwd_dkv"))


def kernel_route(dtype, d) -> str:
    """The route of the forward, dq and dk/dv kernels for ``dtype`` and
    head dim ``d``: TENSOR_CORES for bf16 at a multiple of 16 up to 128,
    else CUDA_CORES (f32 stays exact f32). Raises on what no route
    takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernels take float32 or bfloat16, got "
                         f"{dtype}")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernels: head dim {d} is not in "
                         f"1..{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and d % TC_HEAD_DIM_STEP == 0 and \
            d <= TC_MAX_HEAD_DIM:
        return TENSOR_CORES
    return CUDA_CORES


def _shape(q, k, v, key_mask, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if tuple(k.shape) != (b, h, tk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if causal and tq != tk:
        raise ValueError(f"causal flash attention needs Tq == Tk (got {tq} "
                         f"vs {tk})")
    if key_mask is not None and tuple(key_mask.shape) != (b, tk):
        raise ValueError(f"key_mask {tuple(key_mask.shape)} is not "
                         f"[B, Tk] = {(b, tk)}")
    return b, h, tq, tk, d


def _acc_dtype(dtype):
    """f32 accumulation, f64 kept (the gradient checks run in f64)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_cuda(name, d, **tensors):
    """Raise on what the kernel does not take; every tensor lies on the
    first one's device, is contiguous and has its dtype, and that device
    is a CUDA device (checked last)."""
    first = next(iter(tensors.values()))
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} kernel takes float32 or bfloat16, got "
                         f"{first.dtype}")
    for key, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not "
                             f"{first.device}")
        want = torch.float32 if key in ("lse", "delta") else first.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} exceeds {MAX_HEAD_DIM}")
    if first.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{first.device}")


def agreement(x, ref):
    """How closely ``x`` agrees with ``ref`` (both ``[B, H, T, D]``), as
    ``(row_rel, tile_rel)``: the largest error in a row over the largest
    ``|ref|`` of that row, at its largest; and over each 64 rows (the
    kernels' tile; batches and heads pooled) the summed error over the
    summed ``|ref|``, at its largest. A row whose reference stays under
    1e-3 of the largest ``|ref|`` (a masked row, or the rounding noise of
    a cancellation: the dq of a query that sees one key is ``p (dp -
    delta) = 0`` up to rounding) is measured against that floor instead. A tile whose reference is all zero scores 0 where ``x`` is
    zero there too, else inf; a non-finite ``x`` scores inf.

    Both scale with each row's own size, so a fault confined to late
    rows of a long sequence (whose outputs are small) counts as much as
    one in early rows. In bf16, two computations that round at the same
    points differ by one ulp in a few elements (``row_rel`` <= 2^-7,
    ``tile_rel`` ~1e-6); rounding at other points changes a third of
    them (``tile_rel`` ~1e-3)."""
    tile = 64
    x, ref = x.double(), ref.double()
    err = torch.where(torch.isfinite(x), (x - ref).abs(),
                      torch.full_like(x, float("inf")))
    mag = ref.abs()

    def ratio(e, m):
        out = e / m.clamp_min(torch.finfo(torch.float64).tiny)
        return torch.where(m > 0, out, torch.where(
            e > 0, torch.full_like(e, float("inf")), torch.zeros_like(e)))

    def tiles(a):
        rows = a.sum(dim=(0, 1, 3))
        pad = (-rows.shape[0]) % tile
        return torch.nn.functional.pad(rows, (0, pad)).view(-1, tile).sum(1)

    row_mag = mag.amax(dim=-1).clamp_min(1e-3 * float(mag.max()))
    row_rel = ratio(err.amax(dim=-1), row_mag)
    tile_rel = ratio(tiles(err), tiles(mag))
    return float(row_rel.max()), float(tile_rel.max())


def _key_flags(key_mask, device):
    """The key mask as contiguous uint8 flags (1 = valid) on ``device``,
    or None for no mask."""
    if key_mask is None:
        return None
    if key_mask.device != device:
        raise ValueError(f"key_mask is on {key_mask.device}, not {device}")
    return (key_mask != 0).to(torch.uint8).contiguous()


def _scale(d):
    """``1 / sqrt(D)``, as the JAX package rounds it (a Python float; the
    base-2 factor is ``_scale(d) * LOG2E``)."""
    return float(1.0 / np.sqrt(d))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def flash_attention_fwd(q, k, v, key_mask=None, causal=False):
    """Forward: ``(o, lse)``, ``o`` ``[B, H, Tq, D]`` in q's dtype and
    ``lse`` ``[B, H, Tq]`` f32 (natural log). The kernel on CUDA
    tensors, :func:`flash_attention_fwd_plain` on CPU tensors."""
    b, h, tq, tk, d = _shape(q, k, v, key_mask, causal)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, key_mask, causal)
    _check_cuda("flash_attention_fwd", d, q=q, k=k, v=v)
    km = _key_flags(key_mask, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    route = _checked_route("flash_attention_fwd", q, k, v, o)
    FLASH_FWD.launch((q.dtype, route), q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), _ptr(km), o.data_ptr(), lse.data_ptr(),
                     b * h, h, tq, tk, d, int(causal), _scale(d) * LOG2E,
                     _stream(q))
    return o, lse


def flash_attention_bwd_dq(q, k, v, key_mask, do, lse, delta, causal=False):
    """Backward dq ``[B, H, Tq, D]`` in q's dtype, from the forward's
    ``lse`` and ``delta = rowsum(dO * O)`` (both ``[B, H, Tq]`` f32).
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    b, h, tq, tk, d = _shape(q, k, v, key_mask, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, key_mask, do, lse,
                                            delta, causal)
    _check_cuda("flash_attention_bwd_dq", d, q=q, k=k, v=v, do=do,
                lse=lse, delta=delta)
    _check_rows(q, do, lse, delta)
    km = _key_flags(key_mask, q.device)
    dq = torch.empty_like(q)
    route = _checked_route("flash_attention_bwd_dq", q, k, v, do, dq)
    FLASH_BWD_DQ.launch((q.dtype, route), q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), _ptr(km), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        b * h, h, tq, tk, d, int(causal), _scale(d),
                        _scale(d) * LOG2E, _stream(q))
    return dq


def flash_attention_bwd_dkv(q, k, v, key_mask, do, lse, delta,
                            causal=False):
    """Backward ``(dk, dv)``, each ``[B, H, Tk, D]`` in k's dtype. The
    kernel on CUDA tensors, the plain version on CPU tensors."""
    b, h, tq, tk, d = _shape(q, k, v, key_mask, causal)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, key_mask, do, lse,
                                             delta, causal)
    _check_cuda("flash_attention_bwd_dkv", d, q=q, k=k, v=v, do=do,
                lse=lse, delta=delta)
    _check_rows(q, do, lse, delta)
    km = _key_flags(key_mask, q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    route = _checked_route("flash_attention_bwd_dkv", q, k, v, do, dk, dv)
    FLASH_BWD_DKV.launch((q.dtype, route), q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), _ptr(km), do.data_ptr(),
                         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), b * h, h, tq, tk, d, int(causal),
                         _scale(d), _scale(d) * LOG2E, _stream(q))
    return dk, dv


def _checked_route(name, q, *tensors):
    """The kernel route for q's dtype and head dim; on the tensor-core
    route every bf16 tensor must start on a 16-byte boundary (its
    copies are 16 bytes wide)."""
    route = kernel_route(q.dtype, q.shape[-1])
    if route == TENSOR_CORES:
        for t in (q, *tensors):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the tensor-core route needs "
                                 f"16-byte aligned tensors")
    return route


def _check_rows(q, do, lse, delta):
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} is not q's shape "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != tuple(q.shape[:3]):
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, H, Tq] "
                             f"= {tuple(q.shape[:3])}")


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------
def _valid(key_mask, causal, tq, tk, device):
    """Boolean ``[B|1, 1, Tq|1, Tk]`` validity of each (query, key)
    pair, or None where every pair is valid."""
    valid = None
    if causal:
        i = torch.arange(tq, device=device)
        j = torch.arange(tk, device=device)
        valid = (j[None, :] <= i[:, None])[None, None]
    if key_mask is not None:
        km = (key_mask != 0)[:, None, None, :]
        valid = km if valid is None else valid & km
    return valid


def _scores(q, k, key_mask, causal):
    """Base-2 scores ``(q . k) * scale * log2 e`` in the accumulation
    dtype, masked to NEG_INF, and the validity mask."""
    acc = _acc_dtype(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    s.mul_(_scale(q.shape[-1]) * LOG2E)
    valid = _valid(key_mask, causal, q.shape[2], k.shape[2], q.device)
    if valid is not None:
        s.masked_fill_(~valid, NEG_INF)
    return s, valid


def _probs(q, k, key_mask, lse, causal):
    """The forward's probabilities rebuilt from its lse:
    ``exp2(s - lse log2 e)``, masked ones zeroed."""
    p, valid = _scores(q, k, key_mask, causal)
    p.sub_((lse * LOG2E)[..., None]).exp2_()
    if valid is not None:
        p.mul_(valid)
    return p


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` and widened back to x's dtype."""
    return x.to(dtype).to(x.dtype)


def flash_attention_fwd_plain(q, k, v, key_mask=None, causal=False):
    """The plain PyTorch version of :func:`flash_attention_fwd`: the
    whole score matrix, one softmax (the kernel's is online, over key
    tiles: the same function, rounded at other places in the last
    bits)."""
    _shape(q, k, v, key_mask, causal)
    p, valid = _scores(q, k, key_mask, causal)
    m = p.amax(dim=-1, keepdim=True)
    p.sub_(m).exp2_()
    if valid is not None:
        p.mul_(valid)   # a fully masked row: exp2(NEG_INF - NEG_INF) = 1
    lc = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(_rounded(p, v.dtype), v.to(p.dtype)) / lc
    lse = (m * LN2 + torch.log(lc)).squeeze(-1)
    return o.to(q.dtype), lse


def flash_attention_bwd_dq_plain(q, k, v, key_mask, do, lse, delta,
                                 causal=False):
    """The plain PyTorch version of :func:`flash_attention_bwd_dq`:
    ``ds = p (dO.V^T - delta) scale``, rounded to K's dtype, times K."""
    _shape(q, k, v, key_mask, causal)
    p = _probs(q, k, key_mask, lse, causal)
    dp = torch.matmul(do.to(p.dtype), v.to(p.dtype).transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p).mul_(_scale(q.shape[-1]))
    return torch.matmul(_rounded(ds, k.dtype), k.to(p.dtype)).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, key_mask, do, lse, delta,
                                  causal=False):
    """The plain PyTorch version of :func:`flash_attention_bwd_dkv`:
    ``dv = p^T dO`` (p rounded to dO's dtype) and ``dk = ds^T Q`` (ds
    rounded to Q's dtype)."""
    _shape(q, k, v, key_mask, causal)
    p = _probs(q, k, key_mask, lse, causal)
    acc = p.dtype
    dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = dp.sub_(delta[..., None]).mul_(p).mul_(_scale(q.shape[-1]))
    del p
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2), q.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------
class FlashAttention(torch.autograd.Function):
    """Flash attention in the recompute form: the forward saves
    ``(q, k, v, o, lse)``; the backward rebuilds the probabilities per
    tile from ``lse`` (the dq and dk/dv kernels, or their plain versions
    on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        o, lse = flash_attention_fwd(q, k, v, key_mask, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.key_mask = key_mask
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        acc = _acc_dtype(o.dtype)
        delta = (do.to(acc) * o.to(acc)).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, ctx.key_mask, do, lse, delta,
                                    ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, ctx.key_mask, do, lse,
                                         delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, key_mask=None, *,
                    window=None, q_offset: int = 0):
    """Fused flash attention. q ``[B, H, Tq, D]``; k, v ``[B, H, Tk,
    D]``; key_mask ``[B, Tk]`` (nonzero = valid). Tq and Tk may differ
    unless causal. Differentiable through :class:`FlashAttention`."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window flash attention is not ported yet "
            "(ROADMAP.md A6)")
    if q_offset:
        raise NotImplementedError(
            "q_offset (banded ring-attention chunks) is not ported yet "
            "(ROADMAP.md A9)")
    return FlashAttention.apply(q, k, v, key_mask, bool(causal))


def flash_attention_lse(*args, **kwargs):
    """The differentiable-lse variant, used only by ring attention: not
    ported yet."""
    raise NotImplementedError(
        "flash_attention_lse (ring attention's (o, lse) combine) is not "
        "ported yet (ROADMAP.md A9)")
