"""Paged-attention decode over the block-paged KV pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/serving/paged_kernel.py``. The two
kernels are hand-written CUDA C++ for Hopper in one library,
``csrc/paged_attention.cu``: the bf16/f32 pool's (it replaces the TPU
kernel ``_decode_kernel``) and the int8 pool's (``_decode_kernel_quant``;
the source note says what bounds each and what its design does about
that). They read K/V straight through the per-slot page table, so a
decode step touches only the live pages of each row, never a dense copy
of the pool.

:func:`paged_attention` dispatches on where its tensors lie: CUDA
tensors launch a kernel (or raise on what it does not take), CPU
tensors take the plain version. Passing ``k_scales`` and ``v_scales``
selects the int8 kernel. There is no fallback from a kernel to its
plain version and no process-wide switch between them. The plain
versions gather ``pool[table]`` densely, mask and run the softmax in f32
with the kernel's rounding points (:func:`paged_attention_plain`; the
int8 one, :func:`paged_attention_quant_plain`, dequantizes the pools
first, exactly, and is then the same function); the CPU tests hold
them against the JAX package, and ``chip_smoke.py`` holds the kernels
against them on the card.

Appends are not this kernel's job: the layer writes the new tokens'
K/V into the pool before attending (``SelfAttentionLayer.
_stream_attend_paged``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.serving.quant import dequantize

NEG_INF = -1e30   # finite: a fully masked row must stay finite

#: the largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256

__all__ = ["NEG_INF", "PAGED_ATTENTION", "PAGED_ATTENTION_QUANT",
           "paged_attention", "paged_attention_plain",
           "paged_attention_quant_plain", "paged_attention_quant_smem_bytes",
           "paged_attention_smem_bytes"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]
_QUANT_ARGTYPES = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _P]

_SYMBOL = {torch.float32: "dl4j_paged_attention_f32",
           torch.bfloat16: "dl4j_paged_attention_bf16"}
#: the int8 kernel, by the query's (and output's) dtype
_QUANT_SYMBOL = {torch.float32: "dl4j_paged_attention_quant_f32",
                 torch.bfloat16: "dl4j_paged_attention_quant_bf16"}

_LIBRARY = CudaLibrary(
    "paged_attention", ["serving/csrc/paged_attention.cu"],
    {**{sym: _ARGTYPES for sym in _SYMBOL.values()},
     **{sym: _QUANT_ARGTYPES for sym in _QUANT_SYMBOL.values()}})

#: the kernels; ``.launches`` counts each one's launches
PAGED_ATTENTION = CudaKernel(_LIBRARY, "paged_attention", _SYMBOL)
PAGED_ATTENTION_QUANT = CudaKernel(_LIBRARY, "paged_attention_quant",
                                   _QUANT_SYMBOL)


def paged_attention_smem_bytes(rows: int, head_dim: int,
                               page_size: int) -> int:
    """Dynamic shared memory one kernel block uses (all f32): the query
    rows and accumulator, one K and one V page, the score tile and the
    three per-row softmax scalars."""
    return 4 * (2 * rows * head_dim + 2 * page_size * head_dim
                + rows * page_size + 3 * rows)


def paged_attention_quant_smem_bytes(rows: int, head_dim: int,
                                     page_size: int) -> int:
    """Dynamic shared memory one int8-kernel block uses: the f32 query
    rows, accumulator, score tile and three per-row scalars (padded to
    16 bytes), then one int8 K and one int8 V page (each padded to 16
    bytes)."""
    words = 2 * rows * head_dim + rows * page_size + 3 * rows
    page = page_size * head_dim
    return 4 * (-(-words // 4) * 4) + 2 * (-(-page // 16) * 16)


def _shape(q, k_pool, table, query_width):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"q and the pools must be 4-D, got "
                         f"{tuple(q.shape)} and {tuple(k_pool.shape)}")
    S, hkv, rw, d = q.shape
    qw = int(query_width)
    if qw < 1 or rw % qw:
        raise ValueError(f"query rows {rw} not divisible by "
                         f"query_width {qw}")
    return S, hkv, rw, d, k_pool.shape[2], table.shape[1], qw


def paged_attention(q, k_pool, v_pool, table, lengths, *,
                    query_width: int, k_scales=None, v_scales=None):
    """Paged-attention decode.

    - ``q``: ``[S, Hkv, reps*W, D]`` queries grouped by kv head, rope
      applied; row ``rep*W + w`` sits at position ``lengths[s] - W + w``.
    - ``k_pool`` / ``v_pool``: ``[P, Hkv, page_size, D]``, already
      holding this step's appended tokens; q's dtype, or int8 with
      scales.
    - ``table``: ``[S, n_max]`` int32 page ids (0 = the null page).
    - ``lengths``: ``[S]`` int32 valid positions per row, the appended
      chunk included.
    - ``k_scales`` / ``v_scales``: ``[P, Hkv]`` f32, the int8 pool's
      per-(page, head) scale sidecars (``serving/quant.py``). Passing
      them selects the int8 kernel: they travel together and the pools
      must be int8.

    Returns ``[S, Hkv, reps*W, D]`` in ``q.dtype`` (f32 accumulation).
    On CUDA a page id outside the pool turns its (slot, head) output to
    NaN rather than reading past the pool."""
    S, hkv, rw, d, ps, n_max, qw = _shape(q, k_pool, table, query_width)
    quant = k_scales is not None or v_scales is not None
    if quant and (k_scales is None or v_scales is None):
        raise ValueError("k_scales and v_scales travel together")
    if quant and (k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8):
        raise ValueError(f"scale sidecars describe an int8 pool, got "
                         f"{k_pool.dtype} / {v_pool.dtype}")
    if q.device.type == "cpu":
        if quant:
            return paged_attention_quant_plain(
                q, k_pool, v_pool, table, lengths, query_width=qw,
                k_scales=k_scales, v_scales=v_scales)
        return paged_attention_plain(q, k_pool, v_pool, table, lengths,
                                     query_width=qw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    extra = (("k_scales", k_scales), ("v_scales", v_scales)) if quant else ()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("lengths", lengths), *extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"paged_attention kernels take float32 or "
                         f"bfloat16 queries, got {q.dtype}")
    if not quant and (k_pool.dtype != q.dtype or v_pool.dtype != q.dtype):
        raise ValueError(f"pools ({k_pool.dtype}, {v_pool.dtype}) must "
                         f"match q ({q.dtype})")
    if tuple(k_pool.shape) != tuple(v_pool.shape) or \
            k_pool.shape[1] != hkv or k_pool.shape[3] != d:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("table and lengths must be int32")
    if table.dim() != 2 or table.shape[0] != S or \
            tuple(lengths.shape) != (S,):
        raise ValueError(f"table {tuple(table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not fit {S} slots")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    if quant:
        for name, t in extra:
            if t.dtype != torch.float32 or \
                    tuple(t.shape) != tuple(k_pool.shape[:2]):
                raise ValueError(f"{name} must be float32 "
                                 f"{tuple(k_pool.shape[:2])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        smem = paged_attention_quant_smem_bytes(rw, d, ps)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"rows {rw} x head dim {d} x page size {ps} "
                             f"need {smem} B of shared memory "
                             f"(> {MAX_SMEM_BYTES})")
        PAGED_ATTENTION_QUANT.launch(
            q.dtype, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), S, hkv, rw, d, ps, n_max,
            k_pool.shape[0], qw, 1.0 / math.sqrt(d), stream)
        return out
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    smem = paged_attention_smem_bytes(rw, d, ps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rows {rw} x head dim {d} x page size {ps} need "
                         f"{smem} B of shared memory (> {MAX_SMEM_BYTES})")
    PAGED_ATTENTION.launch(
        q.dtype, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, hkv, rw, d, ps, n_max, k_pool.shape[0], qw,
        1.0 / math.sqrt(d), stream)
    return out


def paged_attention_plain(q, k_pool, v_pool, table, lengths, *,
                          query_width: int):
    """The plain PyTorch version of :func:`paged_attention`: gather
    ``pool[table]`` densely, mask keys past each query's position, and
    take the softmax in f32 with the kernel's rounding points (masked
    probabilities zeroed, so a fully masked row gives 0; p rounded to
    the value dtype before the PV product; output ``acc / max(l,
    1e-30)``)."""
    S, hkv, rw, d, ps, nb, qw = _shape(q, k_pool, table, query_width)
    idx = table.long()
    kd = k_pool[idx].transpose(1, 2).reshape(S, hkv, nb * ps, d)
    vd = v_pool[idx].transpose(1, 2).reshape(S, hkv, nb * ps, d)
    kpos = torch.arange(nb * ps, device=q.device)
    qpos = (lengths.long()[:, None] - qw
            + torch.arange(rw, device=q.device)[None, :] % qw)  # [S, rw]
    valid = (kpos[None, None, :] <= qpos[..., None])[:, None]  # [S,1,rw,L]
    s = torch.einsum("nhrd,nhld->nhrl", q.float(),
                     kd.float()) * (1.0 / math.sqrt(d))
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nhrl,nhld->nhrd", p.to(v_pool.dtype).float(),
                     vd.float())
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def paged_attention_quant_plain(q, k_pool, v_pool, table, lengths, *,
                                query_width: int, k_scales, v_scales):
    """The plain PyTorch version of the int8 kernel: dequantize the int8
    pools to f32 under their per-(page, head) scales (exact: the scales
    are powers of two), then :func:`paged_attention_plain`, whose
    rounding of p to the value dtype is then a no-op (the int8 kernel
    keeps p in f32)."""
    kd = dequantize(k_pool, k_scales[:, :, None, None])
    vd = dequantize(v_pool, v_scales[:, :, None, None])
    return paged_attention_plain(q, kd, vd, table, lengths,
                                 query_width=query_width)
