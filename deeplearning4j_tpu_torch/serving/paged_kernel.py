"""Paged-attention decode over the block-paged KV pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/serving/paged_kernel.py``. The
kernel is hand-written CUDA C++ for Hopper, ``csrc/paged_attention.cu``
(it replaces the TPU kernel ``_decode_kernel``; the source note there
says what bounds it and what its design does about that). It reads K/V
straight through the per-slot page table, so a decode step touches only
the live pages of each row, never a dense copy of the pool.

:func:`paged_attention` dispatches on where its tensors lie: CUDA
tensors launch the kernel (or raise on what it does not take), CPU
tensors take :func:`paged_attention_plain`. There is no fallback from
the kernel to the plain version and no process-wide switch between
them. The plain version gathers ``pool[table]`` densely, masks and
runs the softmax in f32 with the kernel's rounding points; the CPU
tests hold it against the JAX package, and ``chip_smoke.py`` holds the
kernel against it on the card.

Appends are not this kernel's job: the layer writes the new tokens'
K/V into the pool before attending (``SelfAttentionLayer.
_stream_attend_paged``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary

NEG_INF = -1e30   # finite: a fully masked row must stay finite

#: the largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256

__all__ = ["NEG_INF", "PAGED_ATTENTION", "paged_attention",
           "paged_attention_plain", "paged_attention_smem_bytes"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 8 + [ctypes.c_float, _P]

_SYMBOL = {torch.float32: "dl4j_paged_attention_f32",
           torch.bfloat16: "dl4j_paged_attention_bf16"}

#: the kernel; ``PAGED_ATTENTION.launches`` counts launches
PAGED_ATTENTION = CudaKernel(
    CudaLibrary("paged_attention", ["serving/csrc/paged_attention.cu"],
                {sym: _ARGTYPES for sym in _SYMBOL.values()}),
    "paged_attention", _SYMBOL)


def paged_attention_smem_bytes(rows: int, head_dim: int,
                               page_size: int) -> int:
    """Dynamic shared memory one kernel block uses (all f32): the query
    rows and accumulator, one K and one V page, the score tile and the
    three per-row softmax scalars."""
    return 4 * (2 * rows * head_dim + 2 * page_size * head_dim
                + rows * page_size + 3 * rows)


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
                    query_width: int):
    """Paged-attention decode.

    - ``q``: ``[S, Hkv, reps*W, D]`` queries grouped by kv head, rope
      applied; row ``rep*W + w`` sits at position ``lengths[s] - W + w``.
    - ``k_pool`` / ``v_pool``: ``[P, Hkv, page_size, D]``, already
      holding this step's appended tokens; same dtype as ``q``.
    - ``table``: ``[S, n_max]`` int32 page ids (0 = the null page).
    - ``lengths``: ``[S]`` int32 valid positions per row, the appended
      chunk included.

    Returns ``[S, Hkv, reps*W, D]`` in ``q.dtype`` (f32 accumulation).
    On CUDA a page id outside the pool turns its (slot, head) output to
    NaN rather than reading past the pool."""
    S, hkv, rw, d, ps, n_max, qw = _shape(q, k_pool, table, query_width)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, lengths,
                                     query_width=qw)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _SYMBOL:
        raise ValueError(f"paged_attention kernel takes float32 or "
                         f"bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    smem = paged_attention_smem_bytes(rw, d, ps)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"rows {rw} x head dim {d} x page size {ps} need "
                         f"{smem} B of shared memory (> {MAX_SMEM_BYTES})")
    out = torch.empty_like(q)
    PAGED_ATTENTION.launch(
        q.dtype, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        S, hkv, rw, d, ps, n_max, k_pool.shape[0], qw,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
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
