"""Paged-attention decode over the block-paged KV pool: the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``deeplearning4j_tpu/serving/paged_kernel.py``. The two
kernels are hand-written CUDA C++ for Hopper in one library,
``csrc/paged_attention.cu``: the bf16/f32 pool's (it replaces the TPU
kernel ``_decode_kernel``) and the int8 pool's (``_decode_kernel_quant``;
the source note says what bounds each and what its design does about
that). They read K/V straight through the per-slot page table, so a
decode step touches only the live pages of each row, never a dense copy
of the pool. Both are one body over the pool's element type: each row's
live pages split over the warps of its block (and, at a verify shape,
over up to 8 blocks), which combine their online-softmax partials in a
fixed order; :func:`decode_split_plan` mirrors how it cuts the rows,
the pages and the head dim.

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
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary
from deeplearning4j_tpu_torch.serving.quant import dequantize

NEG_INF = -1e30   # finite: a fully masked row must stay finite

#: the largest dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256

__all__ = ["DecodeSplitPlan", "NEG_INF", "PAGED_ATTENTION",
           "PAGED_ATTENTION_QUANT", "decode_split_plan",
           "paged_attention", "paged_attention_plain",
           "paged_attention_quant_plain", "paged_attention_quant_smem_bytes",
           "paged_attention_smem_bytes"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]
_QUANT_ARGTYPES = [_P] * 10 + [_I] * 9 + [ctypes.c_float, _P]

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


class DecodeSplitPlan(NamedTuple):
    """How ``csrc/paged_attention.cu``'s split decode cuts one (slot, kv
    head): ``splits`` blocks; the query rows in ``tiles`` tiles of
    ``rows_per_tile``; ``warps`` a block, ``warps_per_tile`` of them on
    each tile (block b's warp w takes tiles ``w // warps_per_tile + i *
    groups`` and, of each, the live pages ``b * warps_per_tile + w %
    warps_per_tile + j * splits * warps_per_tile``); ``chunk_keys`` keys
    a warp scores at a time, one online-softmax update (a key's head dim
    in 16-byte vectors, or single values, over a power of two of lanes;
    a few such keys a lane); ``smem_bytes`` the warps' f32 partials and,
    where a tile holds several rows, the query's rows (f32, whole
    tiles)."""
    splits: int
    rows_per_tile: int
    tiles: int
    warps: int
    warps_per_tile: int
    groups: int
    chunk_keys: int
    smem_bytes: int

    def warp_pages(self, warp: int, n_live: int, split: int = 0):
        """[(tile, [page indices])] of block ``split``'s ``warp`` for a
        row with ``n_live`` live pages."""
        g, share = divmod(warp, self.warps_per_tile)
        if g >= self.groups:
            return []
        stride = self.splits * self.warps_per_tile
        pages = list(range(split * self.warps_per_tile + share, n_live,
                           stride))
        return [(t, pages) for t in range(g, self.tiles, self.groups)]


def decode_split_plan(rows: int, head_dim: int, elem_bytes: int = 2,
                      vec: bool = True, pairs: int = 1, sms: int = 1,
                      n_max: int = 1) -> DecodeSplitPlan:
    """The split decode's plan for ``rows`` query rows at ``head_dim``,
    pool values of ``elem_bytes`` bytes (1: the int8 pool: two passes a
    chunk, of 16-byte vectors for one row, one 16-key page at D = 64, and
    of 8-byte ones for a tile of 4 rows, 8 keys), ``pairs`` (slot, kv
    head) pairs of up to ``n_max`` pages on a card of ``sms`` SMs;
    ``vec``: the vector route (the head dim a whole number of vectors,
    the pools aligned to one), else element by element. One block a pair, except where
    several query rows make each page's work heavy and the pairs leave
    SMs idle: then as many blocks as fill the SMs, at most 8 and no more
    than the pages give every warp one (the blocks' partials then cost a
    second combine)."""
    rt = 1 if rows == 1 else 4
    warps = 16
    tiles = -(-rows // rt)
    wpt = max(1, warps // tiles)
    ve = (8 if elem_bytes == 1 and rt > 1 else 16 // elem_bytes) if vec \
        else 1
    nv = head_dim // ve
    lpk = 1
    while lpk < nv and lpk < 32:
        lpk *= 2
    if ve == 1:
        passes = 1
    elif elem_bytes == 1:
        passes = 2
    else:
        passes = (8 if rt == 1 else 4) // elem_bytes
    q_rows = tiles * rt if rt > 1 else 0
    splits = 1 if rt == 1 else \
        max(1, min(8, sms // max(pairs, 1), -(-n_max // wpt)))
    return DecodeSplitPlan(splits, rt, tiles, warps, wpt, warps // wpt,
                           passes * (32 // lpk),
                           4 * (wpt * rows * (head_dim + 2)
                                + q_rows * head_dim))


def paged_attention_smem_bytes(rows: int, head_dim: int,
                               page_size: int) -> int:
    """Dynamic shared memory one block of the bf16/f32 kernel uses: its
    warps' partials (m, l and the accumulator of each row, f32) and a
    tiled query's rows; the page size adds nothing (no page is staged)."""
    return decode_split_plan(rows, head_dim).smem_bytes


def paged_attention_quant_smem_bytes(rows: int, head_dim: int,
                                     page_size: int) -> int:
    """Dynamic shared memory one int8-kernel block uses: the split
    decode's, as the bf16/f32 kernel's (no page is staged)."""
    return decode_split_plan(rows, head_dim, 1).smem_bytes


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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    if quant:
        for name, t in extra:
            if t.dtype != torch.float32 or \
                    tuple(t.shape) != tuple(k_pool.shape[:2]):
                raise ValueError(f"{name} must be float32 "
                                 f"{tuple(k_pool.shape[:2])}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    plan = decode_split_plan(
        rw, d, k_pool.element_size(), pairs=S * hkv, n_max=n_max,
        sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    if plan.smem_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"rows {rw} x head dim {d} x page size {ps} need "
                         f"{plan.smem_bytes} B of shared memory "
                         f"(> {MAX_SMEM_BYTES})")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    part = counters = None
    if plan.splits > 1:
        # the blocks' partials, and their done-counters (zeros the kernel
        # leaves zero, kept for the stream)
        part = torch.empty(S * hkv * plan.splits * rw * (d + 2),
                           dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, S * hkv)
    scratch = (part.data_ptr() if part is not None else None,
               counters.data_ptr() if counters is not None else None,
               S, hkv, rw, d, ps, n_max, k_pool.shape[0], qw, plan.splits,
               1.0 / math.sqrt(d), stream)
    if quant:
        PAGED_ATTENTION_QUANT.launch(
            q.dtype, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), *scratch)
    else:
        PAGED_ATTENTION.launch(
            q.dtype, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), out.data_ptr(), *scratch)
    return out


#: (device, stream) -> the split decode's int32 done-counters: zero, and
#: zero again after every launch (its last block of each pair resets its
#: own), so one buffer serves every launch on that stream, replays of
#: the CUDA graphs captured on it included
_COUNTERS = {}
#: counters a larger buffer replaced: a graph captured over one still
#: writes it at every replay, so none is ever freed
_RETIRED_COUNTERS = []


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The stream's counters, made (or grown) outside any capture: a
    buffer made inside one would come from that graph's private pool
    and, once the graph is dropped, be memory a later graph reuses. A
    capture must follow an eager launch of the same shape on its stream
    (the engine's warm-up pass)."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention: the split decode's counters for this "
                "stream must exist before a CUDA graph capture (launch "
                "once eagerly on the capture stream first)")
        if c is not None:
            _RETIRED_COUNTERS.append(c)
        c = _COUNTERS[key] = torch.zeros(max(n, 64), dtype=torch.int32,
                                         device=device)
    return c


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
