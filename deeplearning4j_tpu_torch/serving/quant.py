"""int8 KV page-pool quantization (``PagedKVConfig(kv_dtype="int8")``).

Counterpart of ``deeplearning4j_tpu/serving/quant.py``, bit for bit.
Paged decode is bound by the bytes of the live pages it reads; storing
the pool in symmetric int8 halves those bytes against bf16 and doubles
the pages a fixed byte budget buys.

Scheme, symmetric per-(page, kv-head) power-of-two scales:

- each kv leaf's pool is ``[P, Hkv, page_size, D]`` int8 with a
  ``[P, Hkv]`` float32 scale sidecar (page 0 stays the null page; its
  scale holds whatever colliding writes left, and nothing valid reads
  through it);
- a page's scale comes from its base token (``q_pos % page_size == 0``):
  ``sigma = pow2ceil(amax / 127)``. Later tokens of the page quantize
  under the base's sigma, ``q = clip(round(x / sigma), -127, 127)``, so
  a page is priced once and never rescaled (quantize-once: pool bytes
  are a function of the committed token stream, not of visit order);
- a power-of-two sigma makes ``dequantize(q) = q * sigma`` exact in f32
  and in bf16 (|q| <= 127 needs 7 mantissa bits): a page reads back the
  same values on every dispatch, which keeps prefix hit == miss bitwise.

The write path is ``SelfAttentionLayer._stream_attend_paged``
(:func:`quantize_chunk` is its per-leaf worker); the read paths are the
layer's dequantize-in-the-gather prime read and the int8 paged-decode
kernel (``serving/paged_kernel.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

__all__ = ["KV_DTYPES", "dequantize", "kv_page_bytes", "pool_leaves",
           "pow2ceil", "quantize", "quantize_chunk"]

#: the ``PagedKVConfig.kv_dtype`` vocabulary: "bf16" is the unquantized
#: pool in the net's own leaf dtype (the name of the default, not a
#: cast); "int8" is this module; "auto" lets the measured
#: paged_decode_quant store entry decide (``tuning/plan.py``)
KV_DTYPES = ("bf16", "int8", "auto")

# float32: 23 mantissa bits, exponent bias 127; 2**-126 is the least
# normal number and 2**-149 the least subnormal one
_MANT_BITS, _BIAS = 23, 127
_MIN_NORMAL_EXP, _MIN_SUBNORMAL_EXP = -126, -149


def pow2ceil(x) -> torch.Tensor:
    """Smallest power of two >= x, elementwise, in f32 (x >= 0; 0 and
    NaN give 0). ``frexp`` writes x = m * 2**e with m in [0.5, 1): an
    exact power of two has m == 0.5 and is its own result, anything else
    rounds up to 2**e. The result is assembled from its exponent bits,
    not by ``exp2``/``pow`` (which carry ulp error bounds on CUDA), so
    it is a true power of two for every input, subnormals included
    (there the single mantissa bit ``1 << (k + 149)``)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    m, e = torch.frexp(x)
    k = torch.where(m == 0.5, e - 1, e).to(torch.int32)
    normal = (k + _BIAS).clamp_min(0) << _MANT_BITS
    sub = torch.ones_like(k) << (k - _MIN_SUBNORMAL_EXP).clamp(
        0, _MANT_BITS - 1)
    bits = torch.where(k >= _MIN_NORMAL_EXP, normal, sub)
    out = bits.view(torch.float32)
    return torch.where(x > 0, out, torch.zeros_like(out))


def quantize(x, sigma) -> torch.Tensor:
    """Symmetric int8 quantization under (broadcastable) scales
    ``sigma``: ``clip(round(x / sigma), -127, 127)``, rounding half to
    even. A zero sigma (an all-zero page base) quantizes to 0."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    positive = sigma > 0
    safe = torch.where(positive, sigma, torch.ones_like(sigma))
    q = torch.round(x.float() / safe)
    q = torch.where(positive, q, torch.zeros_like(q))
    return q.clamp(-127, 127).to(torch.int8)


def dequantize(q, sigma, dtype=torch.float32) -> torch.Tensor:
    """``q * sigma`` in f32, then ``dtype``: exact for a power-of-two
    sigma, in bf16 too."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    return (q.float() * sigma).to(dtype)


def quantize_chunk(xt, scales, page, q_pos, pos, writable, *, page_size):
    """Quantize one appended chunk of a kv leaf and the scale-sidecar
    entries of the pages it starts: the per-leaf worker of the paged
    append.

    - ``xt``: ``[N, T, Hkv, D]``, the chunk's k or v, rope applied, in
      the pool's write layout;
    - ``scales``: ``[P, Hkv]`` f32 sidecar before the chunk;
    - ``page``: ``[N, T]`` target page per token (the null page 0 for
      positions that must not write);
    - ``q_pos``: ``[N, T]`` absolute position per token;
    - ``pos``: ``[N]`` each row's position before the chunk;
    - ``writable``: ``[N, T]`` bool, the tokens that really append.

    The JAX package's ``chunk0`` (the index of a left-padded chunk's
    first real token) has no counterpart: the port's chunks carry no
    padding (``rnn_time_step`` drops it before the forward).

    Returns ``(xq [N, T, Hkv, D] int8, scales)``: the sidecar is
    updated in place (as the pools are; the JAX package returns a new
    array).

    A token's scale is its page base's sigma. The base is either in this
    chunk (a prefill: looked up by chunk index, the base of position b
    sits at index ``b - pos``) or committed before it (a decode
    append mid page: read from the sidecar). Base tokens overwrite their
    page's entry; every other row (and every non-writable one) writes
    the null page 0, whose entry nothing valid reads. Which of several
    colliding writes lands there is not defined (on CUDA it varies from
    run to run): harmless for that reason."""
    t = xt.shape[1]
    ps = int(page_size)
    amax = xt.float().abs().amax(dim=-1)                      # [N, T, Hkv]
    s_tok = pow2ceil(amax / 127.0)
    base_pos = torch.div(q_pos, ps, rounding_mode="floor") * ps
    in_chunk = base_pos >= pos[:, None]                       # [N, T]
    idx = (base_pos - pos[:, None]).clamp(0, t - 1).long()
    s_base = torch.take_along_dim(s_tok, idx[:, :, None].expand_as(s_tok),
                                  dim=1)
    sigma = torch.where(in_chunk[:, :, None], s_base, scales[page.long()])
    xq = quantize(xt, sigma[..., None])
    is_base = (torch.remainder(q_pos, ps) == 0) & writable
    upd = torch.where(is_base, page, torch.zeros_like(page)).long()
    scales[upd] = s_tok
    return xq, scales


def kv_page_bytes(leaf_dims: Sequence[Tuple[int, int]], page_size: int,
                  kv_dtype: str, native_dtype: str) -> int:
    """Bytes one pool page costs across every kv leaf (k and v per
    attention layer; ``leaf_dims`` holds one (Hkv, D) per layer), the
    int8 scale-sidecar rows included: the unit of
    ``PagedKVConfig(total_bytes=...)``."""
    if kv_dtype == "int8":
        item, scale = 1, 4
    else:
        item = 2 if native_dtype in ("bfloat16", "bf16", "float16") else 4
        scale = 0
    total = 0
    for hkv, d in leaf_dims:
        total += 2 * (hkv * int(page_size) * d * item + hkv * scale)
    return total


def pool_leaves(total_pages: int, page_size: int,
                leaf_dims: Sequence[Tuple[int, int]], device=None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Zeroed int8 pools and f32 scale sidecars, two leaves (k, v) per
    (Hkv, D) layer entry, in layer order: the engine's eager store (the
    int8 pools exist before the first prime, which writes through
    them)."""
    pools, scales = [], []
    for hkv, d in leaf_dims:
        for _ in ("kv_k", "kv_v"):
            pools.append(torch.zeros((total_pages, hkv, int(page_size), d),
                                     dtype=torch.int8, device=device))
            scales.append(torch.zeros((total_pages, hkv),
                                      dtype=torch.float32, device=device))
    return pools, scales
