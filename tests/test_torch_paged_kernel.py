"""The port's paged-attention decode (deeplearning4j_tpu_torch/serving/
paged_kernel.py) against the JAX package's on the same seeded inputs.

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel runs only on the card, where chip_smoke.py holds it against the
same plain version). Here the plain version is held against both JAX
versions: the dense-gather reference ``paged_ref_attention`` and the
Pallas kernel ``paged_attention`` in interpret mode. Tolerance: f32,
atol = rtol = 1e-5 (XLA and torch sum in different orders).

The CUDA kernel splits each row's live pages over the warps of its
block and combines their partials in a fixed order; a torch mirror of
that split (``decode_split_plan``'s cut, p rounded at each chunk's own
running max) is held against the JAX kernel in interpret mode within
the card's TOLERANCE, with a 0-length row, a warp's share wholly masked
for some verify rows, and a bad page; the plan covers every live page
once. The int8 kernel is the same split over int8 pools: the mirror,
taught the per-(page, head) scales read by page id and p kept in f32,
is held against the JAX kernel with scale sidecars within the card's
QUANT_TOLERANCE at the engine cut and at verify shapes of one block and
of three blocks a (slot, head), on the 16-byte and the element route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.paged_kernel import (
    paged_attention as jax_paged_attention, paged_ref_attention)
from deeplearning4j_tpu_torch.serving.paged_kernel import (
    NEG_INF, PAGED_ATTENTION, decode_split_plan, paged_attention,
    paged_attention_plain, paged_attention_smem_bytes)
from deeplearning4j_tpu_torch.serving.quant import pow2ceil, quantize
from torch_threads import one_thread  # noqa: F401 (autouse)

PS, D, HKV, NB = 4, 8, 2, 5


def _case(reps, qw, dtype=np.float32, seed=0):
    """Ragged lengths: one 0-length row, one row filling its whole
    table, the rest random; table entries past a row's live pages are
    dead (page 0, the null page), live pages distinct."""
    rng = np.random.default_rng(seed)
    S = 5
    P = S * NB + 1
    q = rng.normal(size=(S, HKV, reps * qw, D)).astype(dtype)
    kp = rng.normal(size=(P, HKV, PS, D)).astype(dtype)
    vp = rng.normal(size=(P, HKV, PS, D)).astype(dtype)
    lengths = np.array([0, NB * PS, *rng.integers(1, NB * PS, S - 2)],
                       np.int32)
    pages = rng.permutation(np.arange(1, P))
    table = np.zeros((S, NB), np.int32)
    for s, ln in enumerate(lengths):
        live = -(-int(ln) // PS)
        table[s, :live] = pages[s * NB:s * NB + live]
    return q, kp, vp, table, lengths


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _seen(lengths, rw, qw):
    """[S, rw] rows whose query sees at least one key (position >= 0):
    the dense reference softmaxes a fully masked row to the mean of V,
    both kernels give 0."""
    qpos = lengths[:, None] - qw + np.arange(rw)[None, :] % qw
    return qpos >= 0


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("qw", [1, 3])
def test_plain_matches_jax_kernel_and_reference(reps, qw):
    q, kp, vp, table, lengths = _case(reps, qw)
    got = paged_attention_plain(*_torch(q, kp, vp, table, lengths),
                                query_width=qw).numpy()
    jargs = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    kern = np.asarray(jax_paged_attention(*jargs, query_width=qw,
                                          interpret=True))
    np.testing.assert_allclose(got, kern, atol=1e-5, rtol=1e-5)
    ref = np.asarray(paged_ref_attention(*jargs, query_width=qw))
    seen = _seen(lengths, reps * qw, qw)[:, None, :, None]
    seen = np.broadcast_to(seen, got.shape)
    np.testing.assert_allclose(got[seen], ref[seen], atol=1e-5, rtol=1e-5)
    # the 0-length row attends nothing and stays finite (zeros)
    assert np.all(got[0] == 0.0)


def test_dead_pages_invisible():
    """Pages no row reads live (dead table entries, the null page,
    unmapped pool pages) can hold any finite junk: overwriting them
    changes no output bit. (The plain version gathers them and zeroes
    their weight, so a NaN there would still poison it through 0 * NaN;
    the kernel never reads them at all.)"""
    q, kp, vp, table, lengths = _case(2, 3, seed=1)
    live = {int(table[s, b]) for s, ln in enumerate(lengths)
            for b in range(-(-int(ln) // PS))}
    kpp, vpp = kp.copy(), vp.copy()
    junk = np.random.default_rng(9)
    for p in range(kp.shape[0]):
        if p not in live:
            kpp[p] = 1e6 * junk.normal(size=kp.shape[1:])
            vpp[p] = 1e6 * junk.normal(size=vp.shape[1:])
    a = paged_attention_plain(*_torch(q, kp, vp, table, lengths),
                              query_width=3)
    b = paged_attention_plain(*_torch(q, kpp, vpp, table, lengths),
                              query_width=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_rounding_point_matches_jax_kernel():
    """bf16 pools and queries: p is rounded to the value dtype before
    the PV product in both versions (outputs agree to bf16 rounding)."""
    q, kp, vp, table, lengths = _case(2, 1, seed=2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (q, kp, vp))
    got = paged_attention_plain(tq, tk, tv, *_torch(table, lengths),
                                query_width=1)
    assert got.dtype == torch.bfloat16
    kern = jax_paged_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
        jnp.asarray(table), jnp.asarray(lengths), query_width=1,
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    q, kp, vp, table, lengths = _torch(*_case(1, 1, seed=3))
    before = PAGED_ATTENTION.launches
    out = paged_attention(q, kp, vp, table, lengths, query_width=1)
    torch.testing.assert_close(
        out, paged_attention_plain(q, kp, vp, table, lengths,
                                   query_width=1), rtol=0, atol=0)
    assert PAGED_ATTENTION.launches == before


def test_wrapper_rejects_bad_shapes_and_devices():
    q, kp, vp, table, lengths = _torch(*_case(1, 3, seed=4))
    with pytest.raises(ValueError, match="query_width"):
        paged_attention(q, kp, vp, table, lengths, query_width=2)
    meta = [t.to("meta") for t in (q, kp, vp, table, lengths)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_attention(*meta, query_width=3)


def test_smem_bytes_of_the_engine_shape():
    # rows 1, head dim 64: the 16 warps' partials, each m, l and the
    # row's accumulator (64), all f32; the page size stages nothing
    assert paged_attention_smem_bytes(1, 64, 16) == 4 * 16 * (64 + 2)
    # the verify shape (20 rows, 5 tiles of 4): 3 warps a tile, and the
    # query's 20 rows
    assert paged_attention_smem_bytes(20, 64, 16) == \
        4 * (3 * 20 * (64 + 2) + 20 * 64)


# ---------------------------------------------------------------------
# the split decode: a mirror of the CUDA kernel's page split and its
# fixed-order combine against the JAX kernel
# ---------------------------------------------------------------------
#: the card's limits (chip_smoke.py's TOLERANCE): max |error| against the
#: reference, bf16 and f32 outputs
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: the int8 kernel's (chip_smoke.py's QUANT_TOLERANCE)
QUANT_TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def _combine(parts):
    """Partials (m, l, acc) combined in order, each weighed by exp(m -
    max m), one that saw no key (l = 0) by exactly 0."""
    mx = max(m for m, _, _ in parts)
    a = torch.zeros_like(parts[0][2])
    lsum = torch.tensor(0.0)
    for m, l, acc in parts:
        wt = torch.exp(m - mx) if float(l) > 0 else 0.0
        a, lsum = a + acc * wt, lsum + l * wt
    return mx, lsum, a


def _split_mirror(q, kp, vp, table, lengths, qw, vec=True, sms=1,
                  k_scales=None, v_scales=None):
    """``csrc/paged_attention.cu``'s split decode in torch on the CPU, as
    ``decode_split_plan`` cuts it on a card of ``sms`` SMs: for each
    (slot, head) and each of its blocks, each warp walks its share of a
    row tile's live pages chunk by chunk (scores in f32, masked at the
    finite -1e30 and zeroed, p rounded to the value dtype at each
    chunk's running max, l summing the unrounded p); each block combines
    its warps' partials in order, then the blocks' in order; a page id
    outside the pool poisons the (slot, head). With ``k_scales`` and
    ``v_scales`` the int8 kernel: the pools int8, each chunk's scores
    times ``scale * k_scales[page, h]``, p kept in f32 and times
    ``v_scales[page, h]`` before the PV product. Returns (the output,
    the number of partials that walked pages but saw no key of their
    row)."""
    S, hkv, rw, d = q.shape
    P, ps, nb = kp.shape[0], kp.shape[2], table.shape[1]
    quant = k_scales is not None
    plan = decode_split_plan(rw, d, kp.element_size(), vec, pairs=S * hkv,
                             sms=sms, n_max=nb)
    f32 = torch.float32
    scale = torch.tensor(1.0 / np.sqrt(d), dtype=f32)
    out = torch.empty(q.shape, dtype=f32)
    masked = 0
    for s in range(S):
        length = int(lengths[s])
        n_live = min(-(-length // ps) if length > 0 else 0, nb)
        for h in range(hkv):
            parts, bad = {}, False
            for split, w in np.ndindex(plan.splits, plan.warps):
                share = w % plan.warps_per_tile
                for tile, pages in plan.warp_pages(w, n_live, split):
                    lo = tile * plan.rows_per_tile
                    for r in range(lo, min(rw, lo + plan.rows_per_tile)):
                        m = torch.tensor(NEG_INF, dtype=f32)
                        l = torch.tensor(0.0, dtype=f32)
                        acc = torch.zeros(d, dtype=f32)
                        last = length - qw + r % qw
                        for b in pages:
                            page = int(table[s, b])
                            if not 0 <= page < P:
                                bad = True
                                continue
                            kscale = scale * k_scales[page, h] if quant \
                                else scale
                            for k0 in range(0, ps, plan.chunk_keys):
                                js = torch.arange(
                                    k0, min(k0 + plan.chunk_keys, ps))
                                valid = b * ps + js <= last
                                sc = kp[page, h, js].float() @ \
                                    q[s, h, r].float() * kscale
                                sc = torch.where(valid, sc, NEG_INF)
                                m_new = torch.maximum(m, sc.max())
                                corr = torch.exp(m - m_new)
                                p = torch.where(valid, torch.exp(sc - m_new),
                                                0.0)
                                l = l * corr + p.sum()
                                pv = p * v_scales[page, h] if quant \
                                    else p.to(vp.dtype).float()
                                acc = acc * corr + \
                                    pv @ vp[page, h, js].float()
                                m = m_new
                        masked += bool(pages) and float(l) == 0.0
                        parts[split, share, r] = (m, l, acc)
            for r in range(rw):
                blocks = [_combine([parts[b, w, r] for w in
                                    range(plan.warps_per_tile)])
                          for b in range(plan.splits)]
                _, lsum, a = _combine(blocks)
                out[s, h, r] = float("nan") if bad else \
                    a / torch.clamp_min(lsum, 1e-30)
    return out.to(q.dtype), masked


def _jax_kernel(q, kp, vp, table, lengths, qw, k_scales=None,
                v_scales=None):
    as_j = [jnp.asarray(t.numpy() if t.dtype == torch.int8 else
                        t.float().numpy(),
                        jnp.bfloat16 if t.dtype == torch.bfloat16 else None)
            for t in (q, kp, vp)]
    scales = {} if k_scales is None else dict(
        k_scales=jnp.asarray(k_scales.numpy()),
        v_scales=jnp.asarray(v_scales.numpy()))
    return np.asarray(jax_paged_attention(
        *as_j, jnp.asarray(table.numpy()), jnp.asarray(lengths.numpy()),
        query_width=qw, interpret=True, **scales).astype(jnp.float32))


def _verify_case(dtype, seed):
    """A verify shape (reps 2, W 3: 6 rows, two tiles of 4, 8 warps a
    tile, so every live page its own warp's share): a 0-length row; a
    row of 9 = 2 pages + 1 key, whose third page holds position 8 alone,
    so the warp that owns it saw no key of the rows at positions 6 and 7
    (a group wholly masked for them); the rest ragged."""
    q, kp, vp, table, lengths = _case(2, 3, seed=seed)
    lengths[2] = 2 * PS + 1
    table[2] = 0
    table[2, :3] = np.arange(1, 4) + 20
    t = _torch(q, kp, vp, table, lengths)
    t[:3] = [x.to(dtype) for x in t[:3]]
    return t


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_mirror_matches_the_jax_kernel_with_a_masked_group(dtype,
                                                                 sms):
    """One block a (slot, head), and as many as a 132-SM card gives these
    10 pairs (two blocks of 8 warps a tile: each page its own warp)."""
    q, kp, vp, table, lengths = _verify_case(dtype, seed=5)
    got, masked = _split_mirror(q, kp, vp, table, lengths, 3, sms=sms)
    assert masked > 0
    want = _jax_kernel(q, kp, vp, table, lengths, 3)
    assert np.abs(got.float().numpy() - want).max() <= TOLERANCE[dtype]
    assert torch.all(got[0] == 0)    # the 0-length row: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_mirror_matches_the_jax_kernel_at_the_engine_cut(dtype):
    """One query row, D = 64, pages of 16 (the engine's decode, cut to 5
    slots, 2 heads and 4 pages a row): 16 warps, each a page; bf16 one
    chunk a page (p rounded at the page's max, as the JAX kernel), f32
    four chunks of 4 keys a page (p exact in f32)."""
    rng = np.random.default_rng(11)
    S, hkv, d, ps, nb = 5, 2, 64, 16, 4
    P = S * nb + 1
    q = rng.normal(size=(S, hkv, 1, d)).astype(np.float32)
    kp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    lengths = np.array([0, 1, 17, nb * ps, 40], np.int32)
    table = np.zeros((S, nb), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for s, ln in enumerate(lengths):
        live = -(-int(ln) // ps)
        table[s, :live] = pages[s * nb:s * nb + live]
    t = _torch(q, kp, vp, table, lengths)
    t[:3] = [x.to(dtype) for x in t[:3]]
    plan = decode_split_plan(1, d, t[0].element_size())
    assert plan.chunk_keys == (16 if dtype == torch.bfloat16 else 4)
    got, _ = _split_mirror(*t, 1)
    want = _jax_kernel(*t, 1)
    assert np.abs(got.float().numpy() - want).max() <= TOLERANCE[dtype]
    assert torch.all(got[0] == 0)


def test_split_mirror_poisons_a_bad_page_and_nothing_else():
    """A page id outside the pool in one row's share poisons every head
    of that slot with NaN; the other slots keep the JAX kernel's
    output."""
    q, kp, vp, table, lengths = _verify_case(torch.float32, seed=6)
    want = _jax_kernel(q, kp, vp, table, lengths, 3)
    bad = table.clone()
    bad[2, 2] = kp.shape[0]
    got, _ = _split_mirror(q, kp, vp, bad, lengths, 3, sms=132)
    assert torch.isnan(got[2]).all()
    keep = [s for s in range(q.shape[0]) if s != 2]
    assert np.abs(got[keep].numpy() - want[keep]).max() <= \
        TOLERANCE[torch.float32]


@pytest.mark.parametrize("elem_bytes", [1, 2])
@pytest.mark.parametrize("pairs", [64, 16, 1000])
@pytest.mark.parametrize("rows", [1, 5, 20, 64])
@pytest.mark.parametrize("n_live", [0, 1, 17, 27, 64])
def test_the_split_plan_covers_every_live_page_once(rows, n_live, pairs,
                                                    elem_bytes):
    """Each row tile's live pages, over the blocks and warps that hold
    it, once each; every row in exactly one tile. On a 132-SM card the
    engine's 64 pairs take one block each (one query row); the verify
    shape's 16 pairs take 8 (20 rows), a thousand pairs one; never more
    than give each warp of a tile one of the 64 pages. The int8 pool
    (``elem_bytes`` 1) is cut the same way; a one-row chunk is one
    16-key page at D = 64 (bf16 and int8 alike)."""
    plan = decode_split_plan(rows, 64, elem_bytes, pairs=pairs, sms=132,
                             n_max=64)
    if rows == 1:
        assert plan.chunk_keys == 16
    assert plan.splits == (1 if rows == 1 or pairs > 132 else min(
        8, 132 // pairs, -(-64 // plan.warps_per_tile)))
    seen = np.zeros((plan.tiles, n_live), np.int64)
    for split, w in np.ndindex(plan.splits, plan.warps):
        for tile, pages in plan.warp_pages(w, n_live, split):
            seen[tile, pages] += 1
    assert (seen == 1).all()
    assert plan.tiles * plan.rows_per_tile >= rows > \
        (plan.tiles - 1) * plan.rows_per_tile
    assert plan.warps_per_tile * plan.groups <= plan.warps


# ---------------------------------------------------------------------
# the int8 kernel: the same split over int8 pools with per-page scales
# ---------------------------------------------------------------------
def _quantized(t):
    """(t, k_int8, v_int8, k scales, v scales): an f32 case's pools
    quantized per (page, head) as the int8 pool stores them, V at a
    scale unlike K's."""
    q, kp, vp, table, lengths = t
    vp = vp * 3.0
    ks = pow2ceil(kp.abs().amax(dim=(2, 3)) / 127.0)
    vs = pow2ceil(vp.abs().amax(dim=(2, 3)) / 127.0)
    return (q, quantize(kp, ks[:, :, None, None]),
            quantize(vp, vs[:, :, None, None]), table, lengths, ks, vs)


def _quant_verify_case(dtype, d, seed):
    """A verify shape over int8 pools (5 slots, 2 kv heads, reps 2, W 3:
    two row tiles of 4, 8 warps a tile; pages of 4, 20 a row): a 0-length
    row; a row of 9 = 2 pages + 1 key, whose third page holds position 8
    alone (the warp, or block, that owns it sees no key of the rows at
    positions 6 and 7); a row filling its table; the rest ragged. D = 16
    takes the vector route (two 8-byte vectors a key at a tile of 4
    rows), D = 12 the element route."""
    rng = np.random.default_rng(seed)
    S, hkv, rw, ps, nb = 5, 2, 6, 4, 20
    P = S * nb + 1
    q = rng.normal(size=(S, hkv, rw, d)).astype(np.float32)
    kp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    lengths = np.array([0, nb * ps, 9, *rng.integers(3, nb * ps, S - 3)],
                       np.int32)
    pages = rng.permutation(np.arange(1, P))
    table = np.zeros((S, nb), np.int32)
    for s, ln in enumerate(lengths):
        live = -(-int(ln) // ps)
        table[s, :live] = pages[s * nb:s * nb + live]
    q, kq, vq, table, lengths, ks, vs = _quantized(
        _torch(q, kp, vp, table, lengths))
    return q.to(dtype), kq, vq, table, lengths, ks, vs


@pytest.mark.parametrize("d", [16, 12])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_split_mirror_matches_the_jax_kernel_with_a_masked_group(
        dtype, sms, d):
    """One block a (slot, head) (sms 1), and three on a 132-SM card
    (10 pairs, 20 pages over 8 warps a tile): within QUANT_TOLERANCE of
    the JAX kernel with scale sidecars; a masked share weighs 0; the
    0-length row exact zeros."""
    q, kq, vq, table, lengths, ks, vs = _quant_verify_case(dtype, d, seed=7)
    plan = decode_split_plan(6, d, 1, d % 8 == 0, pairs=10, sms=sms,
                             n_max=20)
    assert plan.splits == (3 if sms == 132 else 1)
    assert plan.chunk_keys == (32 if d % 8 == 0 else 2)
    got, masked = _split_mirror(q, kq, vq, table, lengths, 3,
                                vec=d % 8 == 0, sms=sms, k_scales=ks,
                                v_scales=vs)
    assert masked > 0
    want = _jax_kernel(q, kq, vq, table, lengths, 3, ks, vs)
    assert np.abs(got.float().numpy() - want).max() <= \
        QUANT_TOLERANCE[dtype]
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_split_mirror_matches_the_jax_kernel_at_the_engine_cut(dtype):
    """One query row, D = 64, pages of 16 (the engine's decode, cut to 5
    slots, 2 heads and 4 pages a row): 16 warps, each a page, a page one
    chunk of 16 keys; lengths 0, 1, 17, a full table and 40."""
    rng = np.random.default_rng(12)
    S, hkv, d, ps, nb = 5, 2, 64, 16, 4
    P = S * nb + 1
    q = rng.normal(size=(S, hkv, 1, d)).astype(np.float32)
    kp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    vp = rng.normal(size=(P, hkv, ps, d)).astype(np.float32)
    lengths = np.array([0, 1, 17, nb * ps, 40], np.int32)
    table = np.zeros((S, nb), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for s, ln in enumerate(lengths):
        live = -(-int(ln) // ps)
        table[s, :live] = pages[s * nb:s * nb + live]
    q, kq, vq, table, lengths, ks, vs = _quantized(
        _torch(q, kp, vp, table, lengths))
    q = q.to(dtype)
    assert decode_split_plan(1, d, 1).chunk_keys == ps
    got, _ = _split_mirror(q, kq, vq, table, lengths, 1, k_scales=ks,
                           v_scales=vs)
    want = _jax_kernel(q, kq, vq, table, lengths, 1, ks, vs)
    assert np.abs(got.float().numpy() - want).max() <= \
        QUANT_TOLERANCE[dtype]
    assert torch.all(got[0] == 0)


def test_int8_split_mirror_poisons_a_bad_page_and_nothing_else():
    """A page id outside the pool in one row's share poisons every head
    of that slot with NaN (three blocks a pair); the other slots keep the
    JAX kernel's output."""
    q, kq, vq, table, lengths, ks, vs = _quant_verify_case(torch.float32,
                                                           16, seed=8)
    want = _jax_kernel(q, kq, vq, table, lengths, 3, ks, vs)
    bad = table.clone()
    bad[1, 5] = kq.shape[0]
    got, _ = _split_mirror(q, kq, vq, bad, lengths, 3, sms=132, k_scales=ks,
                           v_scales=vs)
    assert torch.isnan(got[1]).all()
    keep = [s for s in range(q.shape[0]) if s != 1]
    assert np.abs(got[keep].numpy() - want[keep]).max() <= \
        QUANT_TOLERANCE[torch.float32]
