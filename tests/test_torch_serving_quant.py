"""The port's int8 KV page pool (deeplearning4j_tpu_torch/serving/quant.py,
``PagedKVConfig(kv_dtype="int8")``, the int8 paged-decode plain version)
against the JAX package on the CPU, with the same seeded numpy inputs.

- The quantization primitives are bitwise equal to
  ``deeplearning4j_tpu/serving/quant.py``: ``pow2ceil`` (zero, exact
  powers, one ulp either side of a power, the f32 range's ends),
  ``quantize`` (half-way points round to even, a zero scale),
  ``dequantize`` (f32 and bf16), ``quantize_chunk`` (a prefill chunk
  with its page bases in the chunk, then a mid-page decode append that
  reads the sidecar), ``kv_page_bytes`` and ``pool_leaves``. Subnormal
  inputs are held against the definition instead: XLA on the CPU treats
  subnormal inputs as 0 (its pow2ceil returns 0 for them), the port
  returns the true power of two.
- ``paged_attention_quant_plain`` against the JAX Pallas kernel in
  interpret mode with scale sidecars, at W=1 and at a GQA W=3 case: f32
  within atol = rtol = 2e-5 (the JAX package's own tolerance against the
  dequantized reference), bf16 queries within one bf16 ulp (both round
  one f32 result to bf16: rtol 2^-7, atol 1e-3 for outputs near 0).
  The wrapper refuses lone scales and a pool that is not int8.
- The engine, f32 rope transformer (2 layers, width 32, GQA 4/2 heads)
  with weights carried across from the JAX net: greedy streams
  identical to the JAX int8 engine's (``decode_impl="xla"``); the int8
  pools and scale sidecars, every page but the null page 0, equal (0
  elements apart; allowed: 0); within the port, a prefix hit equals a
  miss; ``total_bytes`` buys >= 1.9x the bf16 pages;
  ``kv_dtype="auto"`` is bf16 uncalibrated, int8 after a calibrated win
  on this device, bf16 for another device kind's entry.

Null page 0 is left out of every pool comparison: colliding writes land
there in an order neither package defines, and nothing valid reads it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import (
    GenerationEngine as JaxEngine, PagedKVConfig as JaxPaged)
from deeplearning4j_tpu.serving import quant as jq
from deeplearning4j_tpu.serving.paged_kernel import (
    paged_attention as jax_paged_attention)
from deeplearning4j_tpu.zoo import TextGenerationTransformer as JaxTFM
from deeplearning4j_tpu_torch.serving import GenerationEngine, PagedKVConfig
from deeplearning4j_tpu_torch.serving import quant as tq
from deeplearning4j_tpu_torch.serving.paged_kernel import (
    PAGED_ATTENTION, PAGED_ATTENTION_QUANT, paged_attention,
    paged_attention_quant_plain, paged_attention_quant_smem_bytes)
from deeplearning4j_tpu_torch.tuning import (
    KernelCrossoverStore, quant_fingerprint, reset_default_store)
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, KV_HEADS, LAYERS, MAXLEN, PS = 16, 32, 4, 2, 2, 40, 4
SYS = [1, 2, 3, 4, 5, 6, 7, 8]             # two full shared blocks
PROMPTS = [SYS + [9, 10, 11], [3, 4, 5], SYS + [12], [7, 6],
           SYS + [2, 2, 2, 2, 5], [9]]
STEPS = 6
#: pool elements the port's int8 engine writes one quantum away from the
#: JAX int8 engine's on PROMPTS (f32, same weights): 0 observed
POOL_FLIPS = 0


def _bits(t):
    return np.asarray(t).view(np.uint8)


# ---------------------------------------------------------------------
# the primitives, bit for bit
# ---------------------------------------------------------------------
def _pow2_inputs():
    rng = np.random.default_rng(0)
    powers = np.float32(2.0) ** np.arange(-126, 128, dtype=np.float32)
    up = np.nextafter(powers, np.float32(np.inf))
    down = np.nextafter(powers, np.float32(0))
    rand = (rng.standard_normal(2000) * 10.0 ** rng.uniform(-30, 30, 2000))
    return np.concatenate([
        [0.0, np.finfo(np.float32).max, np.inf, np.nan, -1.0, -0.0],
        powers, up, down[1:], np.abs(rand)]).astype(np.float32)


def test_pow2ceil_is_the_jax_packages_bit_for_bit():
    x = _pow2_inputs()
    got = tq.pow2ceil(torch.from_numpy(x)).numpy()
    want = np.asarray(jq.pow2ceil(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pos = (x > 0) & np.isfinite(x) & np.isfinite(got)
    m, _ = np.frexp(got[pos])
    assert (m == 0.5).all()                     # true powers of two
    assert (got[pos] >= x[pos]).all() and (got[pos] / 2 < x[pos]).all()


def test_pow2ceil_of_subnormals_is_a_true_power_of_two():
    x = np.array([1e-45, 3e-45, 7e-42, 1.1754942e-38], np.float32)
    got = tq.pow2ceil(torch.from_numpy(x)).numpy().astype(np.float64)
    want = np.ldexp(1.0, np.ceil(np.log2(x.astype(np.float64))).astype(int))
    np.testing.assert_array_equal(got, want)
    # XLA on the CPU reads these inputs as 0
    assert not np.asarray(jq.pow2ceil(jnp.asarray(x))).any()


def test_quantize_and_dequantize_are_the_jax_packages():
    rng = np.random.default_rng(1)
    sigma = np.float32(2.0) ** rng.integers(-12, 4, (64, 1)).astype(
        np.float32)
    sigma[:3] = 0.0                              # all-zero page bases
    x = (rng.standard_normal((64, 40)) * 200 * sigma).astype(np.float32)
    # exact half-way points round to even, and values far past +-127
    x[5, :8] = (np.arange(-4, 4) + 0.5) * sigma[5]
    x[6, :2] = [1e4 * sigma[6, 0], -1e4 * sigma[6, 0]]
    got = tq.quantize(torch.from_numpy(x), torch.from_numpy(sigma))
    want = jq.quantize(jnp.asarray(x), jnp.asarray(sigma))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[5, :8].tolist() == [-4, -2, -2, 0, 0, 2, 2, 4]
    assert not got[:3].any()
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        a = tq.dequantize(got, torch.from_numpy(sigma), tdt)
        b = jq.dequantize(want, jnp.asarray(sigma), jdt)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


def _chunk_case(rng, n, t, pos, P=9, hkv=2, d=8):
    """A chunk of n rows at positions ``pos``..``pos + t`` through a
    page table of distinct pages (position >= 28 is past capacity)."""
    xt = rng.standard_normal((n, t, hkv, d)).astype(np.float32) * \
        rng.uniform(0.01, 50, (n, t, hkv, 1)).astype(np.float32)
    table = np.arange(1, 1 + n * 4, dtype=np.int32).reshape(n, 4) % P
    q_pos = (pos[:, None] + np.arange(t)).astype(np.int32)
    blk = np.clip(q_pos // PS, 0, 3)
    writable = q_pos < 28
    page = np.where(writable, np.take_along_axis(table, blk, 1), 0)
    return xt, page.astype(np.int32), q_pos, writable


def test_quantize_chunk_is_the_jax_packages():
    """A prefill chunk whose page bases are in the chunk, then a decode
    append mid page that takes its scale from the sidecar the prefill
    wrote, and a row past capacity; the quantized chunk and the sidecar
    (but the null page's entry) bit for bit."""
    rng = np.random.default_rng(2)
    scales_t = torch.zeros((9, 2))
    scales_j = jnp.zeros((9, 2), jnp.float32)
    for n, t, pos in ((2, 7, np.array([0, 5])), (2, 1, np.array([7, 27]))):
        pos = pos.astype(np.int32)
        xt, page, q_pos, writable = _chunk_case(rng, n, t, pos)
        xq_t, scales_t = tq.quantize_chunk(
            torch.from_numpy(xt), scales_t, torch.from_numpy(page),
            torch.from_numpy(q_pos), torch.from_numpy(pos),
            torch.from_numpy(writable), page_size=PS)
        xq_j, scales_j = jq.quantize_chunk(
            jnp.asarray(xt), scales_j, jnp.asarray(page), jnp.asarray(q_pos),
            jnp.asarray(pos), jnp.asarray(writable), page_size=PS, chunk0=0)
        np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
        np.testing.assert_array_equal(_bits(scales_t.numpy()[1:]),
                                      _bits(np.asarray(scales_j)[1:]))
    assert (scales_t.numpy()[1:] > 0).sum() >= 4     # bases were priced


@pytest.mark.parametrize("dims,native", [
    ([(2, 8)], "float32"), ([(2, 8), (4, 16)], "bfloat16"),
    ([(8, 64)] * 6, "bfloat16")])
@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_page_bytes_and_pool_leaves_are_the_jax_packages(dims, native,
                                                         kv_dtype):
    assert tq.kv_page_bytes(dims, 16, kv_dtype, native) == \
        jq.kv_page_bytes(dims, 16, kv_dtype, native)
    tp, ts = tq.pool_leaves(5, 4, dims)
    jp, js = jq.pool_leaves(5, 4, dims)
    assert [tuple(t.shape) for t in tp] == [j.shape for j in jp]
    assert [tuple(t.shape) for t in ts] == [j.shape for j in js]
    assert {t.dtype for t in tp} == {torch.int8}
    assert {t.dtype for t in ts} == {torch.float32}
    assert not any(t.any() for t in tp + ts)
    assert tq.KV_DTYPES == jq.KV_DTYPES


# ---------------------------------------------------------------------
# the int8 read: the plain version against the Pallas kernel
# ---------------------------------------------------------------------
def _quant_case(reps, qw, seed, S=4, hkv=2, d=8, nb=5):
    rng = np.random.default_rng(seed)
    P = S * nb + 1
    q = rng.normal(size=(S, hkv, reps * qw, d)).astype(np.float32)
    kp = rng.normal(size=(P, hkv, PS, d)).astype(np.float32)
    vp = rng.normal(size=(P, hkv, PS, d)).astype(np.float32) * 3
    table = rng.permutation(np.arange(1, P))[:S * nb].reshape(S, nb)
    lengths = np.array([qw, nb * PS, *rng.integers(qw, nb * PS, S - 2)],
                       np.int32)
    ks = jq.pow2ceil(jnp.max(jnp.abs(jnp.asarray(kp)), axis=(2, 3)) / 127.0)
    vs = jq.pow2ceil(jnp.max(jnp.abs(jnp.asarray(vp)), axis=(2, 3)) / 127.0)
    kq = jq.quantize(jnp.asarray(kp), ks[:, :, None, None])
    vq = jq.quantize(jnp.asarray(vp), vs[:, :, None, None])
    return [np.array(a) for a in (q, kq, vq, table.astype(np.int32),
                                  lengths, ks, vs)]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reps,qw", [(1, 1), (2, 3)], ids=["w1", "gqa_w3"])
def test_quant_plain_matches_the_jax_kernel(reps, qw, dtype):
    q, kq, vq, table, lengths, ks, vs = _quant_case(reps, qw, seed=reps)
    tqry = torch.from_numpy(q).to(getattr(torch, dtype))
    args = _torch(kq, vq, table, lengths)
    before = PAGED_ATTENTION_QUANT.launches, PAGED_ATTENTION.launches
    got = paged_attention(tqry, *args, query_width=qw,
                          k_scales=torch.from_numpy(ks),
                          v_scales=torch.from_numpy(vs))
    assert (PAGED_ATTENTION_QUANT.launches, PAGED_ATTENTION.launches) == \
        before                                  # the CPU runs no kernel
    torch.testing.assert_close(
        got, paged_attention_quant_plain(
            tqry, *args, query_width=qw, k_scales=torch.from_numpy(ks),
            v_scales=torch.from_numpy(vs)), rtol=0, atol=0)
    assert got.dtype == tqry.dtype
    want = jax_paged_attention(
        jnp.asarray(tqry.float().numpy(), getattr(jnp, dtype)),
        *(jnp.asarray(a) for a in (kq, vq, table, lengths)), query_width=qw,
        interpret=True, k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "float32" else \
        dict(atol=1e-3, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_quant_wrapper_refusals():
    q, kq, vq, table, lengths, ks, vs = _torch(*_quant_case(1, 1, seed=5))
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, kq, vq, table, lengths, query_width=1,
                        k_scales=ks)
    with pytest.raises(ValueError, match="int8"):
        paged_attention(q, kq.float(), vq.float(), table, lengths,
                        query_width=1, k_scales=ks, v_scales=vs)
    meta = [t.to("meta") for t in (q, kq, vq, table, lengths, ks, vs)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        paged_attention(*meta[:5], query_width=1, k_scales=meta[5],
                        v_scales=meta[6])


def test_quant_smem_bytes_of_the_engine_shape():
    # the split decode's layout, no page staged: the 16 warps' partials,
    # each m, l and the row's accumulator (64), all f32
    assert paged_attention_quant_smem_bytes(1, 64, 16) == 4 * 16 * (64 + 2)
    # the verify shape (20 rows, 5 tiles of 4): 3 warps a tile, and the
    # query's 20 rows in f32
    assert paged_attention_quant_smem_bytes(20, 64, 16) == \
        4 * (3 * 20 * (64 + 2) + 20 * 64)


# ---------------------------------------------------------------------
# the engine against the JAX int8 engine
# ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope", n_kv_heads=KV_HEADS)
    jnet = JaxTFM(**kw).init()
    rng = np.random.default_rng(7)
    np_params = {v: {k: np.asarray(a, np.float32) if k.startswith("W")
                     else rng.normal(float(k == "gamma"), 0.2, a.shape)
                     .astype(np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    jnet.params = {v: {k: jnp.asarray(a) for k, a in p.items()}
                   for v, p in np_params.items()}
    model = TextGenerationTransformer(**kw)
    tnet = model.init(device="cpu").load_numpy_params(np_params)
    return jnet, tnet, model


def _trace(engine, prompts=PROMPTS, steps=STEPS):
    """Staggered greedy admissions, one engine step between submits."""
    hs = []
    for i, p in enumerate(prompts):
        hs.append(engine.submit(p, steps=steps, top_k=1,
                                rng=np.random.default_rng(i)))
        engine.step()
    engine.run_until_idle()
    return [h.result(timeout=0) for h in hs]


def _int8(**kw):
    return PagedKVConfig(page_size=PS, kv_dtype="int8", **kw)


@pytest.fixture(scope="module")
def jax_int8(nets):
    jnet = nets[0]
    eng = JaxEngine(jnet, V, slots=3, paging=JaxPaged(
        page_size=PS, kv_dtype="int8", decode_impl="xla"))
    return eng, _trace(eng)


def test_int8_engine_streams_and_pools_match_the_jax_engine(nets, jax_int8):
    _, tnet, _ = nets
    jeng, want = jax_int8
    eng = GenerationEngine(tnet, V, slots=3, device="cpu", paging=_int8())
    assert _trace(eng) == want
    assert eng._kv_dtype == "int8" and eng.prefix_cache.hits >= 2
    assert eng.page_pool.used_count() == len(eng.prefix_cache)
    flips = 0
    for got, ref in zip(eng._page_store, jeng._page_store):
        assert got.dtype == torch.int8
        diff = np.abs(got.numpy()[1:].astype(int)
                      - np.asarray(ref)[1:].astype(int))
        assert diff.max() <= 1
        flips += int((diff > 0).sum())
    assert flips == POOL_FLIPS
    for got, ref in zip(eng._scale_store, jeng._scale_store):
        np.testing.assert_array_equal(_bits(got.numpy()[1:]),
                                      _bits(np.asarray(ref)[1:]))
    assert len(eng._page_store) == len(eng._scale_store) == 2 * LAYERS


def test_int8_prefix_hit_equals_miss(nets):
    _, tnet, _ = nets
    shared = [3, 1, 2, 0] * 2
    prompts = [shared + [5], shared + [7, 8], [9, 9], shared + [5, 6]]
    runs = {}
    for cache in (False, True):
        eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                               paging=_int8(prefix_cache=cache))
        hs = [eng.submit(p, steps=5, top_k=1, rng=np.random.default_rng(i))
              for i, p in enumerate(prompts)]
        eng.run_until_idle()
        runs[cache] = [h.result(timeout=0) for h in hs]
        if cache:
            assert eng.prefix_cache.hits >= 2
    assert runs[True] == runs[False]


@pytest.mark.parametrize("native", ["float32", "bfloat16"])
def test_total_bytes_buys_more_pages_under_int8(nets, native):
    """pages = budget // kv_page_bytes (the scale rows priced in); the
    int8 pool buys >= 1.9x the pages of the unquantized one (about 2x
    against bf16 leaves, 4x against f32). A scale costs 4 bytes a page
    and head against the page's ps * D int8 values: at this net's D=8 a
    page of 32 tokens keeps that share as small as the served shape's
    (D=64, page 16) does, 1/256 against 1/256."""
    _, tnet, _ = nets
    saved, tnet.conf.dtype = tnet.conf.dtype, native
    try:
        budget, ps = 100_000, 32
        dims = [(KV_HEADS, E // HEADS)] * LAYERS
        usable = {}
        for kv in ("int8", "bf16"):
            eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                                   paging=PagedKVConfig(
                                       page_size=ps, kv_dtype=kv,
                                       total_bytes=budget))
            usable[kv] = eng.page_pool.usable
            assert usable[kv] == budget // tq.kv_page_bytes(dims, ps, kv,
                                                            native)
        assert usable["int8"] >= 1.9 * usable["bf16"]
    finally:
        tnet.conf.dtype = saved
    with pytest.raises(ValueError, match="at most one"):
        PagedKVConfig(total_bytes=1000, total_tokens=64)
    with pytest.raises(ValueError, match="buys no page"):
        GenerationEngine(tnet, V, slots=2, device="cpu",
                         paging=PagedKVConfig(page_size=PS, total_bytes=10))
    eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                           paging=PagedKVConfig(page_size=PS,
                                                total_tokens=4 * PS + 3))
    assert eng.page_pool.usable == 4


KEY = quant_fingerprint(PS, E // HEADS, KV_HEADS, MAXLEN, "float32")


@pytest.mark.parametrize("entry,want", [
    (None, "bf16"),
    (dict(platform="cpu", device_kind="cpu"), "int8"),
    (dict(platform="cuda", device_kind="NVIDIA H100 80GB HBM3"), "bf16"),
    (dict(platform="cpu", device_kind="another cpu"), "bf16")],
    ids=["uncalibrated", "calibrated_win", "another_platform",
         "another_kind"])
def test_auto_resolves_through_the_measured_store(nets, entry, want):
    _, tnet, _ = nets
    entries = {} if entry is None else {KEY: {
        "kernel_ms": 1.0, "fallback_ms": 2.5, "impl_rev": 1, "samples": 1,
        **entry}}
    reset_default_store(KernelCrossoverStore(path="/nonexistent/none",
                                             entries=entries))
    try:
        eng = GenerationEngine(tnet, V, slots=2, device="cpu",
                               paging=PagedKVConfig(page_size=PS,
                                                    kv_dtype="auto"))
        assert eng._quant_key == KEY and eng._kv_dtype == want
        h = eng.submit([1, 2, 3, 4, 5], steps=3, top_k=1)
        eng.run_until_idle()
        assert len(h.result(timeout=0)) == 8
        assert (eng._scale_store is not None) == (want == "int8")
        assert {p.dtype for p in eng._page_store} == {
            torch.int8 if want == "int8" else torch.float32}
    finally:
        reset_default_store(None)
