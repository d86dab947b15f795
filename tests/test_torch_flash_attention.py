"""The port's flash attention (``nn/layers/flash_attention.py``) against
the JAX package's Pallas kernels run in interpret mode (the path a TPU
takes) and ``jax.vjp`` through them, and against
``reference_attention``.

On the CPU the wrappers run their plain versions: the forward ``(o,
lse)`` and the recompute backward (dq, dk/dv) behind the autograd
function. Tolerances: f32, atol/rtol 2e-5 for o and lse and 5e-5 for
the gradients (both sides sum in f32, in other orders and over other
blocks); bf16 inputs, atol 2e-2 on o and 3e-2 on the gradients (the
online softmax rounds p to bf16 against each key block's running max,
the plain version against the row's max: one bf16 ulp of p, 2^-8,
times |V| <= 2.5). The bf16 rounding points themselves are pinned where
the two sides round the same values (one key block forward; the
backward fed the same lse and delta), with ``agreement``'s per-row and
per-tile relative measures, the measures ``chip_smoke.py`` holds the
CUDA kernels to against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.pallas_attention import (
    flash_attention as jax_flash, flash_attention_lse as jax_flash_lse)
from deeplearning4j_tpu.parallel.sequence import reference_attention
from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
from torch_threads import one_thread  # noqa: F401 (autouse)

F32 = dict(atol=2e-5, rtol=2e-5)
F32_GRAD = dict(atol=5e-5, rtol=5e-5)


def _arrays(shape_q, shape_k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal(shape_q) * 0.5).astype(np.float32)
    k = (rng.standard_normal(shape_k) * 0.5).astype(np.float32)
    v = (rng.standard_normal(shape_k) * 0.5).astype(np.float32)
    do = rng.standard_normal(shape_q).astype(np.float32)
    return q, k, v, do


def _key_mask(b, tk, lengths):
    if lengths is None:
        return None
    return (np.arange(tk)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _jax_run(q, k, v, do, causal, km, dtype):
    """JAX's (o, lse) and its VJP at cotangent ``do``, interpret mode."""
    cast = (lambda a: jnp.asarray(a, dtype))
    kmj = None if km is None else jnp.asarray(km)
    o, lse = jax_flash_lse(cast(q), cast(k), cast(v), causal=causal,
                           key_mask=kmj, block_q=128, block_k=128,
                           interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(
        a, b, c, causal=causal, key_mask=kmj, block_q=128, block_k=128,
        interpret=True), cast(q), cast(k), cast(v))
    grads = vjp(cast(do))
    f32 = (lambda a: np.asarray(a.astype(jnp.float32)))
    return f32(o), np.asarray(lse), [f32(g) for g in grads]


def _port_run(q, k, v, do, causal, km, dtype):
    """The port's plain forward (o, lse), and its autograd gradients."""
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    kmt = None if km is None else torch.tensor(km)
    o, lse = fa.flash_attention_fwd(*[t.detach() for t in ts], kmt, causal)
    out = fa.flash_attention(*ts, causal=causal, key_mask=kmt)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    out.backward(torch.tensor(do).to(dtype))
    return (o.float().numpy(), lse.numpy(),
            [t.grad.float().numpy() for t in ts])


CASES = {
    # name: (B, H, Tq, Tk, D, causal, key-mask lengths)
    "causal": (2, 2, 256, 256, 64, True, None),
    "noncausal": (2, 2, 256, 256, 64, False, None),
    "cross_tq_ne_tk": (2, 2, 130, 300, 32, False, None),
    "ragged_causal": (1, 2, 200, 200, 64, True, None),
    "key_mask_empty_row": (2, 2, 128, 160, 32, False, [100, 0]),
    "causal_key_mask_empty_row": (2, 1, 256, 256, 64, True, [200, 0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_the_jax_kernels(name):
    b, h, tq, tk, d, causal, lengths = CASES[name]
    q, k, v, do = _arrays((b, h, tq, d), (b, h, tk, d), seed=len(name))
    km = _key_mask(b, tk, lengths)
    jo, jlse, jgrads = _jax_run(q, k, v, do, causal, km, jnp.float32)
    po, plse, pgrads = _port_run(q, k, v, do, causal, km, torch.float32)
    np.testing.assert_allclose(po, jo, **F32)
    np.testing.assert_allclose(plse, jlse, **F32)
    for got, want, n in zip(pgrads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, err_msg=f"d{n}", **F32_GRAD)
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        # a fully masked row: o = 0, zero and finite gradients
        assert not po[row].any()
        for g in pgrads:
            assert np.isfinite(g).all()
        assert not pgrads[0][row].any()


def test_bf16_inputs_match_the_jax_kernel():
    b, h, t, d = 2, 2, 256, 64
    q, k, v, do = _arrays((b, h, t, d), (b, h, t, d), seed=3)
    jo, jlse, jgrads = _jax_run(q, k, v, do, True, None, jnp.bfloat16)
    po, plse, pgrads = _port_run(q, k, v, do, True, None, torch.bfloat16)
    np.testing.assert_allclose(po, jo, atol=2e-2, rtol=0)
    np.testing.assert_allclose(plse, jlse, atol=1e-5, rtol=1e-5)
    for got, want, n in zip(pgrads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=0,
                                   err_msg=f"d{n}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_reference_attention(causal):
    q, k, v, _ = _arrays((2, 3, 96, 16), (2, 3, 96, 16), seed=5)
    want = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=causal))
    got, _ = fa.flash_attention_fwd_plain(torch.tensor(q), torch.tensor(k),
                                          torch.tensor(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("causal,lengths", [(True, None), (False, [3, 0])])
def test_gradcheck_f64(causal, lengths):
    """The recompute backward is the forward's gradient (finite
    differences in f64, tiny shape; a fully masked row included)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 2, 5, 3), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    km = None if lengths is None else torch.tensor(
        _key_mask(2, 5, lengths), dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal,
                                           key_mask=km), (q, k, v))


def test_cpu_tensors_take_the_plain_versions():
    q, k, v, do = (torch.tensor(a) for a in _arrays((1, 1, 20, 8),
                                                      (1, 1, 20, 8), 9))
    before = [kern.launches for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ,
                                         fa.FLASH_BWD_DKV)]
    o, lse = fa.flash_attention_fwd(q, k, v, None, True)
    delta = (do * o).sum(-1)
    torch.testing.assert_close(
        fa.flash_attention_bwd_dq(q, k, v, None, do, lse, delta, True),
        fa.flash_attention_bwd_dq_plain(q, k, v, None, do, lse, delta,
                                        True), rtol=0, atol=0)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, None, do, lse, delta, True)
    dk2, dv2 = fa.flash_attention_bwd_dkv_plain(q, k, v, None, do, lse,
                                                delta, True)
    torch.testing.assert_close((dk, dv), (dk2, dv2), rtol=0, atol=0)
    assert [kern.launches for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ,
                                       fa.FLASH_BWD_DKV)] == before


def test_shapes_are_checked_and_left_out_options_raise():
    q = torch.zeros((1, 2, 8, 4))
    with pytest.raises(ValueError, match="Tq == Tk"):
        fa.flash_attention(q, torch.zeros((1, 2, 9, 4)),
                           torch.zeros((1, 2, 9, 4)), causal=True)
    with pytest.raises(ValueError, match="key_mask"):
        fa.flash_attention(q, q, q, key_mask=torch.ones((1, 9)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        fa.flash_attention(q, q, q, causal=True, window=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        fa.flash_attention(q, q, q, causal=True, q_offset=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A9"):
        fa.flash_attention_lse(q, q, q)


# bf16 rounding points: p to V's dtype before P.V; ds to K's before ds.K;
# p to dO's before p^T.dO; ds to Q's before ds^T.Q. Where the port and the
# JAX kernels round the same values, their bf16 outputs differ by one ulp
# in a few elements (agreement's tile_rel ~1e-6); leaving the rounding out
# changes a third of them (~1e-3). ROUND_TOL sits between the two.
ROUND_TOL = 1e-4
ROW_TOL = 2 ** -6       # two bf16 ulps of a row's largest element

ROUND_CASES = {
    # name: (B, H, Tq, Tk, D, causal, key-mask lengths)
    "causal": (2, 2, 128, 128, 64, True, None),
    "cross_ragged_tq": (2, 2, 200, 128, 32, False, None),
    "key_mask_empty_row": (2, 2, 128, 128, 32, False, [100, 0]),
    "causal_two_key_blocks": (1, 2, 256, 256, 64, True, None),
    "cross_padded_tk": (2, 2, 130, 300, 32, False, None),
}


def _bf16_case(name, seed):
    b, h, tq, tk, d, causal, lengths = ROUND_CASES[name]
    arrays = _arrays((b, h, tq, d), (b, h, tk, d), seed=seed)
    q, k, v, do = (torch.tensor(a).to(torch.bfloat16) for a in arrays)
    km = _key_mask(b, tk, lengths)
    return q, k, v, do, (None if km is None else torch.tensor(km)), causal


def _f32(*ts):
    return [t.float() for t in ts]


@pytest.mark.parametrize("name", [n for n, c in ROUND_CASES.items()
                                  if c[3] <= 128])
def test_bf16_forward_rounds_p_where_the_jax_kernel_does(name):
    """Within one 128-key block the JAX kernel's running max is the
    row's max, so it rounds the same p as the plain forward: o agrees to
    ROUND_TOL, and the forward without its rounding point does not."""
    q, k, v, _, km, causal = _bf16_case(name, seed=11)
    jo, _ = jax_flash_lse(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                            for t in (q, k, v)), causal=causal,
                          key_mask=None if km is None else jnp.asarray(km),
                          block_q=128, block_k=128, interpret=True)
    jo = torch.tensor(np.asarray(jo.astype(jnp.float32)))
    o, _ = fa.flash_attention_fwd(q, k, v, km, causal)
    row_rel, tile_rel = fa.agreement(o, jo)
    assert row_rel <= ROW_TOL and tile_rel <= ROUND_TOL, (row_rel, tile_rel)
    unrounded, _ = fa.flash_attention_fwd(*_f32(q, k, v), km, causal)
    assert fa.agreement(unrounded.to(torch.bfloat16), jo)[1] > ROUND_TOL


@pytest.mark.parametrize("name", sorted(ROUND_CASES))
def test_bf16_backward_rounds_where_the_jax_kernels_do(name):
    """The JAX dq and dk/dv kernels, fed the port's lse and delta, and
    the port's plain backward round the same p and ds: dq, dk and dv
    agree to ROUND_TOL, and the backward without its rounding points
    does not."""
    from deeplearning4j_tpu.nn.layers.pallas_attention import (
        _prep, _run_bwd_kernels)
    q, k, v, do, km, causal = _bf16_case(name, seed=12)
    tq, tk = q.shape[2], k.shape[2]
    o, lse = fa.flash_attention_fwd(q, k, v, km, causal)
    delta = (do.float() * o.float()).sum(-1)
    want = [fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta, causal),
            *fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta, causal)]

    def j(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    jq, jk, jv, jkm, bq, bk, first_pad, user_mask, _ = _prep(
        j(q), j(k), j(v), None if km is None else jnp.asarray(km), causal,
        128, 128)
    jdo = jnp.pad(j(do), ((0, 0), (0, 0), (0, jq.shape[2] - tq), (0, 0)))

    def rows(t):    # [B, H, Tq] f32 -> the kernels' padded [B, H, Tq', 1]
        return jnp.pad(jnp.asarray(t.numpy()),
                       ((0, 0), (0, 0), (0, jq.shape[2] - tq)))[..., None]

    jgrads = _run_bwd_kernels(jq, jk, jv, jkm, jdo, rows(lse), rows(delta),
                              causal=causal, bq=bq, bk=bk,
                              first_pad=first_pad, user_mask=user_mask,
                              interpret=True)
    unrounded = [fa.flash_attention_bwd_dq(*_f32(q, k, v), km, do.float(),
                                           lse, delta, causal),
                 *fa.flash_attention_bwd_dkv(*_f32(q, k, v), km, do.float(),
                                             lse, delta, causal)]
    for n, got, jg, u, t in zip("qkv", want, jgrads, unrounded,
                                (tq, tk, tk)):
        jg = torch.tensor(np.asarray(jg.astype(jnp.float32)))[:, :, :t]
        row_rel, tile_rel = fa.agreement(got, jg)
        assert row_rel <= ROW_TOL and tile_rel <= ROUND_TOL, \
            (f"d{n}", row_rel, tile_rel)
        assert fa.agreement(u.to(torch.bfloat16), jg)[1] > ROUND_TOL, f"d{n}"


def test_agreement_scales_with_each_row():
    """A fault confined to rows whose outputs are small still counts: a
    1% error in the last row of a tensor whose first row is 1000 times
    larger."""
    ref = torch.ones((1, 1, 128, 8))
    ref[:, :, 0] = 1000.0
    x = ref.clone()
    x[:, :, -1] *= 1.01
    row_rel, tile_rel = fa.agreement(x, ref)
    assert row_rel == pytest.approx(0.01, rel=1e-5)
    # the last tile: rows 64-127, one of them 1% off
    assert tile_rel == pytest.approx(0.01 / 64, rel=1e-5)
    assert fa.agreement(ref, ref) == (0.0, 0.0)
    assert fa.agreement(torch.zeros_like(ref), ref) == (1.0, 1.0)
    nan = ref.clone()
    nan[0, 0, 5, 0] = float("nan")
    assert fa.agreement(nan, ref)[0] == float("inf")
    zero_ref = torch.zeros_like(ref)
    assert fa.agreement(zero_ref, zero_ref) == (0.0, 0.0)
    assert fa.agreement(ref, zero_ref) == (float("inf"), float("inf"))
    # a row under 1e-3 of the largest (here 1000) is measured against
    # that floor, 1: a masked row, or a cancellation's rounding noise
    tiny = ref.clone()
    tiny[:, :, 3] = 0.0
    noisy = tiny.clone()
    noisy[:, :, 3, 0] = 1e-9
    assert fa.agreement(noisy, tiny)[0] == pytest.approx(1e-9)
    noisy[:, :, 3, 0] = 0.5
    assert fa.agreement(noisy, tiny)[0] == pytest.approx(0.5)


# The kernels' two routes, chosen by dtype and head dim in one place for
# the forward and both backward kernels: bf16 at a multiple of 16 up to
# 128 on the tensor cores, the rest (f32 exact, other bf16 head dims up
# to 256) on the CUDA cores.
ROUTES = [
    (torch.bfloat16, 32, fa.TENSOR_CORES),
    (torch.bfloat16, 64, fa.TENSOR_CORES),
    (torch.bfloat16, 128, fa.TENSOR_CORES),
    (torch.bfloat16, 16, fa.TENSOR_CORES),
    (torch.float32, 64, fa.CUDA_CORES),
    (torch.float32, 128, fa.CUDA_CORES),
    (torch.bfloat16, 40, fa.CUDA_CORES),
    (torch.bfloat16, 144, fa.CUDA_CORES),
    (torch.bfloat16, 256, fa.CUDA_CORES),
]


@pytest.mark.parametrize("dtype,d,route", ROUTES)
def test_backward_route_by_dtype_and_head_dim(dtype, d, route):
    assert fa.kernel_route(dtype, d) == route
    # all three kernels have an entry point for the pair, under one
    # counter each
    for kern, stem in ((fa.FLASH_FWD, "flash_fwd"),
                       (fa.FLASH_BWD_DQ, "flash_bwd_dq"),
                       (fa.FLASH_BWD_DKV, "flash_bwd_dkv")):
        sym = kern.symbols[dtype, route]
        assert sym.startswith(f"dl4j_{stem}_")
        assert sym in kern.library.functions


def test_the_tensor_core_entry_points_are_in_the_source():
    src = fa._LIBRARY.sources[0].read_text()
    for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV):
        assert f"int {kern.symbols[torch.bfloat16, fa.TENSOR_CORES]}(" in src
    assert "dl4j_flash_fwd_bf16_mma" in fa._LIBRARY.functions
    assert "flash_fwd_mma_kernel" in src
    assert any(h.name == "conv_mma.cuh" for h in fa._LIBRARY.headers)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 257),
                                     (torch.float32, 0),
                                     (torch.float16, 64)])
def test_backward_route_refuses_what_no_route_takes(dtype, d):
    with pytest.raises(ValueError):
        fa.kernel_route(dtype, d)


def _meta(d, tq=8, tk=8, dtype=torch.bfloat16):
    """Tensors with shapes and no storage: the wrappers' checks run on
    them as on CUDA tensors (the device is checked last)."""
    def t(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")
    return (t(1, 2, tq, d), t(1, 2, tk, d), t(1, 2, tk, d), None,
            t(1, 2, tq, d), t(1, 2, tq, dt=torch.float32),
            t(1, 2, tq, dt=torch.float32))


@pytest.mark.parametrize("wrapper", [fa.flash_attention_bwd_dq,
                                     fa.flash_attention_bwd_dkv])
def test_backward_wrappers_raise_on_what_no_route_takes(wrapper):
    with pytest.raises(ValueError, match="exceeds 256"):
        wrapper(*_meta(264), causal=True)
    q, k, v, km, do, lse, delta = _meta(64)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(q, k.transpose(2, 3).contiguous().transpose(2, 3), v, km,
                do, lse, delta, True)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        wrapper(q, k, v, km, do, lse, delta, True)


@pytest.mark.parametrize("dtype,d,route", ROUTES[:1] + ROUTES[4:7])
def test_backward_wrappers_launch_the_route_they_chose(monkeypatch, dtype,
                                                       d, route):
    """Past the device check, each wrapper (the forward and both
    backward kernels) hands its kernel the (dtype, route) key that
    kernel_route gives, and nothing else."""
    seen = []
    monkeypatch.setattr(fa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV):
        monkeypatch.setattr(kern, "launch",
                            lambda key, *args: seen.append(key))
    args = _meta(d, dtype=dtype)
    fa.flash_attention_fwd(*args[:4], causal=True)
    fa.flash_attention_bwd_dq(*args, causal=True)
    fa.flash_attention_bwd_dkv(*args, causal=True)
    assert seen == [(dtype, route)] * 3


@pytest.mark.parametrize("unaligned", ["q", "k", "v"])
def test_the_tensor_core_route_refuses_unaligned_tensors(monkeypatch,
                                                         unaligned):
    """On the tensor-core route (bf16, D=64) every wrapper refuses a
    tensor off a 16-byte boundary (its copies are 16 bytes wide) before
    it launches anything."""
    monkeypatch.setattr(fa, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    for kern in (fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV):
        monkeypatch.setattr(kern, "launch", lambda *a: pytest.fail(
            "launched an unaligned tensor"))
    q, k, v, km, do, lse, delta = _meta(64)
    t = dict(q=q, k=k, v=v)
    # one element in: a contiguous view 2 bytes past the boundary
    t[unaligned] = torch.empty(t[unaligned].numel() + 1,
                               dtype=torch.bfloat16,
                               device="meta")[1:].view(t[unaligned].shape)
    assert t[unaligned].data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_fwd(t["q"], t["k"], t["v"], km, causal=True)
    for wrapper in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            wrapper(t["q"], t["k"], t["v"], km, do, lse, delta, True)
