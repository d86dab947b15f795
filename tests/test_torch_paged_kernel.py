"""The port's paged-attention decode (deeplearning4j_tpu_torch/serving/
paged_kernel.py) against the JAX package's on the same seeded inputs.

On the CPU the port's wrapper runs its plain PyTorch version (the CUDA
kernel runs only on the card, where chip_smoke.py holds it against the
same plain version). Here the plain version is held against both JAX
versions: the dense-gather reference ``paged_ref_attention`` and the
Pallas kernel ``paged_attention`` in interpret mode. Tolerance: f32,
atol = rtol = 1e-5 (XLA and torch sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving.paged_kernel import (
    paged_attention as jax_paged_attention, paged_ref_attention)
from deeplearning4j_tpu_torch.serving.paged_kernel import (
    PAGED_ATTENTION, paged_attention, paged_attention_plain,
    paged_attention_smem_bytes)

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
    # rows 1, head dim 64, page 16: q + acc (2*64) + K/V pages (2*16*64)
    # + scores (16) + three row scalars, all f32
    assert paged_attention_smem_bytes(1, 64, 16) == \
        4 * (2 * 64 + 2 * 16 * 64 + 16 + 3)
