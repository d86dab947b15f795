"""The port's LSTM recurrence (deeplearning4j_tpu_torch/nn/layers/
lstm_kernel.py, recurrent.py) against the JAX package, on the CPU, where
the wrappers take the kernels' plain versions.

- The plain forward against the JAX Pallas kernel in interpret mode
  (``pallas_lstm_recurrence(..., interpret=True)``) and against its scan
  (``_scan_recurrence``) at (T, N, H) = (5, 8, 128) in f32, atol and rtol
  2e-5 (the JAX test's own, tests/test_pallas_lstm.py). In bf16 against
  the interpret kernel: the port rounds h and c to bf16 at every step's
  end, as the JAX layer's scan carries them; the kernel keeps an f32
  carry and rounds only its outputs. So they part by bf16 rounding:
  within 2^-6 of each row's largest |value| (two ulps; 6.3e-3 read), and
  each 64-row tile within 2e-3 of its summed |value| (1.2e-3 read); by
  at most 3.9e-3 absolute, as far as the JAX scan in bf16 parts from the
  same kernel (3.9e-3 read). The f32 read: 8.9e-8.
- ``lstm_scan`` with peepholes, a mask with fully masked steps and rows,
  and ``reverse``, carry given or zero, against the JAX ``lstm_scan`` in
  f32 within 1e-5 (2.1e-7 read); ``bidirectional_sum`` likewise.
- The autograd Function's gradients (zx, RW, P, h0, c0, the gradients
  of out, hT and cT all seeded) against ``jax.grad`` of the JAX
  ``lstm_scan`` (with W the identity, so its x is zx) in f32 within
  1e-5 (3.0e-7 read); the same with the backward's own loop on the plain
  forward's saves.
- A planted fault (the output gate's peephole reading the previous cell,
  not the new one) reads outside those tolerances.
- A gate or cell activation the kernels do not compute takes the
  step-by-step scan route (counted in ``LSTM_SCAN.runs``, no kernel
  launch) and agrees with the JAX scan; the wrappers launch nothing for
  CPU tensors; a mask is refused by the backward.
- The cluster backward (``csrc/lstm.cu`` ``cl::``): its three-term bf16
  split reproduces f32 values bit for bit over a wide exponent range,
  and its product with a bf16 RW is the f32 product within 1e-6 of the
  product's scale; a torch mirror of the cluster exchange (each block's
  dh from every peer's piece in turn, the split terms one k16 step at a
  time) on the plain forward's saves is held against
  ``lstm_backward_plain`` (1e-5) and ``jax.grad`` of the JAX scan
  (GRAD_TOL) at one, two and three unit tiles; the plan
  (``_lstm_bwd_cluster_plan``) covers every (row, unit) pair once within
  227 KB of shared memory; the route (``lstm_bwd_route``) takes clusters
  up to H = 256 and the cooperative kernel beyond.
- The cluster forward (``cl::lstm_fwd_cluster_kernel``): a torch mirror
  (each block's h_{t-1} assembled from the peers' pieces by buffer
  parity, each peer's K-slice multiplied in turn and the partials added
  in peer order) against ``lstm_forward_plain`` and the JAX scan with
  peepholes and a mask (1e-5) and the Pallas kernel in interpret mode
  (TOL), one, two and three unit tiles; a peer's piece read a step
  stale falls outside; its plan (``_lstm_fwd_cluster_plan``) covers
  every (row, unit) pair once within 227 KB (two blocks an SM in bf16),
  the row tiles a block are those of fewest waves
  (``_cluster_row_tiles``), and ``lstm_fwd_route`` takes clusters up to
  H = 256, the decode shape included, and the cooperative kernel
  beyond.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers.pallas_kernels import (
    _scan_recurrence, pallas_lstm_recurrence)
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
from deeplearning4j_tpu_torch.nn.layers import recurrent as trec
from deeplearning4j_tpu_torch.nn.layers.flash_attention import agreement
from torch_threads import one_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _f32(a):
    return np.asarray(a, np.float32)


def _recurrence_inputs(t, n, h, seed, peep=False):
    rng = np.random.default_rng(seed)
    d = {"zx": _f32(rng.standard_normal((t, n, 4 * h)) * 0.3),
         "rw": _f32(rng.standard_normal((h, 4 * h)) * 0.1),
         "h0": _f32(rng.standard_normal((n, h)) * 0.1),
         "c0": _f32(rng.standard_normal((n, h)) * 0.1)}
    if peep:
        d["p"] = _f32(rng.standard_normal((3, h)) * 0.5)
    return d


def _torch(d, dtype=torch.float32):
    return {k: torch.tensor(v).to(dtype) for k, v in d.items()}


def _rows(a):
    a = torch.as_tensor(np.asarray(a, np.float32))
    return a.reshape(1, 1, -1, a.shape[-1])


# ---------------------------------------------------------------------
# the recurrence against the Pallas kernel and the scan
# ---------------------------------------------------------------------
def test_plain_forward_matches_the_pallas_kernel_and_the_scan_f32():
    d = _recurrence_inputs(5, 8, 128, seed=0)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    kern = pallas_lstm_recurrence(j["zx"], j["rw"], j["h0"], j["c0"],
                                  interpret=True)
    scan = _scan_recurrence(j["zx"], j["rw"], j["h0"], j["c0"])
    a = _torch(d)
    out, h_t, c_t, _ = lk.lstm_forward(a["zx"], a["rw"], a["h0"], a["c0"])
    for want in (kern, scan):
        for got, w in zip((out, h_t, c_t), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_plain_forward_bf16_against_the_pallas_kernel():
    d = _recurrence_inputs(5, 8, 128, seed=1)
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in d.items()}
    kern = pallas_lstm_recurrence(j["zx"], j["rw"], j["h0"], j["c0"],
                                  interpret=True)
    a = _torch(d, torch.bfloat16)
    got = lk.lstm_forward(a["zx"], a["rw"], a["h0"], a["c0"])[:3]
    for g, w in zip(got, kern):
        row_rel, tile_rel = agreement(_rows(g.float()),
                                      _rows(np.asarray(w, np.float32)))
        assert row_rel <= 2 ** -6 and tile_rel <= 2e-3, (row_rel, tile_rel)


def _scan_inputs(n, c, t, h, seed):
    rng = np.random.default_rng(seed)
    mask = (rng.random((n, t)) > 0.3).astype(np.float32)
    mask[:, 2] = 0.0                 # a fully masked step
    mask[1] = 0.0                    # a fully masked row
    return {"x": _f32(rng.standard_normal((n, c, t))),
            "w": _f32(rng.standard_normal((c, 4 * h)) * 0.4),
            "rw": _f32(rng.standard_normal((h, 4 * h)) * 0.3),
            "b": _f32(rng.standard_normal(4 * h) * 0.1),
            "p": _f32(rng.standard_normal((3, h)) * 0.5),
            "h0": _f32(rng.standard_normal((n, h)) * 0.5),
            "c0": _f32(rng.standard_normal((n, h)) * 0.5), "mask": mask}


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_lstm_scan_peephole_mask_reverse_matches_jax(reverse, masked,
                                                     carry):
    d = _scan_inputs(4, 5, 7, 6, seed=2)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    a = _torch(d)
    kw_j = dict(peephole=j["p"], reverse=reverse,
                mask=j["mask"] if masked else None,
                h0=j["h0"] if carry else None, c0=j["c0"] if carry else None)
    kw_t = dict(peephole=a["p"], reverse=reverse,
                mask=a["mask"] if masked else None,
                h0=a["h0"] if carry else None, c0=a["c0"] if carry else None)
    want = jrec.lstm_scan(j["x"], j["w"], j["rw"], j["b"], **kw_j)
    got = trec.lstm_scan(a["x"], a["w"], a["rw"], a["b"], **kw_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    if masked:
        # a masked step outputs zeros; the masked row carries h0, c0
        assert not got[0][:, :, 2].any()
        if carry:
            assert torch.equal(got[1][1], a["h0"][1])
            assert torch.equal(got[2][1], a["c0"][1])


def test_bidirectional_sum_matches_jax():
    d = _scan_inputs(3, 5, 6, 4, seed=3)
    rng = np.random.default_rng(4)
    wb = _f32(rng.standard_normal(d["w"].shape) * 0.4)
    rwb = _f32(rng.standard_normal(d["rw"].shape) * 0.3)
    bb = _f32(rng.standard_normal(d["b"].shape) * 0.1)
    pb = _f32(rng.standard_normal(d["p"].shape) * 0.5)
    args = (d["x"], d["w"], d["rw"], d["b"], wb, rwb, bb)
    want = jrec.bidirectional_sum(*map(jnp.asarray, args),
                                  peep_f=jnp.asarray(d["p"]),
                                  peep_b=jnp.asarray(pb),
                                  mask=jnp.asarray(d["mask"]))
    got = trec.bidirectional_sum(*map(torch.tensor, args),
                                 peep_f=torch.tensor(d["p"]),
                                 peep_b=torch.tensor(pb),
                                 mask=torch.tensor(d["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------
def _grad_case(seed=5, t=6, n=4, h=5):
    rng = np.random.default_rng(seed)
    d = _recurrence_inputs(t, n, h, seed, peep=True)
    d["zx"] = _f32(rng.standard_normal((t, n, 4 * h)))
    d["rw"] = _f32(rng.standard_normal((h, 4 * h)) * 0.4)
    d["h0"] = _f32(rng.standard_normal((n, h)) * 0.5)
    d["c0"] = _f32(rng.standard_normal((n, h)) * 0.5)
    cot = {"out": _f32(rng.standard_normal((t, n, h))),
           "h": _f32(rng.standard_normal((n, h))),
           "c": _f32(rng.standard_normal((n, h)))}
    return d, cot


def _jax_grads(d, cot):
    """jax.grad of the JAX lstm_scan with W the identity and b zero (so
    its zx is x transposed) for the loss <out, dout> + <hT, dhT> + <cT,
    dcT>: (dzx, drw, dh0, dc0, dp)."""
    h = d["rw"].shape[0]
    eye = jnp.eye(4 * h, dtype=jnp.float32)

    def loss(zx, rw, h0, c0, p):
        x = jnp.transpose(zx, (1, 2, 0))              # [N, 4H, T]
        out, h_t, c_t = jrec.lstm_scan(x, eye, rw,
                                       jnp.zeros(4 * h, jnp.float32),
                                       h0=h0, c0=c0, peephole=p)
        return (jnp.sum(jnp.transpose(out, (2, 0, 1)) * cot["out"])
                + jnp.sum(h_t * cot["h"]) + jnp.sum(c_t * cot["c"]))

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(d[k]) for k in ("zx", "rw", "h0", "c0", "p")))


def test_autograd_function_gradients_match_jax_grad():
    d, cot = _grad_case()
    want = _jax_grads(d, cot)
    leaves = [torch.tensor(d[k], requires_grad=True)
              for k in ("zx", "rw", "h0", "c0", "p")]
    out, h_t, c_t = lk.lstm_recurrence(*leaves)
    loss = ((out * torch.tensor(cot["out"])).sum()
            + (h_t * torch.tensor(cot["h"])).sum()
            + (c_t * torch.tensor(cot["c"])).sum())
    got = torch.autograd.grad(loss, leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_backward_loop_on_the_forward_saves_matches_jax_grad():
    d, cot = _grad_case(seed=6)
    want = _jax_grads(d, cot)
    a = _torch(d)
    _, _, _, (gates, c) = lk.lstm_forward(a["zx"], a["rw"], a["h0"],
                                          a["c0"], a["p"], save=True)
    dzx, dh0, dc0 = lk.lstm_backward(gates, c, a["c0"], a["rw"], a["p"],
                                     torch.tensor(cot["out"]),
                                     torch.tensor(cot["h"]),
                                     torch.tensor(cot["c"]))
    for g, w in ((dzx, want[0]), (dh0, want[2]), (dc0, want[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_planted_peephole_fault_reads_outside_the_tolerance():
    """The output gate's peephole on c_prev instead of the new c: the
    forward and the gradients part from JAX's far beyond 2e-5."""
    d = _scan_inputs(4, 5, 7, 6, seed=7)
    a = _torch(d)
    want = jrec.lstm_scan(*(jnp.asarray(d[k]) for k in ("x", "w", "rw", "b")),
                          peephole=jnp.asarray(d["p"]))[0]
    t, n, h = 7, 4, 6
    zx = (a["x"].permute(2, 0, 1).reshape(t * n, -1) @ a["w"]).reshape(
        t, n, 4 * h) + a["b"]
    hp = cp = torch.zeros(n, h)
    outs = []
    for s in range(t):
        zi, zf, zg, zo = (zx[s] + hp @ a["rw"]).split(h, dim=1)
        i = torch.sigmoid(zi + a["p"][0] * cp)
        f = torch.sigmoid(zf + a["p"][1] * cp)
        cn = f * cp + i * torch.tanh(zg)
        hp = torch.sigmoid(zo + a["p"][2] * cp) * torch.tanh(cn)  # fault
        cp = cn
        outs.append(hp)
    faulty = torch.stack(outs).permute(1, 2, 0).numpy()
    assert np.abs(faulty - np.asarray(want)).max() > 100 * TOL["atol"]


# ---------------------------------------------------------------------
# refusals and dispatch
# ---------------------------------------------------------------------
def test_other_activations_raise_not_implemented():
    """Once refused, a gate or cell activation other than sigmoid / tanh
    now takes the scan route: counted, no kernel launched, and the JAX
    scan's output."""
    d = _scan_inputs(2, 3, 4, 4, seed=8)
    a = _torch(d)
    kernels = (lk.LSTM_FWD.launches, lk.LSTM_BWD.launches)
    for kw in (dict(gate_act="hardsigmoid"), dict(cell_act="relu")):
        runs = trec.LSTM_SCAN.runs
        got, _, _ = trec.lstm_scan(a["x"], a["w"], a["rw"], a["b"], **kw)
        want, _, _ = jrec.lstm_scan(*(jnp.asarray(d[k])
                                      for k in ("x", "w", "rw", "b")), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert trec.LSTM_SCAN.runs == runs + 1
    layer = tl.GravesLSTM(n_out=4, gate_activation="hardsigmoid")
    gen = torch.Generator().manual_seed(0)
    p, s = layer.init(gen, InputType.recurrent(3, 4), "cpu")
    out, _ = layer.apply(p, a["x"], s)
    assert out.shape == (2, 4, 4)
    assert (lk.LSTM_FWD.launches, lk.LSTM_BWD.launches) == kernels


def test_cpu_tensors_launch_nothing_and_the_backward_refuses_a_mask():
    d = _scan_inputs(2, 3, 4, 4, seed=9)
    a = _torch(d)
    before = (lk.LSTM_FWD.launches, lk.LSTM_BWD.launches)
    leaves = [v.clone().requires_grad_() for v in (a["x"], a["w"], a["rw"],
                                                   a["b"], a["p"])]
    out, _, _ = trec.lstm_scan(*leaves[:4], peephole=leaves[4])
    out.sum().backward()
    assert (lk.LSTM_FWD.launches, lk.LSTM_BWD.launches) == before
    masked, _, _ = trec.lstm_scan(*leaves[:4], peephole=leaves[4],
                                  mask=a["mask"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        masked.sum().backward()
    with pytest.raises(ValueError, match="is not"):
        lk.lstm_forward(a["x"], a["rw"], a["h0"], a["c0"])


# ---------------------------------------------------------------------
# the cluster backward (csrc/lstm.cu cl::lstm_bwd_cluster_kernel)
# ---------------------------------------------------------------------
def _split3(x):
    """The kernel's three-term split of f32 values: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each remainder exact in f32."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_the_three_term_split_is_exact_and_its_product_f32():
    """hi + mid + lo is each seeded f32 value bit for bit, over normal
    values of exponents -100 .. 100 (3 x 8 significand bits cover f32's
    24); the terms' products with a bf16 RW, summed lo, mid, hi in f32,
    are the f32 product within 1e-6 of its f64 value's scale."""
    rng = np.random.default_rng(11)
    x = torch.tensor(_f32(rng.standard_normal((64, 128))
                          * 2.0 ** rng.integers(-100, 100, (64, 128))))
    hi, mid, lo = _split3(x)
    back = (hi.double() + mid.double() + lo.double())
    assert torch.equal(back, x.double())
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    w = torch.tensor(_f32(rng.standard_normal((128, 32)) * 0.1)) \
        .to(torch.bfloat16).float()
    d = torch.tensor(_f32(rng.standard_normal((64, 128))))
    terms = _split3(d)
    got = terms[2].float() @ w + terms[1].float() @ w + terms[0].float() @ w
    want = d.double() @ w.double()
    scale = (d.double().abs() @ w.double().abs())
    assert float(((got.double() - want).abs() / scale).max()) < 1e-6
    assert float(((d @ w).double() - want).abs().div(scale).max()) < 1e-6


def _cluster_bwd_mirror(gates, c, c0, rw, peep, dout, dh_t, dc_t, split):
    """The cluster backward in torch: each step's dgates cut into the
    blocks' pieces (block q's gate columns g H + q ub + u, u < ub, as
    columns g ub + u of a piece of kp); each block's dh over its units
    from every peer's piece in turn, against the block's RW slice. With
    ``split`` (the bf16 route) a piece's three bf16 terms multiply the
    slice one k16 step at a time (lo, mid, hi summed in f32, promoted
    into the peer's sum), the peers' sums added in order; else (f32)
    each peer's piece times the slice, the peers in order. The cell
    update is the plain version's. Returns (dzx, dh0, dc0) in f32."""
    t_len, n, h = c.shape
    plan = lk._lstm_bwd_cluster_plan(
        n, h, torch.bfloat16 if split else torch.float32)
    cs, ub, kp = plan.cluster, plan.ub, plan.kp
    rwf = rw.float()
    p = None if peep is None else peep.float()
    units = [range(q * ub, min(h, (q + 1) * ub)) for q in range(cs)]

    def cols(q):   # dgates columns of block q's piece, in piece order
        return [g * h + j for g in range(4) for j in units[q]]

    def dh_of(dg):
        dh = torch.zeros(n, h)
        for r in range(cs):
            own = list(units[r])
            acc = torch.zeros(n, len(own))
            for q in range(cs):
                piece = torch.zeros(n, kp)
                piece[:, :4 * len(units[q])] = dg[:, cols(q)]
                slab = torch.zeros(kp, len(own))
                slab[:4 * len(units[q])] = rwf[own][:, cols(q)].t()
                if split:
                    sq = torch.zeros(n, len(own))
                    for ks in range(kp // 16):
                        a = _split3(piece[:, 16 * ks:16 * ks + 16])
                        b = slab[16 * ks:16 * ks + 16]
                        sq = sq + (a[2].float() @ b + a[1].float() @ b
                                   + a[0].float() @ b)
                    acc = acc + sq
                else:
                    acc = acc + piece @ slab
            dh[:, own] = acc
        return dh

    dh_next = torch.zeros(n, h) if dh_t is None else dh_t.float()
    dc_next = torch.zeros(n, h) if dc_t is None else dc_t.float()
    dzx = []
    for t in range(t_len - 1, -1, -1):
        i, f, g, o = gates[t].float().split(h, dim=1)
        cn = c[t].float()
        cp = c0.float() if t == 0 else c[t - 1].float()
        dh = dout[t].float() + dh_next
        tc = torch.tanh(cn)
        dzo = dh * tc * o * (1.0 - o)
        dcn = dh * o * (1.0 - tc * tc) + dc_next
        if p is not None:
            dcn = dcn + p[2] * dzo
        dzi = dcn * g * i * (1.0 - i)
        dzf = dcn * cp * f * (1.0 - f)
        dzg = dcn * i * (1.0 - g * g)
        dc_next = dcn * f
        if p is not None:
            dc_next = dc_next + p[0] * dzi + p[1] * dzf
        dg = torch.cat([dzi, dzf, dzg, dzo], dim=1)
        dzx.append(dg)
        dh_next = dh_of(dg)
    return torch.stack(dzx[::-1]), dh_next, dc_next


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("t, n, h", [(5, 20, 40), (4, 18, 70), (6, 4, 5)])
def test_the_cluster_exchange_mirror_matches_the_plain_backward_and_jax(
        t, n, h, split):
    """The mirror (three clusters' worth of unit tiles at H = 70, two at
    40, one at 5; two batch tiles at N = 18, 20) on the plain forward's
    saves in f32 against ``lstm_backward_plain`` within 1e-5 and against
    ``jax.grad`` of the JAX scan within GRAD_TOL."""
    d, cot = _grad_case(seed=t * n + h, t=t, n=n, h=h)
    want = _jax_grads(d, cot)
    a = _torch(d)
    _, _, _, (gates, c) = lk.lstm_forward(a["zx"], a["rw"], a["h0"],
                                          a["c0"], a["p"], save=True)
    bwd = (gates, c, a["c0"], a["rw"], a["p"], torch.tensor(cot["out"]),
           torch.tensor(cot["h"]), torch.tensor(cot["c"]))
    got = _cluster_bwd_mirror(*bwd, split=split)
    plain = lk.lstm_backward_plain(*bwd)
    for g, pl, w in zip(got, plain, (want[0], want[2], want[3])):
        np.testing.assert_allclose(g.numpy(), pl.numpy(), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


#: (N, H): the text LSTM's shape, fewer rows, the decode row, an H the
#: unit tiles split unevenly (7 blocks of 29), and one block of 17 units
CLUSTER_SHAPES = [(256, 256), (64, 256), (1, 256), (256, 200), (3, 17)]


@pytest.mark.parametrize("n, h", CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype, mt", [(torch.bfloat16, 1),
                                       (torch.bfloat16, 2),
                                       (torch.float32, 1)])
def test_the_cluster_plan_covers_every_row_and_unit_once(n, h, dtype, mt):
    """Cluster b's block q owns rows b rows .. + rows and units q ub ..
    + ub, inside N and H: every (row, unit) pair once; at most 8 blocks
    a cluster of at most 32 units; the piece's columns cover the four
    gates of a block's units in whole k16 steps; a block's shared
    memory within the card's 227 KB."""
    plan = lk._lstm_bwd_cluster_plan(n, h, dtype, mt)
    assert lk.lstm_bwd_route(n, h, dtype) == lk.CLUSTER
    assert 1 <= plan.cluster <= 8 and 1 <= plan.ub <= 32
    assert plan.kp % 16 == 0 and 4 * plan.ub <= plan.kp < 4 * plan.ub + 16
    assert plan.rows == 16 * mt
    assert plan.smem <= 232448
    seen = np.zeros((n, h), np.int64)
    for b in range(plan.batch_tiles):
        for q in range(plan.cluster):
            seen[b * plan.rows:(b + 1) * plan.rows,
                 q * plan.ub:(q + 1) * plan.ub] += 1
    assert (seen == 1).all()
    assert (plan.cluster - 1) * plan.ub < h


@pytest.mark.parametrize("h", [1, 17, 200, 255, 256, 257, 512, 1024])
def test_the_backward_route_takes_clusters_up_to_256_units(h):
    want = lk.CLUSTER if h <= 256 else lk.COOPERATIVE
    for dtype in (torch.bfloat16, torch.float32):
        assert lk.lstm_bwd_route(64, h, dtype) == want
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lk.lstm_bwd_route(64, h, torch.float16)


# ---------------------------------------------------------------------
# the cluster forward (csrc/lstm.cu cl::lstm_fwd_cluster_kernel)
# ---------------------------------------------------------------------
def _cluster_fwd_mirror(zx, rw, h0, c0, peep=None, mask=None, stale=None):
    """The cluster forward in torch (f32): block q's piece of h_t is its
    units q ub .. + ub (padded to kp columns) of every row, written into
    buffer t & 1; step t assembles each block's h_{t-1} from the peers'
    pieces in buffer (t + 1) & 1 (h0 in buffer 1 before the first step)
    and multiplies peer q's piece, the q-th K-slice, against the rows of
    RW of its units, the peers' partials added in order (the kernel's
    warps each take 16 gate columns over the whole K, one K-slice at a
    time). With ``stale`` that peer's piece is read from the other
    buffer: a step stale (zeros at the first step). The cell update is
    the plain version's. Returns (out, hT, cT)."""
    t_len, n, h4 = zx.shape
    h = h4 // 4
    plan = lk._lstm_fwd_cluster_plan(n, h, torch.float32)
    cs, ub, kq = plan.cluster, plan.ub, plan.kp
    units = [list(range(q * ub, min(h, (q + 1) * ub))) for q in range(cs)]
    rwf = rw.float()
    p = None if peep is None else peep.float()
    pieces = torch.zeros(2, cs, n, kq)

    def put(buf, hv):
        for q in range(cs):
            pieces[buf, q, :, :len(units[q])] = hv[:, units[q]]

    hp, cp = h0.float(), c0.float()
    put(1, hp)
    outs = []
    for t in range(t_len):
        cur = (t + 1) & 1
        acc = torch.zeros(n, 4 * h)
        for q in range(cs):
            slab = torch.zeros(kq, 4 * h)
            slab[:len(units[q])] = rwf[units[q]]
            acc = acc + pieces[1 - cur if q == stale else cur, q] @ slab
        z = zx[t].float() + acc
        zi, zf, zg, zo = z.split(h, dim=1)
        if p is not None:
            zi, zf = zi + p[0] * cp, zf + p[1] * cp
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        cn = f * cp + i * g
        if p is not None:
            zo = zo + p[2] * cn
        hn = torch.sigmoid(zo) * torch.tanh(cn)
        hc, cc, ho = hn, cn, hn
        if mask is not None:
            m = mask[t].float()[:, None]
            hc, cc = hn * m + hp * (1.0 - m), cn * m + cp * (1.0 - m)
            ho = hc * m
        outs.append(ho)
        hp, cp = hc, cc
        put(t & 1, hp)
    return torch.stack(outs), hp, cp


#: (T, N, H): one, two and three unit tiles; two batch tiles at N = 18, 20
FWD_MIRROR_SHAPES = [(5, 20, 40), (4, 18, 70), (6, 4, 5)]
#: the mirror against the plain forward (the same f32 ops, products in
#: other orders) and the JAX scan and interpret kernel (their own f32
#: limits): atol and rtol 1e-5 / TOL
FWD_MIRROR_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t, n, h", FWD_MIRROR_SHAPES)
def test_the_cluster_forward_mirror_matches_the_plain_forward_and_jax(
        t, n, h, masked):
    """The mirror in f32 with peepholes (and a mask with a fully masked
    step and row) against ``lstm_forward_plain`` and the JAX
    ``lstm_scan`` (W the identity, so its x is zx) within FWD_MIRROR_TOL;
    without peepholes and mask against the JAX Pallas kernel in
    interpret mode within TOL; the stale peer's reading (each peer in
    turn) outside FWD_MIRROR_TOL."""
    d, _ = _grad_case(seed=t * n + h + 11, t=t, n=n, h=h)
    rng = np.random.default_rng(t + n + h)
    mask = (rng.random((t, n)) > 0.3).astype(np.float32)
    mask[1] = 0.0
    mask[:, 0] = 0.0
    a = _torch(d)
    tm = torch.tensor(mask) if masked else None
    got = _cluster_fwd_mirror(a["zx"], a["rw"], a["h0"], a["c0"], a["p"],
                              tm)
    plain = lk.lstm_forward_plain(a["zx"], a["rw"], a["h0"], a["c0"],
                                  a["p"], tm)[:3]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    out, h_t, c_t = jrec.lstm_scan(
        jnp.transpose(j["zx"], (1, 2, 0)), jnp.eye(4 * h, dtype=jnp.float32),
        j["rw"], jnp.zeros(4 * h, jnp.float32), h0=j["h0"], c0=j["c0"],
        peephole=j["p"], mask=jnp.asarray(mask.T) if masked else None)
    scan = (jnp.transpose(out, (2, 0, 1)), h_t, c_t)
    for g, pl, w in zip(got, plain, scan):
        np.testing.assert_allclose(g.numpy(), pl.numpy(), **FWD_MIRROR_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **FWD_MIRROR_TOL)
    if not masked:
        kern = pallas_lstm_recurrence(j["zx"], j["rw"], j["h0"], j["c0"],
                                      interpret=True)
        bare = _cluster_fwd_mirror(a["zx"], a["rw"], a["h0"], a["c0"])
        for g, w in zip(bare, kern):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for q in range(lk._lstm_fwd_cluster_plan(n, h, torch.float32).cluster):
        bad = _cluster_fwd_mirror(a["zx"], a["rw"], a["h0"], a["c0"],
                                  a["p"], tm, stale=q)[0]
        assert not np.allclose(bad.numpy(), plain[0].numpy(),
                               **FWD_MIRROR_TOL), q


@pytest.mark.parametrize("n, h", CLUSTER_SHAPES)
@pytest.mark.parametrize("dtype, mt", [(torch.bfloat16, 1),
                                       (torch.bfloat16, 2),
                                       (torch.float32, 1)])
def test_the_forward_cluster_plan_covers_every_row_and_unit_once(
        n, h, dtype, mt):
    """The forward's split: cluster b's block q owns rows b rows .. +
    rows and units q ub .. + ub, inside N and H, every (row, unit) pair
    once; its piece (its h tile's units, padded) whole k16 steps; its
    gate columns (4 ub) within the 8 warps' 128; a block's shared memory
    within the card's 227 KB, and at 16 rows in bf16 within half an SM's
    228 KB (two blocks an SM)."""
    plan = lk._lstm_fwd_cluster_plan(n, h, dtype, mt)
    assert lk.lstm_fwd_route(n, h, dtype) == lk.CLUSTER
    assert plan[:2] == lk._lstm_bwd_cluster_plan(n, h, dtype, mt)[:2]
    assert 1 <= plan.cluster <= 8 and 1 <= plan.ub <= 32
    assert plan.kp % 16 == 0 and plan.ub <= plan.kp < plan.ub + 16
    assert 4 * plan.ub <= 128 and plan.rows == 16 * mt
    assert plan.smem <= 232448
    if dtype == torch.bfloat16:
        assert 2 * (plan.smem + 1024) <= 233472
    seen = np.zeros((n, h), np.int64)
    for b in range(plan.batch_tiles):
        for q in range(plan.cluster):
            seen[b * plan.rows:(b + 1) * plan.rows,
                 q * plan.ub:(q + 1) * plan.ub] += 1
    assert (seen == 1).all()
    assert (plan.cluster - 1) * plan.ub < h


@pytest.mark.parametrize("n, active, want", [
    (256, {1: 30, 2: 30}, 1),   # 16 clusters in one wave: 16 rows
    (256, {1: 15, 2: 15}, 2),   # 16 take two waves, 8 one
    (256, {1: 0, 2: 15}, 2),    # 16 rows do not fit
    (1, {1: 15, 2: 15}, 1)])
def test_the_cluster_plan_picks_the_rows_of_fewest_waves(n, active, want):
    assert lk._cluster_row_tiles(n, 256, torch.bfloat16, active) == want
    if active[1]:   # f32 takes 16 rows a block only
        assert lk._cluster_row_tiles(n, 256, torch.float32, active) == 1
    with pytest.raises(ValueError, match="fits"):
        lk._cluster_row_tiles(n, 256, torch.bfloat16, {1: 0, 2: 0})


@pytest.mark.parametrize("h", [1, 17, 200, 255, 256, 257, 512, 1024])
def test_the_forward_route_takes_clusters_up_to_256_units(h):
    """The forward's route by shape: the cluster kernel up to H = 256,
    the decode shape (N = 1) included; the cooperative kernel beyond."""
    want = lk.CLUSTER if h <= 256 else lk.COOPERATIVE
    for dtype in (torch.bfloat16, torch.float32):
        for n in (1, 64, 256):
            assert lk.lstm_fwd_route(n, h, dtype) == want
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lk.lstm_fwd_route(64, h, torch.float16)
