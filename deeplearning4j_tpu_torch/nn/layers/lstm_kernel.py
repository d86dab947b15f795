"""The LSTM recurrence: the CUDA kernels' wrappers, their plain PyTorch
versions, and the autograd Function built from them.

Counterpart of ``deeplearning4j_tpu/nn/layers/pallas_kernels.py``: the
recurrent half of an LSTM, ``zx [T, N, 4H]`` (the input projection plus
bias of every step, computed outside as one product), ``RW [H, 4H]`` and
the carry ``h0``, ``c0 [N, H]`` to ``out [T, N, H]``, ``hT`` and ``cT``,
gate order (i, f, c, o).

The kernels are hand-written CUDA C++ for Hopper, ``csrc/lstm.cu``:
:func:`lstm_forward` replaces the TPU kernel ``_lstm_kernel``, and
:func:`lstm_backward` is the port's own (the JAX package differentiates
through its scan, ``_lstm_bwd``). The source note says what bounds each
on the card and what the design does about it: one persistent,
time-looped launch per layer and direction. Each has two routes,
:func:`lstm_fwd_route` and :func:`lstm_bwd_route`: where the unit tiles
of a batch tile fit one thread-block cluster (H <= 256) the cluster
kernel exchanges each step's h (forward) or dgates (backward) through
distributed shared memory and meets at a cluster barrier (their splits
mirrored by :func:`_lstm_fwd_cluster_plan` and
:func:`_lstm_bwd_cluster_plan`), else the cooperative kernel, whose
steps meet at a grid barrier. Each wrapper dispatches on where its
tensors lie: CUDA tensors launch the kernel of their route (or raise on
what it does not take), CPU tensors take the plain version beside it, a
per-step loop with the kernel's rounding points. There is no
process-wide switch.

Beyond the TPU kernel, the kernels compute what the JAX scan
(``deeplearning4j_tpu/nn/layers/recurrent.py`` ``lstm_scan``) computes
for the same layers, so every LSTM layer of the port runs them: the
peephole terms of GravesLSTM (``zi += pI c_prev``, ``zf += pF c_prev``,
``zo += pO c_new``: the NEW c) and a ``[T, N]`` mask (``h = h_new m +
h_prev (1 - m)``, c likewise, ``out = h m``). Each step runs in f32 and
rounds h and c to the model dtype at its end, as the carry of the JAX
layer's scan has the model dtype (in f32 this is exactly the TPU
kernel's math, whose carry is f32); the training forward saves the
activated gates and the unrounded c of every step in f32 for the
backward.

:class:`LSTMRecurrence` is the ``torch.autograd.Function`` counterpart
of the JAX ``lstm_recurrence`` with its ``custom_vjp``: the backward
kernel gives ``dzx``, ``dh0`` and ``dc0``; ``dRW`` (``sum_t
h_{t-1}^T dgates_t``) and the three peephole rows (from the saved c) are
products and reductions outside, as JAX computes them outside any Pallas
kernel. A mask is taken by the forward (``output(mask=)``) and refused
by the backward (features masks in ``fit``: ROADMAP.md A6).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from deeplearning4j_tpu_torch.cuda_library import CudaKernel, CudaLibrary

__all__ = ["CLUSTER", "COOPERATIVE", "LSTMRecurrence", "LSTM_BWD",
           "LSTM_FWD", "lstm_backward", "lstm_backward_plain",
           "lstm_bwd_route", "lstm_forward", "lstm_forward_plain",
           "lstm_fwd_route", "lstm_plan", "lstm_recurrence"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 14 + [_I] * 6 + [_P]
_BWD_ARGS = [_P] * 14 + [_I] * 6 + [_P]
#: the cluster kernels' entry points, forward and backward alike
_CLUSTER_ARGS = [_P] * 11 + [_I] * 4 + [_P]
_DTYPES = (torch.float32, torch.bfloat16)
#: the two routes of each kernel
COOPERATIVE, CLUSTER = "cooperative", "cluster"
#: the cluster route: at most 8 blocks a cluster (the portable size) of
#: at most 32 units each, 16 rows an m16 tile, 256 threads a block, 6 f32
#: saves a (row, unit) pair staged two steps deep (csrc/lstm.cu's
#: cl::kMaxCluster, kMaxUnits, kThreads, kVals); the forward's 128 gate
#: columns a block, its bf16 RW slice's and f32 gate tile's rows
#: (kFwdCols, kFwdNs, kGateStride)
_CLUSTER_MAX, _CLUSTER_UNITS, _CLUSTER_THREADS, _CLUSTER_VALS = 8, 32, 256, 6
_FWD_COLS, _FWD_NS, _GATE_STRIDE = 128, 136, 132


def _symbols(stem):
    return {torch.float32: f"dl4j_{stem}_f32",
            torch.bfloat16: f"dl4j_{stem}_bf16"}


_LIBRARY = CudaLibrary(
    "lstm", ["nn/layers/csrc/lstm.cu"],
    {**{s: _FWD_ARGS for s in _symbols("lstm_fwd").values()},
     **{s: _CLUSTER_ARGS for s in _symbols("lstm_fwd_cluster").values()},
     **{s: _BWD_ARGS for s in _symbols("lstm_bwd").values()},
     **{s: _CLUSTER_ARGS for s in _symbols("lstm_bwd_cluster").values()},
     "dl4j_lstm_plan": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
     "dl4j_lstm_bwd_cluster_plan": [_I, _I, _I,
                                    ctypes.POINTER(ctypes.c_int)],
     "dl4j_lstm_fwd_cluster_plan": [_I, _I, _I,
                                    ctypes.POINTER(ctypes.c_int)],
     "dl4j_lstm_bwd_kernel_launches": [ctypes.POINTER(ctypes.c_int)],
     "dl4j_lstm_fwd_kernel_launches": [ctypes.POINTER(ctypes.c_int)]},
    headers=["nn/layers/csrc/conv_mma.cuh",
             "nn/layers/csrc/nan_max.cuh"])

#: the two kernels; each ``.launches`` counts its launches (one per layer
#: and direction per forward or backward, whatever T); their entry points
#: by (dtype, route)
LSTM_FWD = CudaKernel(_LIBRARY, "lstm_fwd", {
    **{(dt, COOPERATIVE): sym for dt, sym in _symbols("lstm_fwd").items()},
    **{(dt, CLUSTER): sym
       for dt, sym in _symbols("lstm_fwd_cluster").items()}})
LSTM_BWD = CudaKernel(_LIBRARY, "lstm_bwd", {
    **{(dt, COOPERATIVE): sym for dt, sym in _symbols("lstm_bwd").items()},
    **{(dt, CLUSTER): sym
       for dt, sym in _symbols("lstm_bwd_cluster").items()}})


def _route(name, n, h, dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"{name} kernels take float32 or bfloat16, got "
                         f"{dtype}")
    if n < 1 or h < 1:
        raise ValueError(f"{name}: N and H must be at least 1, got "
                         f"{(n, h)}")
    return CLUSTER if -(-h // _CLUSTER_UNITS) <= _CLUSTER_MAX \
        else COOPERATIVE


def lstm_bwd_route(n: int, h: int, dtype) -> str:
    """The backward's route for N rows, H units and ``dtype``: CLUSTER
    where the unit tiles of a batch tile (``ceil(H / 32)`` of them) fit
    one portable cluster of 8 blocks (H <= 256), else COOPERATIVE.
    Raises on a dtype no route takes."""
    return _route("lstm_backward", n, h, dtype)


def lstm_fwd_route(n: int, h: int, dtype) -> str:
    """The forward's route for N rows, H units and ``dtype``, by the
    backward's rule: CLUSTER up to H = 256 (the decode shape, N = 1,
    included), else COOPERATIVE. Raises on a dtype no route takes."""
    return _route("lstm_forward", n, h, dtype)


class ClusterPlan(NamedTuple):
    """A cluster kernel's split, as ``csrc/lstm.cu``'s ``cl::geo`` makes
    it: ``cluster`` blocks a cluster of ``ub`` units each (block q owns
    units ``q ub .. q ub + ub`` inside H), a piece of ``kp`` columns a
    block (the backward: its 4 ub gate columns of dgates; the forward:
    its ub units of h, the K-slice of the product; padded to whole k16
    steps), ``rows`` = 16
    ``mt`` batch rows a block, ``batch_tiles`` clusters (cluster b owns
    rows ``b rows .. b rows + rows`` inside N), and ``smem`` bytes of
    shared memory a block."""
    cluster: int
    ub: int
    kp: int
    mt: int
    rows: int
    batch_tiles: int
    smem: int


def _lstm_bwd_cluster_plan(n, h, dtype, mt=1) -> ClusterPlan:
    """The cluster route's split for N rows and H units at ``mt`` row
    tiles a block (the kernel takes 1 or 2 in bf16, 1 in f32; the card's
    plan picks the one it runs in the fewest waves)."""
    cs = -(-h // _CLUSTER_UNITS)
    ub = -(-h // cs)
    kp = -(-4 * ub // 16) * 16
    rows = 16 * mt
    # the warps' partials and the saves' two stages, then the exchange's
    # two buffers and the RW slice
    smem = (8 * rows * (_CLUSTER_UNITS + 8) * 4
            + 2 * _CLUSTER_VALS * 2 * mt * _CLUSTER_THREADS * 4)
    if dtype == torch.bfloat16:
        smem += 2 * mt * (kp // 16) * 3 * 256 * 2 + 32 * (cs * kp + 8) * 2
    else:
        smem += 2 * rows * kp * 4 + cs * kp * _CLUSTER_UNITS * 4
    return ClusterPlan(cs, ub, kp, mt, rows, -(-n // rows), smem)


def _lstm_fwd_cluster_plan(n, h, dtype, mt=1) -> ClusterPlan:
    """The forward cluster route's split for N rows and H units at ``mt``
    row tiles a block (1 or 2 in bf16, 1 in f32), as ``cl::geo`` and
    ``cl::fwd_smem_bytes`` make it: the piece is the block's h tile, ``kp
    = ub`` padded to whole k16 steps; shared memory holds the exchange's
    two pieces, the assembled h tile (``cluster kp`` columns), the f32
    gate tile, the stores' staging tile (out and c) and the RW slice
    (bf16 rows of 136, f32 of 128)."""
    cs = -(-h // _CLUSTER_UNITS)
    ub = -(-h // cs)
    kq = -(-ub // 16) * 16
    rows = 16 * mt
    kall = cs * kq
    el = 2 if dtype == torch.bfloat16 else 4
    smem = ((2 * mt * kq * 16 + kall * mt * 16) * el
            + rows * (_GATE_STRIDE + 2 * _CLUSTER_UNITS) * 4
            + kall * (_FWD_NS if dtype == torch.bfloat16 else _FWD_COLS) * el)
    return ClusterPlan(cs, ub, kq, mt, rows, -(-n // rows), smem)


def _cluster_row_tiles(n, h, dtype, active) -> int:
    """The row tiles a block (``mt``) the C plan (``cl::plan``) picks for
    a cluster route, given ``active[mt]``, the clusters the card runs at
    once at that split (0 where a block does not fit): of 1 and 2 (bf16;
    f32 takes 1), the one whose ``ceil(N / 16 mt)`` clusters run in the
    fewest waves, ties to the smaller (less work a step)."""
    best = None
    for mt in ((1, 2) if dtype == torch.bfloat16 else (1,)):
        if active.get(mt, 0) < 1:
            continue
        waves = -(-(-(-n // (16 * mt))) // active[mt])
        if best is None or waves < best[0]:
            best = (waves, mt)
    if best is None:
        raise ValueError(f"no cluster split of N={n}, H={h} fits")
    return best[1]


@functools.lru_cache(maxsize=None)
def _plan(n: int, h: int, bf16: bool, bwd: bool, device_index: int):
    dtype = torch.bfloat16 if bf16 else torch.float32
    route = (lstm_bwd_route if bwd else lstm_fwd_route)(n, h, dtype)
    with torch.cuda.device(device_index):
        lib = _LIBRARY.load()
        if route == CLUSTER:
            out = (ctypes.c_int * 8)()
            sym = f"dl4j_lstm_{'bwd' if bwd else 'fwd'}_cluster_plan"
            _LIBRARY.check(sym, getattr(lib, sym)(n, h, int(bf16), out))
            keys = ("cluster", "ub", "kp", "mt", "rows", "batch_tiles",
                    "smem", "active_clusters")
        else:
            out = (ctypes.c_int * 7)()
            _LIBRARY.check("dl4j_lstm_plan",
                           lib.dl4j_lstm_plan(n, h, int(bf16), int(bwd),
                                              out))
            keys = ("ub", "nb", "units", "batch_tiles", "groups",
                    "resident", "smem")
    return {"route": route, **dict(zip(keys, list(out)))}


def lstm_plan(n: int, h: int, dtype, bwd: bool = False, device=None):
    """The kernel's work split on the current CUDA device for N rows and
    H units, with its ``route``. The cooperative route: ``ub`` units and
    ``nb`` rows a tile, the grid of ``units`` x ``groups`` blocks,
    whether RW's slice stays resident in shared memory, and the dynamic
    shared memory a block takes. The cluster route: the fields of
    :class:`ClusterPlan` at the row tiles whose clusters the card runs
    in the fewest waves, and how many clusters it runs at once (the
    source note of ``csrc/lstm.cu`` says how each is chosen)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return _plan(int(n), int(h), dtype == torch.bfloat16, bool(bwd), idx)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------
def _check(zx, rw, h0, c0, peephole, mask):
    """Raise on shapes that do not fit together, on any device."""
    if zx.dim() != 3 or zx.shape[2] % 4:
        raise ValueError(f"lstm: zx {tuple(zx.shape)} is not [T, N, 4H]")
    t, n, h4 = zx.shape
    h = h4 // 4
    if t < 1 or n < 1 or h < 1:
        raise ValueError(f"lstm: T, N and H must be at least 1, got "
                         f"{(t, n, h)}")
    for key, x, shape in (("rw", rw, (h, h4)), ("h0", h0, (n, h)),
                          ("c0", c0, (n, h)),
                          ("peephole", peephole, (3, h)),
                          ("mask", mask, (t, n))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"lstm: {key} {tuple(x.shape)} is not {shape}")
    return t, n, h


def _check_cuda(name, ref, same=(), f32=()):
    """Raise on what a kernel does not take: ``ref`` f32 or bf16 on a
    CUDA device; the ``same`` operands of its dtype and the ``f32`` ones
    in f32 (pairs of key and tensor, None for an absent one), all
    contiguous on ref's device."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{ref.device}")
    if ref.dtype not in _DTYPES:
        raise ValueError(f"{name} kernel takes f32 or bf16, got {ref.dtype}")
    for key, x, dtype in ([(k, x, ref.dtype) for k, x in same]
                          + [(k, x, torch.float32) for k, x in f32]):
        if x is None:
            continue
        if x.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype}, got {x.dtype}")
        if x.device != ref.device:
            raise ValueError(f"{name}: {key} is on {x.device}, not "
                             f"{ref.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------
def lstm_forward(zx, rw, h0, c0, peephole=None, mask=None, *,
                 save: bool = False):
    """The forward recurrence: ``(out [T, N, H], hT, cT)`` in zx's dtype,
    and with ``save`` the backward's saves ``(gates [T, N, 4H], c [T, N,
    H])`` in f32 (None otherwise). rw, h0, c0 and the optional peephole
    ``[3, H]`` in zx's dtype, the optional mask ``[T, N]`` f32. The
    kernel of :func:`lstm_fwd_route` on CUDA tensors (one launch for all
    T steps; the same bits on every launch), :func:`lstm_forward_plain`
    on CPU tensors."""
    t, n, h = _check(zx, rw, h0, c0, peephole, mask)
    if zx.device.type == "cpu":
        return lstm_forward_plain(zx, rw, h0, c0, peephole, mask, save=save)
    _check_cuda("lstm_forward", zx,
                (("zx", zx), ("rw", rw), ("h0", h0), ("c0", c0),
                 ("peephole", peephole)), (("mask", mask),))
    dev, f32 = zx.device, torch.float32
    out = torch.empty((t, n, h), dtype=zx.dtype, device=dev)
    h_t = torch.empty((n, h), dtype=zx.dtype, device=dev)
    c_t = torch.empty((n, h), dtype=zx.dtype, device=dev)
    saves = (torch.empty((t, n, 4 * h), dtype=f32, device=dev),
             torch.empty((t, n, h), dtype=f32, device=dev)) if save \
        else (None, None)
    p = lstm_plan(n, h, zx.dtype, device=dev)
    if p["route"] == CLUSTER:
        LSTM_FWD.launch((zx.dtype, CLUSTER), zx.data_ptr(), rw.data_ptr(),
                        h0.data_ptr(), c0.data_ptr(), _ptr(peephole),
                        _ptr(mask), out.data_ptr(), h_t.data_ptr(),
                        c_t.data_ptr(), _ptr(saves[0]), _ptr(saves[1]), t,
                        n, h, p["mt"], _stream(zx))
        return out, h_t, c_t, (saves if save else None)
    hbuf = torch.empty((2, n, h), dtype=zx.dtype, device=dev)
    cbuf = torch.empty((n, h), dtype=f32, device=dev)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    LSTM_FWD.launch((zx.dtype, COOPERATIVE), zx.data_ptr(), rw.data_ptr(),
                    h0.data_ptr(), c0.data_ptr(), _ptr(peephole),
                    _ptr(mask), out.data_ptr(), h_t.data_ptr(),
                    c_t.data_ptr(), hbuf.data_ptr(), cbuf.data_ptr(),
                    _ptr(saves[0]), _ptr(saves[1]), sync.data_ptr(), t, n,
                    h, p["ub"], p["groups"], p["resident"], _stream(zx))
    return out, h_t, c_t, (saves if save else None)


def lstm_backward(gates, c, c0, rw, peephole, dout, dh_t=None, dc_t=None):
    """The backward recurrence from the forward's saves ``gates [T, N,
    4H]`` and ``c [T, N, H]`` (f32), c0, rw, the optional peephole (the
    model dtype) and the gradients of out ``[T, N, H]`` and, optionally,
    of hT and cT: ``(dzx [T, N, 4H], dh0, dc0)`` in the model dtype. The
    kernel of :func:`lstm_bwd_route` on CUDA tensors (one launch for all
    T steps; the same bits on every launch), :func:`lstm_backward_plain`
    on CPU tensors."""
    if gates.dim() != 3 or c.dim() != 3 or gates.shape[2] != 4 * c.shape[2] \
            or gates.shape[:2] != c.shape[:2]:
        raise ValueError(f"lstm_backward: saves {tuple(gates.shape)} and "
                         f"{tuple(c.shape)} are not [T, N, 4H] and [T, N, H]")
    t, n, h = c.shape
    for key, x, shape in (("c0", c0, (n, h)), ("rw", rw, (h, 4 * h)),
                          ("peephole", peephole, (3, h)),
                          ("dout", dout, (t, n, h)), ("dh_t", dh_t, (n, h)),
                          ("dc_t", dc_t, (n, h))):
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"lstm_backward: {key} {tuple(x.shape)} is "
                             f"not {shape}")
    if dout.device.type == "cpu":
        return lstm_backward_plain(gates, c, c0, rw, peephole, dout, dh_t,
                                   dc_t)
    _check_cuda("lstm_backward", dout,
                (("dout", dout), ("c0", c0), ("rw", rw),
                 ("peephole", peephole), ("dh_t", dh_t), ("dc_t", dc_t)),
                (("gates", gates), ("c", c)))
    dev, dt = dout.device, dout.dtype
    dzx = torch.empty((t, n, 4 * h), dtype=dt, device=dev)
    dh0 = torch.empty((n, h), dtype=dt, device=dev)
    dc0 = torch.empty((n, h), dtype=dt, device=dev)
    p = lstm_plan(n, h, dt, bwd=True, device=dev)
    if p["route"] == CLUSTER:
        LSTM_BWD.launch((dt, CLUSTER), gates.data_ptr(), c.data_ptr(),
                        c0.data_ptr(), rw.data_ptr(), _ptr(peephole),
                        dout.data_ptr(), _ptr(dh_t), _ptr(dc_t),
                        dzx.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), t,
                        n, h, p["mt"], _stream(dout))
        return dzx, dh0, dc0
    dgbuf = torch.empty((2, n, 4 * h), dtype=torch.float32, device=dev)
    dcbuf = torch.empty((n, h), dtype=torch.float32, device=dev)
    sync = torch.zeros(2, dtype=torch.int32, device=dev)
    LSTM_BWD.launch((dt, COOPERATIVE), gates.data_ptr(), c.data_ptr(),
                    c0.data_ptr(), rw.data_ptr(), _ptr(peephole),
                    dout.data_ptr(), _ptr(dh_t), _ptr(dc_t), dzx.data_ptr(),
                    dh0.data_ptr(), dc0.data_ptr(), dgbuf.data_ptr(),
                    dcbuf.data_ptr(), sync.data_ptr(), t, n, h, p["ub"],
                    p["groups"], p["resident"], _stream(dout))
    return dzx, dh0, dc0


# ---------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------
def lstm_forward_plain(zx, rw, h0, c0, peephole=None, mask=None, *,
                       save: bool = False):
    """:func:`lstm_forward` as a per-step loop of PyTorch ops: each step
    in f32 (``h_{t-1} RW`` on the f32 values of the model-dtype
    operands), h and c rounded to zx's dtype at its end."""
    t_len, _, h4 = zx.shape
    h = h4 // 4
    dt = zx.dtype
    rwf = rw.float()
    p = None if peephole is None else peephole.float()
    hp, cp = h0.float(), c0.float()
    outs, gates, cs = [], [], []
    for t in range(t_len):
        z = zx[t].float() + hp @ rwf
        zi, zf, zg, zo = z[:, :h], z[:, h:2 * h], z[:, 2 * h:3 * h], \
            z[:, 3 * h:]
        if p is not None:
            zi = zi + p[0] * cp
            zf = zf + p[1] * cp
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        cn = f * cp + i * g
        if p is not None:
            zo = zo + p[2] * cn
        o = torch.sigmoid(zo)
        hn = o * torch.tanh(cn)
        if mask is not None:
            m = mask[t].float()[:, None]
            hc, cc = hn * m + hp * (1.0 - m), cn * m + cp * (1.0 - m)
            ho = hc * m
        else:
            hc, cc, ho = hn, cn, hn
        outs.append(ho.to(dt))
        hp, cp = hc.to(dt).float(), cc.to(dt).float()
        if save:
            gates.append(torch.cat([i, f, g, o], dim=1))
            cs.append(cn)
    saves = (torch.stack(gates), torch.stack(cs)) if save else None
    return torch.stack(outs), hp.to(dt), cp.to(dt), saves


def lstm_backward_plain(gates, c, c0, rw, peephole, dout, dh_t=None,
                        dc_t=None):
    """:func:`lstm_backward` as a per-step loop of PyTorch ops, in f32
    (``dh_{t-1} = dgates_t RW^T`` on the f32 dgates), the outputs rounded
    to dout's dtype."""
    t_len, n, h = c.shape
    dt = dout.dtype
    rwt = rw.float().t()
    p = None if peephole is None else peephole.float()
    zeros = torch.zeros((n, h), dtype=torch.float32, device=dout.device)
    dh_next = zeros if dh_t is None else dh_t.float()
    dc_next = zeros if dc_t is None else dc_t.float()
    dzx = []
    for t in range(t_len - 1, -1, -1):
        i, f, g, o = gates[t].float().split(h, dim=1)
        cn = c[t].float()
        cp = c0.float() if t == 0 else c[t - 1].to(dt).float()
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
        dzx.append(dg.to(dt))
        dh_next = dg @ rwt
    return (torch.stack(dzx[::-1]), dh_next.to(dt), dc_next.to(dt))


# ---------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------
class LSTMRecurrence(torch.autograd.Function):
    """``(out, hT, cT)`` of the recurrence, differentiable in zx, rw, h0,
    c0 and the peephole: the forward kernel saving its gates and c, the
    backward kernel for dzx, dh0 and dc0, and the sequence-wide products
    dRW = sum_t h_{t-1}^T dgates_t and dP (pI, pF from c_{t-1}, pO from
    the new c) outside it. The backward refuses a mask."""

    @staticmethod
    def forward(ctx, zx, rw, h0, c0, peephole, mask):
        # autograd runs this under no_grad; the inputs say whether a
        # backward can follow
        train = any(ctx.needs_input_grad[:5])
        out, h_t, c_t, saves = lstm_forward(zx, rw, h0, c0, peephole, mask,
                                            save=train and mask is None)
        ctx.masked = mask is not None
        if saves is not None:
            ctx.save_for_backward(saves[0], saves[1], out, rw, h0, c0,
                                  peephole)
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, dout, dh_t, dc_t):
        if ctx.masked:
            raise NotImplementedError(
                "the LSTM recurrence's backward takes no mask: feature "
                "masks in fit are not ported yet (ROADMAP.md A6)")
        gates, c, out, rw, h0, c0, peephole = ctx.saved_tensors
        dt = out.dtype
        # autograd hands zeros for an output the loss does not read
        dzx, dh0, dc0 = lstm_backward(gates, c, c0, rw, peephole,
                                      dout.contiguous(), dh_t.contiguous(),
                                      dc_t.contiguous())
        t_len, n, h = out.shape
        # h_{t-1}: h0, then the outputs (the carry: no mask here)
        h_prev = torch.cat([h0[None], out[:-1]]).reshape(t_len * n, h)
        drw = (h_prev.t() @ dzx.reshape(t_len * n, 4 * h)).to(rw.dtype)
        dp = None
        if peephole is not None:
            c_prev = torch.cat([c0[None].float(), c[:-1].to(dt).float()])
            dzf32 = dzx.float()
            dp = torch.stack([
                (dzf32[..., :h] * c_prev).sum((0, 1)),
                (dzf32[..., h:2 * h] * c_prev).sum((0, 1)),
                (dzf32[..., 3 * h:] * c).sum((0, 1))]).to(peephole.dtype)
        return dzx, drw, dh0, dc0, dp, None


def lstm_recurrence(zx, rw, h0, c0, peephole=None, mask=None):
    """``(out [T, N, H], hT, cT)`` of the LSTM recurrence over ``zx [T,
    N, 4H]`` (see :class:`LSTMRecurrence`); the kernels on CUDA tensors,
    their plain versions on CPU tensors."""
    return LSTMRecurrence.apply(zx.contiguous(), rw.contiguous(),
                                h0.contiguous(), c0.contiguous(),
                                None if peephole is None
                                else peephole.contiguous(),
                                None if mask is None
                                else mask.float().contiguous())
