"""Recurrent ops: the LSTM family over the recurrence kernels.

Counterpart of ``deeplearning4j_tpu/nn/layers/recurrent.py``:
``lstm_scan`` runs an LSTM over a whole ``[N, C, T]`` sequence (DL4J's
NCW layout), and ``bidirectional_sum`` adds a forward and a reversed
pass (GravesBidirectionalLSTM). As in the JAX package, the input
projection ``x W + b`` of all steps is one product outside the
recurrence (JAX ``recurrent.py:59-62``); the recurrence itself is
:func:`~deeplearning4j_tpu_torch.nn.layers.lstm_kernel.lstm_recurrence`,
the CUDA kernels on the card and their plain versions on the CPU, with
the peepholes and the mask inside it. Gate order (i, f, c, o); masked
steps carry h and c through unchanged and output zeros. ``reverse``
flips zx and the mask and flips the outputs back (JAX ``:76-79``).

The kernels compute the JAX package's default gates (sigmoid) and cell
activation (tanh). Any other gate or cell activation runs
:func:`lstm_scan_steps`, a step-by-step loop of the JAX scan's math
(JAX ``recurrent.py:85-120``) in plain PyTorch, differentiated by
autograd: the JAX package's own route, whose ``pallas_lstm_supported``
sends every other activation to XLA's scan and never to the Pallas
kernel. The route is chosen from the two activations alone
(:func:`lstm_route`), never after a kernel fails, and each run of the
scan route is counted in ``LSTM_SCAN.runs``, beside the kernels' launch
counts. The vanilla RNN (``simple_rnn_scan``) comes with ``SimpleRnn``
(ROADMAP.md A11).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn.layers.lstm_kernel import lstm_recurrence

__all__ = ["LSTM_SCAN", "bidirectional_sum", "lstm_route", "lstm_scan",
           "lstm_scan_steps"]


class RouteCount:
    """A plain count of a route's runs (one per layer and call)."""

    def __init__(self, name: str):
        self.name = name
        self.runs = 0


#: the runs of the step-by-step scan route
LSTM_SCAN = RouteCount("lstm_scan")


def lstm_route(gate_act: str, cell_act: str) -> str:
    """``"kernel"`` for sigmoid gates and a tanh cell (the recurrence
    kernels' math), else ``"scan"``."""
    if str(gate_act).lower() == "sigmoid" and \
            str(cell_act).lower() == "tanh":
        return "kernel"
    return "scan"


def lstm_scan_steps(zx, rw, h0, c0, peephole=None, mask=None,
                    gate_act="sigmoid", cell_act="tanh", reverse=False):
    """The JAX scan's step over ``zx [T, N, 4H]`` (the input projection
    with its bias), one step at a time in plain PyTorch: ``z = zx_t +
    h RW``, the gates (i, f, c, o) with peepholes ``[3, H]`` on the
    previous cell (i, f) and the new one (o), masked steps ``[T, N]``
    carrying h and c through and outputting zeros; ``reverse`` walks the
    steps from the last. Returns ``(out [T, N, H], hT, cT)``."""
    gact, cact = _act.get(gate_act), _act.get(cell_act)
    t = zx.shape[0]
    h, c = h0, c0
    outs = [None] * t
    for s in (range(t - 1, -1, -1) if reverse else range(t)):
        z = zx[s] + h @ rw
        zi, zf, zc, zo = torch.chunk(z, 4, dim=-1)
        if peephole is not None:
            zi = zi + peephole[0] * c
            zf = zf + peephole[1] * c
        c_new = gact(zf) * c + gact(zi) * cact(zc)
        if peephole is not None:
            zo = zo + peephole[2] * c_new
        h_new = gact(zo) * cact(c_new)
        if mask is not None:
            m = mask[s][:, None].to(zx.dtype)
            h_new = h_new * m + h * (1.0 - m)
            c_new = c_new * m + c * (1.0 - m)
            outs[s] = h_new * m
        else:
            outs[s] = h_new
        h, c = h_new, c_new
    return torch.stack(outs), h, c


def lstm_scan(x: torch.Tensor, w: torch.Tensor, rw: torch.Tensor,
              b: torch.Tensor, h0: Optional[torch.Tensor] = None,
              c0: Optional[torch.Tensor] = None,
              peephole: Optional[torch.Tensor] = None,
              mask: Optional[torch.Tensor] = None,
              gate_act: str = "sigmoid", cell_act: str = "tanh",
              reverse: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run an LSTM over ``x [N, C, T]`` with W ``[C, 4H]``, RW ``[H,
    4H]``, b ``[4H]``, optional carry h0 / c0 ``[N, H]`` (zeros of x's
    dtype), peepholes ``[3, H]`` (rows pI, pF, pO) and mask ``[N, T]``.
    Returns ``(out [N, H, T], hT, cT)``."""
    n, _, t = x.shape
    h = rw.shape[0]
    if h0 is None:
        h0 = x.new_zeros((n, h))
    if c0 is None:
        c0 = x.new_zeros((n, h))
    xt = x.permute(2, 0, 1)                                # [T, N, C]
    zx = (xt.reshape(t * n, -1) @ w).reshape(t, n, 4 * h) + b
    m = None if mask is None else mask.t().to(torch.float32)   # [T, N]
    if lstm_route(gate_act, cell_act) == "scan":
        LSTM_SCAN.runs += 1
        out, h_t, c_t = lstm_scan_steps(zx, rw, h0.to(x.dtype),
                                        c0.to(x.dtype), peephole, m,
                                        gate_act, cell_act, reverse)
        return out.permute(1, 2, 0), h_t, c_t
    if reverse:
        zx = zx.flip(0)
        m = None if m is None else m.flip(0)
    out, h_t, c_t = lstm_recurrence(zx, rw, h0.to(x.dtype), c0.to(x.dtype),
                                    peephole, m)
    if reverse:
        out = out.flip(0)
    return out.permute(1, 2, 0), h_t, c_t


def bidirectional_sum(x, wf, rwf, bf, wb, rwb, bb, peep_f=None, peep_b=None,
                      mask=None, gate_act="sigmoid", cell_act="tanh"):
    """GravesBidirectionalLSTM: the forward and the reversed LSTM's
    outputs, SUMMED."""
    out_f, _, _ = lstm_scan(x, wf, rwf, bf, peephole=peep_f, mask=mask,
                            gate_act=gate_act, cell_act=cell_act)
    out_b, _, _ = lstm_scan(x, wb, rwb, bb, peephole=peep_b, mask=mask,
                            gate_act=gate_act, cell_act=cell_act,
                            reverse=True)
    return out_f + out_b
