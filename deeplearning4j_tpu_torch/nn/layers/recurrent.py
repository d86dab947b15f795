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
activation (tanh); another activation is refused. The vanilla RNN
(``simple_rnn_scan``) comes with ``SimpleRnn`` (ROADMAP.md A11).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.layers.lstm_kernel import lstm_recurrence

__all__ = ["bidirectional_sum", "lstm_scan"]


def _check_acts(gate_act: str, cell_act: str) -> None:
    if str(gate_act).lower() != "sigmoid" or str(cell_act).lower() != "tanh":
        raise NotImplementedError(
            f"LSTM gate activation {gate_act!r} / cell activation "
            f"{cell_act!r}: the recurrence kernels compute sigmoid gates and "
            "a tanh cell; other activations are not ported yet (ROADMAP.md "
            "A1)")


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
    _check_acts(gate_act, cell_act)
    n, _, t = x.shape
    h = rw.shape[0]
    if h0 is None:
        h0 = x.new_zeros((n, h))
    if c0 is None:
        c0 = x.new_zeros((n, h))
    xt = x.permute(2, 0, 1)                                # [T, N, C]
    zx = (xt.reshape(t * n, -1) @ w).reshape(t, n, 4 * h) + b
    m = None if mask is None else mask.t().to(torch.float32)   # [T, N]
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
