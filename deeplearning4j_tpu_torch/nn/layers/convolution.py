"""Convolution, pooling and padding ops (NCHW API, optional NHWC internal
layout).

Counterpart of ``deeplearning4j_tpu/nn/layers/convolution.py``. The JAX
package runs these through ``lax.conv_general_dilated`` and
``lax.reduce_window`` (no Pallas kernel), so here they are PyTorch's own
``F.conv2d`` / ``F.max_pool2d`` / ``F.avg_pool2d``: the unfused
("xla") execution plan. Weights stay ``[O, I, kH, kW]`` whatever the
activation layout; an NHWC tensor is viewed as NCHW (channels-last
strides) for the call and its result viewed back.

ConvolutionMode: ``"truncate"`` (explicit padding, ``out = floor((in +
2p - k) / s) + 1``) and ``"strict"`` (the same, the division exact).
``"same"`` (XLA's asymmetric SAME padding) ports with LeNet and the
breadth layers (ROADMAP.md A2, A11).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["avg_pool2d", "conv2d", "conv_out_size", "max_pool2d",
           "zero_pad2d"]

F = torch.nn.functional


def conv_out_size(in_size: int, k: int, s: int, p: int, d: int,
                  mode: str) -> int:
    eff_k = k + (k - 1) * (d - 1)
    if mode == "same":
        return -(-in_size // s)
    if mode == "strict":
        if (in_size + 2 * p - eff_k) % s != 0:
            raise ValueError(
                f"ConvolutionMode strict: (in={in_size} + 2*p={p} - "
                f"k={eff_k}) not divisible by stride {s}")
        return (in_size + 2 * p - eff_k) // s + 1
    out = (in_size + 2 * p - eff_k) // s + 1
    if out < 1:
        raise ValueError(
            f"Conv/pool output size {out} < 1 (in={in_size}, "
            f"kernel={eff_k}, stride={s}, padding={p}): input too small "
            "for this architecture")
    return out


def _check_mode(mode):
    if mode == "same":
        raise NotImplementedError(
            "ConvolutionMode 'same' is not ported yet (ROADMAP.md A2, "
            "A11); ported: truncate, strict")
    if mode not in ("truncate", "strict"):
        raise ValueError(f"unknown convolution mode {mode!r}")


def _nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, w, b, stride: Sequence[int], padding: Sequence[int],
           dilation: Sequence[int] = (1, 1), mode: str = "truncate",
           data_format: str = "NCHW"):
    """2-D convolution, x ``[N, C, H, W]`` (or ``[N, H, W, C]``), w
    ``[O, I, kH, kW]``."""
    _check_mode(mode)
    y = F.conv2d(_nchw(x, data_format), w, None, tuple(stride),
                 tuple(int(p) for p in padding), tuple(dilation))
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return _back(y, data_format)


def max_pool2d(x, kernel, stride, padding, mode="truncate",
               data_format="NCHW"):
    """Max pooling, padding with -inf (``lax.reduce_window`` with
    ``-inf`` init)."""
    _check_mode(mode)
    y = F.max_pool2d(_nchw(x, data_format), tuple(kernel), tuple(stride),
                     tuple(padding))
    return _back(y, data_format)


def avg_pool2d(x, kernel, stride, padding, mode="truncate",
               data_format="NCHW"):
    """Average pooling over the padded window (padding counts, as the JAX
    package divides the window sum by kh kw)."""
    _check_mode(mode)
    y = F.avg_pool2d(_nchw(x, data_format), tuple(kernel), tuple(stride),
                     tuple(padding), count_include_pad=True)
    return _back(y, data_format)


def zero_pad2d(x, pad: Sequence[int], data_format="NCHW"):
    """Zero padding ``[top, bottom, left, right]``."""
    t, bm, l, r = (int(p) for p in pad)
    if data_format == "NHWC":
        return F.pad(x, (0, 0, l, r, t, bm))
    return F.pad(x, (l, r, t, bm))
