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
2p - k) / s) + 1``), ``"strict"`` (the same, the division exact) and
``"same"`` (``out = ceil(in / s)``, XLA's asymmetric SAME padding: the
total ``max((out - 1) s + (k - 1) d + 1 - in, 0)``, ``total // 2`` low
and the rest high, applied as an explicit ``F.pad`` before a padding-0
call, since PyTorch's ``padding="same"`` is symmetric and for stride 1
only). A max pool pads with -inf; a SAME average pool divides each
window's sum by its count of real (unpadded) elements, as the JAX
package does whatever ``count_include_pad`` says.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["avg_pool2d", "conv1d", "conv2d", "conv_out_size", "max_pool2d",
           "same_pads", "zero_pad2d"]

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


def same_pads(in_size: int, k: int, s: int, d: int = 1):
    """XLA's SAME padding of one spatial axis: (low, high)."""
    out = -(-in_size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - in_size, 0)
    return total // 2, total - total // 2


def _check_mode(mode):
    if mode not in ("truncate", "strict", "same"):
        raise ValueError(f"unknown convolution mode {mode!r}")


def _pad_same(x, kernel, stride, dilation=(1, 1), value=0.0):
    """NCHW ``x`` padded for SAME windows (``value`` in the pads)."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2 + i], int(kernel[i]),
                                    int(stride[i]), int(dilation[i]))
                          for i in range(2))
    if not (hl or hh or wl or wh):
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


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
    x = _nchw(x, data_format)
    if mode == "same":
        x = _pad_same(x, w.shape[2:], stride, dilation)
        padding = (0, 0)
    y = F.conv2d(x, w, None, tuple(stride),
                 tuple(int(p) for p in padding), tuple(dilation))
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return _back(y, data_format)


def max_pool2d(x, kernel, stride, padding, mode="truncate",
               data_format="NCHW"):
    """Max pooling, padding with -inf (``lax.reduce_window`` with
    ``-inf`` init)."""
    _check_mode(mode)
    x = _nchw(x, data_format)
    if mode == "same":
        x = _pad_same(x, kernel, stride, value=float("-inf"))
        padding = (0, 0)
    y = F.max_pool2d(x, tuple(kernel), tuple(stride), tuple(padding))
    return _back(y, data_format)


def avg_pool2d(x, kernel, stride, padding, mode="truncate",
               data_format="NCHW"):
    """Average pooling: the window sum over kh kw, explicit padding
    counted (the JAX package's ``count_include_pad`` default); under
    SAME over the window's count of real elements, as there."""
    _check_mode(mode)
    x = _nchw(x, data_format)
    k, st = tuple(kernel), tuple(stride)
    if mode != "same":
        y = F.avg_pool2d(x, k, st, tuple(padding), count_include_pad=True)
        return _back(y, data_format)
    ones = _pad_same(torch.ones_like(x[:1, :1]), k, st)
    summed = F.avg_pool2d(_pad_same(x, k, st), k, st, divisor_override=1)
    counts = F.avg_pool2d(ones, k, st, divisor_override=1)
    return _back(summed / counts, data_format)


def conv1d(x, w, b, stride: int, padding: int, dilation: int = 1,
           mode: str = "truncate"):
    """1-D convolution over ``[N, C, W]``, w ``[O, I, k]`` (SAME as for
    2-D)."""
    _check_mode(mode)
    if mode == "same":
        lo, hi = same_pads(x.shape[2], w.shape[2], int(stride),
                           int(dilation))
        x = F.pad(x, (lo, hi))
        padding = 0
    y = F.conv1d(x, w, None, int(stride), int(padding), int(dilation))
    if b is not None:
        y = y + b.reshape(1, -1, 1)
    return y


def zero_pad2d(x, pad: Sequence[int], data_format="NCHW"):
    """Zero padding ``[top, bottom, left, right]``."""
    t, bm, l, r = (int(p) for p in pad)
    if data_format == "NHWC":
        return F.pad(x, (0, 0, l, r, t, bm))
    return F.pad(x, (l, r, t, bm))
