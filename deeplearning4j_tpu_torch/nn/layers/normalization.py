"""Batch normalization.

Counterpart of ``deeplearning4j_tpu/nn/layers/normalization.py``
``batch_norm``, with the JAX package's rounding points: the batch
statistics of training accumulate in f32 (one pass, ``E[x^2] -
mean^2`` clamped at 0); the normalization itself runs op by op in x's
dtype (``inv = rsqrt(var + eps)`` rounded to it, then ``(x - mean)
inv``, then ``* gamma + beta``), so under bf16 each op rounds as the JAX
forward's does. The running statistics update as :func:`decayed` says.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["batch_norm", "decayed"]


def decayed(old, new, decay: float):
    """``decay * old + (1 - decay) * new`` with JAX's rounding. There
    ``decay`` is a weakly typed Python float, so it takes old's dtype: in
    bf16 it rounds (0.9 to 0.8984375) and the product rounds in bf16,
    where a PyTorch bf16 tensor times a Python float would multiply by
    the unrounded 0.9 in f32 and round once. The f32 batch term then
    promotes the sum to f32. The rounded decay is filled on the device
    (no host copy, so the step can be captured in a CUDA graph)."""
    return old * torch.full((), decay, dtype=old.dtype, device=old.device) \
        + (1.0 - decay) * new


def batch_norm(x, gamma, beta, running_mean, running_var, train: bool,
               eps: float = 1e-5, decay: float = 0.9,
               channel_axis: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch normalization over every axis but ``channel_axis`` (1 for
    ``[N, F]`` and NCHW, 3 for internal NHWC). Returns ``(y, new running
    mean, new running var)``; the running statistics update as ``decay
    old + (1 - decay) batch`` in training and stay as they are in
    inference."""
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    bshape = [1] * x.dim()
    bshape[channel_axis] = x.shape[channel_axis]
    if train:
        xf = x if x.dtype == torch.float64 else x.float()
        mean = xf.mean(dim=axes)
        var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
        new_mean = decayed(running_mean, mean, decay)
        new_var = decayed(running_var, var, decay)
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps).to(x.dtype)
    y = (x - mean.to(x.dtype).reshape(bshape)) * inv.reshape(bshape)
    y = y * gamma.reshape(bshape) + beta.reshape(bshape)
    return y, new_mean, new_var
