"""Shared compute-dtype policy.

Counterpart of ``deeplearning4j_tpu/nn/compute.py``, with the same two
rounding points:

- ``bf16_cast``: under ``conf.dtype = "bfloat16"`` params and inputs are
  cast to bf16 before the forward (once per parameter tree for
  inference, inside the differentiated loss on every training step);
  matrix products then run on bf16 operands with f32 accumulation.
- ``f32_head``: public outputs (``output`` / ``rnn_time_step``) promote
  sub-f32 floats back to f32; f32 and f64 pass through.
"""

from __future__ import annotations

import torch

__all__ = ["bf16_cast", "bf16_cast_tree", "f32_head"]


def bf16_cast(t: torch.Tensor) -> torch.Tensor:
    """Cast one floating tensor to bfloat16 (non-floats untouched)."""
    return t.to(torch.bfloat16) if t.is_floating_point() else t


def bf16_cast_tree(tree):
    """bf16-cast every floating tensor of a ``{vertex: {name: tensor}}``
    parameter tree."""
    return {n: {k: bf16_cast(v) for k, v in p.items()}
            for n, p in tree.items()}


def f32_head(t: torch.Tensor) -> torch.Tensor:
    """Promote a sub-f32 floating output to f32 at the public
    boundary."""
    if t.is_floating_point() and t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t
