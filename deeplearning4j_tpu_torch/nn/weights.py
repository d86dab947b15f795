"""Weight initialization (the scheme the ported layers use).

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same fan-in /
fan-out formula. Draws come from an explicit CPU ``torch.Generator``
seeded by the network, so a seed gives the same weights on every
device; they are NOT the JAX package's draws (different generators),
so cross-package tests carry parameters across with
``util/convert.params_from_numpy`` instead of sharing a seed. The other
schemes port with the layers that use them (ROADMAP.md A1).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["init_weights"]


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme: str, device) -> torch.Tensor:
    """A float32 weight tensor of the named scheme, drawn from ``gen``
    on the CPU and moved to ``device``."""
    if str(scheme).lower() != "xavier":
        raise NotImplementedError(
            f"weight init {scheme!r} is not ported yet (ROADMAP.md A1); "
            f"ported: xavier")
    std = math.sqrt(2.0 / (fan_in + fan_out))
    w = std * torch.randn(tuple(int(s) for s in shape), generator=gen)
    return w.to(device)
