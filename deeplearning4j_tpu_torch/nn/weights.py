"""Weight initialization (the schemes the ported models use).

Counterpart of ``deeplearning4j_tpu/nn/weights.py``, with the same
formulas: ``xavier`` (``sqrt(2 / (fan_in + fan_out))`` times a standard
normal, the transformer's) and ``relu`` (He: ``sqrt(2 / fan_in)`` times
a standard normal, ResNet50's). Draws come from an explicit CPU
``torch.Generator`` seeded by the network, so a seed gives the same
weights on every device; they are NOT the JAX package's draws (different generators),
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
    key = str(scheme).lower()
    if key == "xavier":
        std = math.sqrt(2.0 / (fan_in + fan_out))
    elif key == "relu":
        std = math.sqrt(2.0 / fan_in)
    else:
        raise NotImplementedError(
            f"weight init {scheme!r} is not ported yet (ROADMAP.md A1); "
            f"ported: xavier, relu")
    w = std * torch.randn(tuple(int(s) for s in shape), generator=gen)
    return w.to(device)
