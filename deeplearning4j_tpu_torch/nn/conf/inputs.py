"""Input type shape inference (the recurrent kind).

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``, same
convention: recurrent activations are ``[batch, size,
timeSeriesLength]`` (DL4J NCW). The feed-forward and convolutional
kinds port with the slices that use them (ROADMAP.md A2, A3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["InputType"]


@dataclass(frozen=True)
class InputType:
    kind: str                        # "rnn"
    size: Optional[int] = None       # feature size
    timesteps: Optional[int] = None  # rnn sequence length (None = variable)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=int(size),
                         timesteps=None if timesteps is None
                         else int(timesteps))
