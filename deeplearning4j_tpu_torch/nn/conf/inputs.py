"""Input type shape inference (the recurrent, feed-forward and
convolutional kinds).

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``, same
conventions: feed-forward activations are ``[batch, size]``, recurrent
``[batch, size, timeSeriesLength]`` (DL4J NCW), convolutional ``[batch,
channels, height, width]`` (NCHW at the public boundary; the internal
NHWC layout of ``use_cnn_data_format`` keeps the same type). The
flattened-CNN and 3-D kinds port with the breadth modules (ROADMAP.md
A11). ``to_dict`` / ``from_dict`` are the JAX package's JSON form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["InputType"]


@dataclass(frozen=True)
class InputType:
    kind: str                        # "ff" | "rnn" | "cnn"
    size: Optional[int] = None       # ff/rnn feature size
    timesteps: Optional[int] = None  # rnn sequence length (None = variable)
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=int(size),
                         timesteps=None if timesteps is None
                         else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int,
                      channels: int) -> "InputType":
        return InputType(kind="cnn", channels=int(channels),
                         height=int(height), width=int(width))

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return int(self.size)
        if self.kind == "cnn":
            return int(self.channels) * int(self.height) * int(self.width)
        raise ValueError(f"no flat size for {self}")

    def to_dict(self) -> dict:
        """``{"kind": kind}`` and each size that is set."""
        d = {"kind": self.kind}
        for f in ("size", "timesteps", "channels", "height", "width"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        """The inverse of :meth:`to_dict`; the kinds the port does not
        have (flattened CNN, 3-D) are refused."""
        if d.get("kind") not in ("ff", "rnn", "cnn") or \
                d.get("depth") is not None:
            raise NotImplementedError(
                f"input type {d!r} is not ported yet (ROADMAP.md A11); "
                "ported: ff, rnn, cnn")
        return InputType(**{k: v for k, v in d.items() if k != "depth"})
