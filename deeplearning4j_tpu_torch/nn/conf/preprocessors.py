"""Input preprocessors: the shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``, with the
two CNN adapters: ``FeedForwardToCnnPreProcessor`` (the entry transpose
``use_cnn_data_format("NHWC")`` installs: public NCHW in, internal NHWC
out) and ``CnnToFeedForwardPreProcessor`` (flatten in DL4J's NCHW
order), and their JSON form (:func:`preprocessor_to_dict`,
:func:`preprocessor_from_dict`: the JAX package's ``{"@class": name,
field: value}``). The RNN adapters port with the sequential network's
breadth (ROADMAP.md A2).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["CnnToFeedForwardPreProcessor", "FeedForwardToCnnPreProcessor",
           "PREPROCESSOR_REGISTRY", "Preprocessor", "preprocessor_from_dict",
           "preprocessor_to_dict"]


@dataclass
class Preprocessor:
    def apply(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, it: InputType) -> InputType:
        raise NotImplementedError


@dataclass
class CnnToFeedForwardPreProcessor(Preprocessor):
    """``[N, C, H, W]`` to ``[N, C H W]``. Under internal NHWC the
    incoming tensor is ``[N, H, W, C]``: it goes back to NCHW first, so
    the flat feature order stays DL4J's."""

    height: int = 0
    width: int = 0
    channels: int = 0
    data_format: str = "NCHW"

    def apply(self, x, mask=None):
        if self.data_format == "NHWC" and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        return x.reshape(x.shape[0], -1)

    def output_type(self, it):
        return InputType.feed_forward(it.flat_size())


@dataclass
class FeedForwardToCnnPreProcessor(Preprocessor):
    """``[N, C H W]`` (or ``[N, C, H, W]``) to ``[N, C, H, W]``; to
    ``[N, H, W, C]`` under internal NHWC."""

    height: int = 0
    width: int = 0
    channels: int = 0
    data_format: str = "NCHW"

    def apply(self, x, mask=None):
        if x.dim() != 4:
            x = x.reshape(x.shape[0], self.channels, self.height, self.width)
        if self.data_format == "NHWC":
            x = x.permute(0, 2, 3, 1)
        return x

    def output_type(self, it):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


PREPROCESSOR_REGISTRY = {c.__name__: c for c in (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor)}


def preprocessor_to_dict(p: Preprocessor) -> dict:
    """The JAX package's JSON form: ``{"@class": name, field: value}``
    (tuples as lists)."""
    d = {"@class": type(p).__name__}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        d[f.name] = list(v) if isinstance(v, tuple) else v
    return d


def preprocessor_from_dict(d: dict) -> Preprocessor:
    """The inverse of :func:`preprocessor_to_dict`; the preprocessors
    the port does not have are refused."""
    d = dict(d)
    name = d.pop("@class")
    cls = PREPROCESSOR_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"preprocessor {name!r} is not ported yet (ROADMAP.md A2)")
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
