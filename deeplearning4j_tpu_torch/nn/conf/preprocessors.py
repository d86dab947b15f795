"""Input preprocessors: the shape adapters between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``, all six:
CNN to feed-forward and back (``FeedForwardToCnnPreProcessor`` is also
the entry transpose ``use_cnn_data_format("NHWC")`` installs: public
NCHW in, internal NHWC out), RNN to feed-forward and back, CNN to RNN
and back, and their JSON form (:func:`preprocessor_to_dict`,
:func:`preprocessor_from_dict`: the JAX package's ``{"@class": name,
field: value}``). Each is a reshape / permute; autograd gives the
backward. Layouts: feed-forward ``[N, F]``, CNN ``[N, C, H, W]``, RNN
``[N, F, T]``. A mask through a preprocessor is refused with the other
masks (ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

__all__ = ["CnnToFeedForwardPreProcessor", "CnnToRnnPreProcessor",
           "FeedForwardToCnnPreProcessor", "FeedForwardToRnnPreProcessor",
           "PREPROCESSOR_REGISTRY", "Preprocessor", "RnnToCnnPreProcessor",
           "RnnToFeedForwardPreProcessor", "preprocessor_from_dict",
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


@dataclass
class RnnToFeedForwardPreProcessor(Preprocessor):
    """``[N, F, T]`` to ``[N T, F]`` (time folded into the batch, row n T
    + t)."""

    def apply(self, x, mask=None):
        n, f, t = x.shape
        return x.permute(0, 2, 1).reshape(n * t, f)

    def output_type(self, it):
        return InputType.feed_forward(it.size)


@dataclass
class FeedForwardToRnnPreProcessor(Preprocessor):
    """``[N T, F]`` to ``[N, F, T]``."""

    timesteps: int = 1

    def apply(self, x, mask=None):
        nt, f = x.shape
        n = nt // self.timesteps
        return x.reshape(n, self.timesteps, f).permute(0, 2, 1)

    def output_type(self, it):
        return InputType.recurrent(it.size, self.timesteps)


@dataclass
class CnnToRnnPreProcessor(Preprocessor):
    """``[N T, C, H, W]`` to ``[N, C H W, T]`` (each example's flattened
    features one step of its sequence; NHWC input goes back to NCHW
    first)."""

    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = 1
    data_format: str = "NCHW"

    def apply(self, x, mask=None):
        if self.data_format == "NHWC" and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        nt = x.shape[0]
        n = nt // self.timesteps
        return x.reshape(nt, -1).reshape(n, self.timesteps, -1) \
            .permute(0, 2, 1)

    def output_type(self, it):
        return InputType.recurrent(it.flat_size(), self.timesteps)


@dataclass
class RnnToCnnPreProcessor(Preprocessor):
    """``[N, F, T]`` to ``[N T, C, H, W]`` (``[N T, H, W, C]`` under
    internal NHWC)."""

    height: int = 0
    width: int = 0
    channels: int = 0
    data_format: str = "NCHW"

    def apply(self, x, mask=None):
        n, f, t = x.shape
        y = x.permute(0, 2, 1).reshape(n * t, self.channels, self.height,
                                       self.width)
        if self.data_format == "NHWC":
            y = y.permute(0, 2, 3, 1)
        return y

    def output_type(self, it):
        return InputType.convolutional(self.height, self.width,
                                       self.channels)


PREPROCESSOR_REGISTRY = {c.__name__: c for c in (
    CnnToFeedForwardPreProcessor, FeedForwardToCnnPreProcessor,
    RnnToFeedForwardPreProcessor, FeedForwardToRnnPreProcessor,
    CnnToRnnPreProcessor, RnnToCnnPreProcessor)}


def preprocessor_to_dict(p: Preprocessor) -> dict:
    """The JAX package's JSON form: ``{"@class": name, field: value}``
    (tuples as lists)."""
    d = {"@class": type(p).__name__}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        d[f.name] = list(v) if isinstance(v, tuple) else v
    return d


def preprocessor_from_dict(d: dict) -> Preprocessor:
    """The inverse of :func:`preprocessor_to_dict`."""
    d = dict(d)
    cls = PREPROCESSOR_REGISTRY[d.pop("@class")]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
