"""Dropout variants and weight noise.

Counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``: the input
dropouts (``Dropout``, ``AlphaDropout``, ``GaussianDropout``,
``GaussianNoise``) and the weight noises (``DropConnect``,
``WeightNoise``), their JSON (``to_dict``, :func:`dropout_from_dict`,
:func:`weight_noise_from_dict`: the JAX package's ``{"@dropout": name,
field: value}`` / ``{"@weight_noise": ...}``). A layer's ``dropout``
field takes the DL4J float shorthand or one of the input dropouts; its
``weight_noise`` one of the weight noises. ``p`` is the RETAIN
probability (DL4J's semantics), and a layer's ``dropout`` of 0.0 turns
dropout off.

Each formula is the JAX package's, op for op, with its constants
rounded to the operand's dtype as JAX rounds a weakly typed constant.
The random draws take an explicit ``torch.Generator`` (the network's
training generator, split per layer: ``nn/network_base.py``) through
:func:`bernoulli` and :func:`normal`; they are not the JAX package's
draws, so the tests inject the same masks into both. Two departures,
under the bf16 compute policy only: the JAX package's Gaussian draws
are f32, and adding or multiplying them promotes a bf16 activation or
weight to f32; the port rounds the result back to the operand's dtype,
so the layer after it (and its kernels) takes one dtype.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from deeplearning4j_tpu_torch.nn.activations import _const

__all__ = ["AlphaDropout", "DropConnect", "Dropout", "GaussianDropout",
           "GaussianNoise", "IDropout", "IWeightNoise", "WeightNoise",
           "bernoulli", "dropout_from_dict", "inverted_dropout", "normal",
           "weight_noise_from_dict"]


def bernoulli(p: float, like: torch.Tensor, gen) -> torch.Tensor:
    """A boolean mask the shape of ``like``, each element True with
    probability ``p``, drawn from ``gen`` on ``like``'s device."""
    return torch.rand(like.shape, generator=gen, device=like.device) < p


def normal(like: torch.Tensor, gen) -> torch.Tensor:
    """Standard normal f32 draws the shape of ``like`` (the JAX
    package's ``jax.random.normal`` default dtype)."""
    return torch.randn(like.shape, generator=gen, device=like.device,
                       dtype=torch.float32)


def inverted_dropout(x: torch.Tensor, keep: torch.Tensor,
                     p: float) -> torch.Tensor:
    """``where(keep, x / p, 0)``: inverted dropout with retain
    probability ``p`` under the mask ``keep``."""
    return torch.where(keep, x / _const(p, x.dtype), torch.zeros_like(x))


# ---------------------------------------------------------------------
# input dropout
# ---------------------------------------------------------------------
@dataclass
class IDropout:
    def apply_dropout(self, x, gen):
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@dropout": type(self).__name__,
                **{f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}}


@dataclass
class Dropout(IDropout):
    """Inverted dropout; ``p`` is the retain probability."""

    p: float = 0.5

    def apply_dropout(self, x, gen):
        return inverted_dropout(x, bernoulli(self.p, x, gen), self.p)


@dataclass
class AlphaDropout(IDropout):
    """SELU-preserving dropout (Klambauer et al.): a dropped unit is set
    to alpha' = -lambda alpha, then everything is affine-corrected so a
    SELU activation's mean and variance are kept. ``p`` is the retain
    probability."""

    p: float = 0.5
    #: SELU's constants (DL4J's AlphaDropout defaults)
    ALPHA = 1.6732632423543772
    LAMBDA = 1.0507009873554805

    def apply_dropout(self, x, gen):
        ap = -self.LAMBDA * self.ALPHA
        p = self.p
        a = (p + ap * ap * p * (1 - p)) ** -0.5
        b = -a * (1 - p) * ap
        keep = bernoulli(p, x, gen)
        d = x.dtype
        return _const(a, d) * torch.where(keep, x, _const(ap, d)) + \
            _const(b, d)


@dataclass
class GaussianDropout(IDropout):
    """Multiplicative Gaussian noise ``x (1 + s N(0, 1))``, ``s =
    sqrt(rate / (1 - rate))``."""

    rate: float = 0.5

    def apply_dropout(self, x, gen):
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return (x * (1.0 + std * normal(x, gen))).to(x.dtype)


@dataclass
class GaussianNoise(IDropout):
    """Additive Gaussian noise ``x + stddev N(0, 1)``."""

    stddev: float = 0.1

    def apply_dropout(self, x, gen):
        return (x + self.stddev * normal(x, gen)).to(x.dtype)


# ---------------------------------------------------------------------
# weight noise
# ---------------------------------------------------------------------
@dataclass
class IWeightNoise:
    def apply_to_params(self, params: dict, gen) -> dict:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@weight_noise": type(self).__name__,
                **{f.name: getattr(self, f.name)
                   for f in dataclasses.fields(self)}}

    def _noisy(self, params, gen, fn):
        """``fn(v)`` over the parameters in name order, the biases (names
        starting with ``b``) left as they are unless
        ``apply_to_biases``."""
        out = {}
        for k, v in sorted(params.items()):
            skip = k.startswith("b") and not self.apply_to_biases
            out[k] = v if skip else fn(v)
        return out


@dataclass
class DropConnect(IWeightNoise):
    """Drop individual weights in training; ``p`` is the retain
    probability. Biases are left intact unless ``apply_to_biases``."""

    p: float = 0.5
    apply_to_biases: bool = False

    def apply_to_params(self, params, gen):
        return self._noisy(params, gen, lambda v: inverted_dropout(
            v, bernoulli(self.p, v, gen), self.p))


@dataclass
class WeightNoise(IWeightNoise):
    """Additive (``v + s N(0, 1)``) or multiplicative (``v (1 + s N(0,
    1))``) Gaussian noise on the weights."""

    stddev: float = 0.01
    additive: bool = True
    apply_to_biases: bool = False

    def apply_to_params(self, params, gen):
        def noisy(v):
            noise = self.stddev * normal(v, gen)
            out = v + noise if self.additive else v * (1.0 + noise)
            return out.to(v.dtype)
        return self._noisy(params, gen, noisy)


_DROPOUT_REGISTRY = {c.__name__: c for c in
                     (Dropout, AlphaDropout, GaussianDropout, GaussianNoise)}
_NOISE_REGISTRY = {c.__name__: c for c in (DropConnect, WeightNoise)}


def dropout_from_dict(d: dict) -> IDropout:
    """The inverse of :meth:`IDropout.to_dict`."""
    cls = _DROPOUT_REGISTRY[d["@dropout"]]
    return cls(**{k: v for k, v in d.items() if not k.startswith("@")})


def weight_noise_from_dict(d: dict) -> IWeightNoise:
    """The inverse of :meth:`IWeightNoise.to_dict`."""
    cls = _NOISE_REGISTRY[d["@weight_noise"]]
    return cls(**{k: v for k, v in d.items() if not k.startswith("@")})
