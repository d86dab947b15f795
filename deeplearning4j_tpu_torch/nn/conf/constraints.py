"""Weight constraints, projected after each parameter update.

Counterpart of ``deeplearning4j_tpu/nn/conf/constraints.py``:
``MaxNormConstraint``, ``MinMaxNormConstraint``, ``NonNegativeConstraint``
and ``UnitNormConstraint``, their JSON (``to_dict``,
:func:`constraint_from_dict`: ``{"@constraint": name, field: value}``,
``dimensions`` as a list) and :func:`apply_constraints`. A layer's
``constraints`` list reaches its parameters named otherwise than ``b*``
(the weights; biases with ``apply_to_biases``), each norm taken over
``dimensions`` (DL4J's default for a dense weight: the input axis 0).
The sequential network projects them after the updater's step, in all
its step paths, before the non-finite sentinel's select, as the JAX
``MultiLayerNetwork`` does; the JAX ``ComputationGraph`` applies none,
and neither does the port's graph.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["LayerConstraint", "MaxNormConstraint", "MinMaxNormConstraint",
           "NonNegativeConstraint", "UnitNormConstraint",
           "apply_constraints", "constraint_from_dict"]


@dataclass
class LayerConstraint:
    """Base: ``dimensions`` are the axes the norm is taken over."""

    dimensions: Tuple[int, ...] = (0,)
    apply_to_weights: bool = True
    apply_to_biases: bool = False

    def applies_to(self, param_name: str) -> bool:
        if param_name.startswith("b"):
            return self.apply_to_biases
        return self.apply_to_weights

    def apply(self, w):
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"@constraint": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    def _norm(self, w):
        dims = tuple(d for d in self.dimensions if d < w.dim()) or (0,)
        return torch.sqrt((w * w).sum(dim=dims, keepdim=True) + 1e-12)


@dataclass
class MaxNormConstraint(LayerConstraint):
    """Rescale the columns whose norm exceeds ``max_norm``."""

    max_norm: float = 1.0

    def apply(self, w):
        return w * torch.clamp_max(self.max_norm / self._norm(w), 1.0)


@dataclass
class MinMaxNormConstraint(LayerConstraint):
    """Move the norms into [min_norm, max_norm] at ``rate``."""

    min_norm: float = 0.0
    max_norm: float = 1.0
    rate: float = 1.0

    def apply(self, w):
        n = self._norm(w)
        target = w * (torch.clamp(n, self.min_norm, self.max_norm) / n)
        return w + self.rate * (target - w)


@dataclass
class NonNegativeConstraint(LayerConstraint):
    """Project the weights onto >= 0."""

    def apply(self, w):
        return torch.clamp_min(w, 0.0)


@dataclass
class UnitNormConstraint(LayerConstraint):
    """Normalize to unit norm."""

    def apply(self, w):
        return w / self._norm(w)


_CONSTRAINT_REGISTRY = {c.__name__: c for c in
                        (MaxNormConstraint, MinMaxNormConstraint,
                         NonNegativeConstraint, UnitNormConstraint)}


def constraint_from_dict(d: dict) -> LayerConstraint:
    """The inverse of :meth:`LayerConstraint.to_dict`."""
    cls = _CONSTRAINT_REGISTRY[d["@constraint"]]
    return cls(**{k: (tuple(v) if k == "dimensions" else v)
                  for k, v in d.items() if not k.startswith("@")})


def apply_constraints(layer_confs, params: dict) -> dict:
    """Each layer's constraints over its parameter dict: ``params`` maps a
    layer key to ``{name: tensor}``; ``layer_confs`` is the layer list
    (keys its indices) or a dict by key. Returns a new tree."""
    out = dict(params)
    for key, sub in params.items():
        try:
            lconf = layer_confs[int(key)] if isinstance(layer_confs, list) \
                else layer_confs.get(key)
        except (ValueError, KeyError, IndexError):
            lconf = None
        cons = getattr(lconf, "constraints", None)
        if not cons or not isinstance(sub, dict):
            continue
        new_sub = dict(sub)
        for c in cons:
            for pname, w in new_sub.items():
                if c.applies_to(pname) and w.dim() >= 1:
                    new_sub[pname] = c.apply(w)
        out[key] = new_sub
    return out
