"""Updaters, learning-rate schedules and gradient normalization.

Counterpart of ``deeplearning4j_tpu/nn/updater.py`` for the rules the
ported models use: ``Sgd``, ``Adam``, ``Nesterovs`` (ResNet50's) and
``RmsProp`` (the text LSTM's; the other updaters are ROADMAP.md A1),
``schedule_lr`` and
``normalize_gradients``, and their JSON form (:func:`updater_to_dict`,
:func:`updater_from_dict`: the JAX package's ``{"@class": name,
field: value}``). As in the JAX package the updater state is an explicit tree threaded through a
pure ``update(grads, state, params) -> (steps, new_state)``; the caller
subtracts the steps. Trees are nested dicts of tensors
(``{vertex: {name: tensor}}``).

``Adam`` is the JAX package's formula, not ``torch.optim.Adam``'s:
epsilon is added to ``sqrt(v)`` and the bias correction is folded into
one factor ``corr = sqrt(1 - beta2^t) / (1 - beta1^t)`` taken in f32, so
the steps agree with the JAX package's. Its step count ``t`` is a 0-d
int32 tensor on the parameters' device, as the JAX package keeps it, so
the non-finite sentinel's select (``resilience/sentinel.py``) treats it
as it treats every other leaf of the state.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["Adam", "Nesterovs", "RmsProp", "Sgd", "UPDATER_REGISTRY",
           "Updater", "normalize_gradients", "schedule_lr", "tree_leaves",
           "tree_map", "updater_from_dict", "updater_to_dict"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the trees in ``rest`` have
    ``tree``'s keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of nested dicts, keys sorted at every level (the JAX
    package's pytree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def schedule_lr(base_lr, policy: Optional[str], iteration, *,
                decay_rate=0.0, power=1.0, steps=1.0, max_iter=10000):
    """The scheduled learning rate at ``iteration`` (the policies of the
    JAX package: none, exponential, inverse, poly, sigmoid, step)."""
    if not policy or policy == "none":
        return base_lr
    it = float(iteration)
    p = policy.lower()
    if p == "exponential":
        return base_lr * decay_rate ** it
    if p == "inverse":
        return base_lr / (1.0 + decay_rate * it) ** power
    if p == "poly":
        return base_lr * (1.0 - it / max_iter) ** power
    if p == "sigmoid":
        return base_lr / (1.0 + math.exp(-decay_rate * (it - steps)))
    if p == "step":
        return base_lr * decay_rate ** math.floor(it / steps)
    raise ValueError(f"unknown LR policy {policy}")


@dataclass
class Updater:
    """Base learning rule; ``init_state`` / ``update`` take whole
    trees."""

    learning_rate: float = 1e-3

    def init_state(self, params):
        return {}

    def update(self, grads, state, params, lr_scale=1.0):
        """Return (steps to subtract, new state)."""
        raise NotImplementedError

    def _lr(self, lr_scale):
        return self.learning_rate * lr_scale


@dataclass
class Sgd(Updater):
    learning_rate: float = 0.1

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        return tree_map(lambda g: lr * g, grads), state


@dataclass
class Nesterovs(Updater):
    """Nesterov momentum as the JAX package computes it: ``v' = mu v -
    lr g``, and the lookahead step ``-(mu v' - lr g)`` to subtract."""

    learning_rate: float = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        mu = self.momentum
        v = tree_map(lambda v_, g: mu * v_ - lr * g, state["v"], grads)
        steps = tree_map(lambda v_, g: -(mu * v_ - lr * g), v, grads)
        return steps, {"v": v}


@dataclass
class Adam(Updater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        tf = t.to(torch.float32)
        # lr * corr once (the JAX package's lr * corr * m / ..., whose
        # first product is the same value for every leaf)
        lr_corr = lr * (torch.sqrt(1.0 - b2 ** tf) / (1.0 - b1 ** tf))
        steps = tree_map(
            lambda m_, v_: lr_corr * m_ / (torch.sqrt(v_) + self.epsilon),
            m, v)
        return steps, {"m": m, "v": v, "t": t}


@dataclass
class RmsProp(Updater):
    """RMSProp as the JAX package computes it: ``g2' = d g2 + (1 - d)
    g^2``, and the step ``lr g / sqrt(g2' + eps)`` to subtract (epsilon
    inside the root). Its state is ``{"g2": tree}``."""

    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"g2": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        d = self.rms_decay
        g2 = tree_map(lambda a, g: d * a + (1 - d) * g * g, state["g2"],
                      grads)
        steps = tree_map(lambda g, a: lr * g / torch.sqrt(a + self.epsilon),
                         grads, g2)
        return steps, {"g2": g2}


#: the updaters by their JSON name (the class name, and lower case as
#: the JAX package registers them)
UPDATER_REGISTRY: Dict[str, type] = {
    name: cls for c in (Sgd, Nesterovs, Adam, RmsProp)
    for name, cls in ((c.__name__, c), (c.__name__.lower(), c))}


def updater_to_dict(u: Updater) -> dict:
    """The JAX package's JSON form: ``{"@class": name, field: value}``."""
    return {"@class": type(u).__name__,
            **{f.name: getattr(u, f.name) for f in dataclasses.fields(u)}}


def updater_from_dict(d) -> Updater:
    """The inverse of :func:`updater_to_dict` (an :class:`Updater` passes
    through). The updaters the port does not have are refused."""
    if isinstance(d, Updater):
        return d
    d = dict(d)
    name = d.pop("@class")
    cls = UPDATER_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(
            f"updater {name!r} is not ported yet (ROADMAP.md A1); ported: "
            "Sgd, Nesterovs, Adam, RmsProp")
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def normalize_gradients(grads, method: Optional[str], threshold: float = 1.0):
    """The JAX package's GradientNormalization over a gradient tree: the
    "per gradient" methods take one L2 norm over the whole tree, the
    "per param type" methods one per tensor."""
    if not method or method == "none":
        return grads
    m = method.lower()
    leaves = tree_leaves(grads)

    def global_norm():
        return torch.sqrt(sum((g * g).sum() for g in leaves) + 1e-12)

    if m in ("renormalizel2pergradient", "renormalize_l2_per_gradient"):
        gnorm = global_norm()
        return tree_map(lambda g: g / gnorm, grads)
    if m in ("renormalizel2perparamtype", "renormalize_l2_per_param_type"):
        return tree_map(lambda g: g / torch.sqrt((g * g).sum() + 1e-12),
                        grads)
    if m in ("clipelementwiseabsolutevalue",
             "clip_element_wise_absolute_value"):
        return tree_map(lambda g: g.clamp(-threshold, threshold), grads)
    if m in ("clipl2pergradient", "clip_l2_per_gradient"):
        scale = (threshold / global_norm()).clamp_max(1.0)
        return tree_map(lambda g: g * scale, grads)
    if m in ("clipl2perparamtype", "clip_l2_per_param_type"):
        def clip(g):
            n = torch.sqrt((g * g).sum() + 1e-12)
            return g * (threshold / n).clamp_max(1.0)
        return tree_map(clip, grads)
    raise ValueError(f"unknown gradient normalization {method}")
