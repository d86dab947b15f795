"""Updaters, learning-rate schedules and gradient normalization.

Counterpart of ``deeplearning4j_tpu/nn/updater.py``: its nine learning
rules (``Sgd``, ``Nesterovs``, ``Adam``, ``AdaMax``, ``Nadam``,
``RmsProp``, ``AdaGrad``, ``AdaDelta``, ``NoOp``), ``schedule_lr`` and
``normalize_gradients``, and their JSON form (:func:`updater_to_dict`,
:func:`updater_from_dict`: the JAX package's ``{"@class": name,
field: value}``). Each rule's state is the JAX package's tree under the
same keys (``m``, ``v``, ``u``, ``t``, ``g2``, ``h``, ``dx2``), so the
archives' ``updater/`` entries carry it either way, and each step is
the JAX formula's operations in the JAX order. As in the JAX package
the updater state is an explicit tree threaded through a pure
``update(grads, state, params) -> (steps, new_state)``; the caller
subtracts the steps. Trees are nested dicts of tensors
(``{vertex: {name: tensor}}``).

``Adam`` is the JAX package's formula, not ``torch.optim.Adam``'s:
epsilon is added to ``sqrt(v)`` and the bias correction is folded into
one factor ``corr = sqrt(1 - beta2^t) / (1 - beta1^t)`` taken in f32, so
the steps agree with the JAX package's. Its step count ``t`` (and
AdaMax's and Nadam's) is a 0-d int32 tensor on the parameters' device,
as the JAX package keeps it, so the non-finite sentinel's select
(``resilience/sentinel.py``) treats it as it treats every other leaf of
the state.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

__all__ = ["AdaDelta", "AdaGrad", "AdaMax", "Adam", "Nadam", "Nesterovs",
           "NoOp", "RmsProp", "Sgd", "UPDATER_REGISTRY", "Updater",
           "normalize_gradients", "schedule_lr", "tree_leaves", "tree_map",
           "updater_from_dict", "updater_to_dict"]


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
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params), "t": _step0(params)}

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


def _step0(params) -> torch.Tensor:
    """A step count of 0: a 0-d int32 tensor on the parameters'
    device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclass
class AdaMax(Updater):
    """Adam's infinity-norm variant as the JAX package computes it: ``u'
    = max(b2 u, |g|)`` and the step ``lr / (1 - b1^t) m' / (u' +
    eps)``. Its state is ``{"m", "u", "t"}``."""

    learning_rate: float = 2e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "u": tree_map(torch.zeros_like, params), "t": _step0(params)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(b2 * u_, torch.abs(g)),
                     state["u"], grads)
        lr_t = lr / (1 - b1 ** t.to(torch.float32))
        steps = tree_map(lambda m_, u_: lr_t * m_ / (u_ + self.epsilon), m, u)
        return steps, {"m": m, "u": u, "t": t}


@dataclass
class Nadam(Updater):
    """Adam with Nesterov momentum as the JAX package computes it: ``mhat
    = b1 m' / (1 - b1^(t+1)) + (1 - b1) g / (1 - b1^t)``, ``vhat = v' /
    (1 - b2^t)``, the step ``lr mhat / (sqrt(vhat) + eps)``. Its state is
    ``{"m", "v", "t"}``."""

    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params), "t": _step0(params)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        t = state["t"] + 1
        b1, b2 = self.beta1, self.beta2
        tf = t.to(torch.float32)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"],
                     grads)
        c1, c1n, c2 = 1 - b1 ** tf, 1 - b1 ** (tf + 1), 1 - b2 ** tf

        def step(m_, v_, g):
            mhat = b1 * m_ / c1n + (1 - b1) * g / c1
            return lr * mhat / (torch.sqrt(v_ / c2) + self.epsilon)

        return tree_map(step, m, v, grads), {"m": m, "v": v, "t": t}


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


@dataclass
class AdaGrad(Updater):
    """AdaGrad as the JAX package computes it: ``h' = h + g^2`` and the
    step ``lr g / (sqrt(h') + eps)``. Its state is ``{"h": tree}``."""

    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"h": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params, lr_scale=1.0):
        lr = self._lr(lr_scale)
        h = tree_map(lambda a, g: a + g * g, state["h"], grads)
        steps = tree_map(lambda g, a: lr * g / (torch.sqrt(a) + self.epsilon),
                         grads, h)
        return steps, {"h": h}


@dataclass
class AdaDelta(Updater):
    """AdaDelta as the JAX package computes it: ``g2' = rho g2 + (1 - rho)
    g^2``, the step ``sqrt(dx2 + eps) / sqrt(g2' + eps) g``, then ``dx2'
    = rho dx2 + (1 - rho) step^2``; the learning rate is unused, as
    there. Its state is ``{"g2", "dx2"}``."""

    learning_rate: float = 1.0
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"g2": tree_map(torch.zeros_like, params),
                "dx2": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params, lr_scale=1.0):
        rho, eps = self.rho, self.epsilon
        g2 = tree_map(lambda a, g: rho * a + (1 - rho) * g * g, state["g2"],
                      grads)
        steps = tree_map(
            lambda g, a, d: torch.sqrt(d + eps) / torch.sqrt(a + eps) * g,
            grads, g2, state["dx2"])
        dx2 = tree_map(lambda d, s: rho * d + (1 - rho) * s * s,
                       state["dx2"], steps)
        return steps, {"g2": g2, "dx2": dx2}


@dataclass
class NoOp(Updater):
    """No update: zero steps, the state unchanged."""

    def update(self, grads, state, params, lr_scale=1.0):
        return tree_map(torch.zeros_like, grads), state


#: the updaters by their JSON name (the class name, and lower case as
#: the JAX package registers them)
UPDATER_REGISTRY: Dict[str, type] = {
    name: cls for c in (Sgd, Nesterovs, Adam, AdaMax, Nadam, RmsProp,
                        AdaGrad, AdaDelta, NoOp)
    for name, cls in ((c.__name__, c), (c.__name__.lower(), c))}


def updater_to_dict(u: Updater) -> dict:
    """The JAX package's JSON form: ``{"@class": name, field: value}``."""
    return {"@class": type(u).__name__,
            **{f.name: getattr(u, f.name) for f in dataclasses.fields(u)}}


def updater_from_dict(d) -> Updater:
    """The inverse of :func:`updater_to_dict` (an :class:`Updater` passes
    through)."""
    if isinstance(d, Updater):
        return d
    d = dict(d)
    cls = UPDATER_REGISTRY[d.pop("@class")]
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
