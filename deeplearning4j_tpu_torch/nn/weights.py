"""Weight initialization.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the same 22
schemes (``WEIGHT_INITS``) with the same fan-in / fan-out formulas, and
``distribution`` with the same ``dist`` dicts (``normal`` /
``gaussian``, ``uniform``, ``binomial``, ``constant``,
``truncated_normal``). Draws come from an explicit CPU
``torch.Generator`` seeded by the network, so a seed gives the same
weights on every device; they are NOT the JAX package's draws
(different generators), so cross-package tests carry parameters across
with ``util/convert.params_from_numpy`` instead of sharing a seed. A
truncated normal is cut at two standard deviations, as
``jax.random.truncated_normal(-2, 2)``: by inverting the normal CDF over
the uniform draws between the cut's two probabilities.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["WEIGHT_INITS", "init_weights"]

WEIGHT_INITS = (
    "zero",
    "ones",
    "uniform",
    "sigmoid_uniform",
    "xavier",
    "xavier_uniform",
    "xavier_fan_in",
    "xavier_legacy",
    "relu",
    "relu_uniform",
    "lecun_normal",
    "lecun_uniform",
    "normal",
    "truncated_normal",
    "var_scaling_normal_fan_in",
    "var_scaling_normal_fan_out",
    "var_scaling_normal_fan_avg",
    "var_scaling_uniform_fan_in",
    "var_scaling_uniform_fan_out",
    "var_scaling_uniform_fan_avg",
    "distribution",
    "identity",
)


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen)


def _truncated_normal(gen, shape, lo=-2.0, hi=2.0):
    """A standard normal cut to [lo, hi]."""
    a, b = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (lo, hi))
    u = _uniform(gen, shape, a, b).double()
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return z.clamp(lo, hi).float()


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme: str, device,
                 distribution: Optional[dict] = None) -> torch.Tensor:
    """A float32 weight tensor of the named scheme (``distribution``: the
    ``dist`` dict of the scheme ``"distribution"``), drawn from ``gen``
    on the CPU and moved to ``device``. ``fan_in`` / ``fan_out`` as the
    JAX package's: a dense ``[n_in, n_out]`` has ``n_in`` / ``n_out``, a
    conv kernel its channels times its taps."""
    key = str(scheme).lower()
    shape = tuple(int(s) for s in shape)
    return _draw(gen, shape, fan_in, fan_out, key, distribution).to(device)


def _draw(gen, shape, fan_in, fan_out, scheme, distribution):
    if scheme == "zero":
        return torch.zeros(shape)
    if scheme == "ones":
        return torch.ones(shape)
    if scheme == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("identity init requires a square 2-D shape")
        return torch.eye(shape[0])
    if scheme == "uniform":
        a = 1.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -a, a)
    if scheme == "sigmoid_uniform":
        r = 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -r, r)
    if scheme == "xavier":
        return math.sqrt(2.0 / (fan_in + fan_out)) * _normal(gen, shape)
    if scheme == "xavier_uniform":
        s = math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -s, s)
    if scheme in ("xavier_fan_in", "lecun_normal", "normal"):
        return _normal(gen, shape) / math.sqrt(fan_in)
    if scheme == "xavier_legacy":
        return math.sqrt(1.0 / (fan_in + fan_out)) * _normal(gen, shape)
    if scheme == "relu":
        return math.sqrt(2.0 / fan_in) * _normal(gen, shape)
    if scheme == "relu_uniform":
        u = math.sqrt(6.0 / fan_in)
        return _uniform(gen, shape, -u, u)
    if scheme == "lecun_uniform":
        b = 3.0 / math.sqrt(fan_in)
        return _uniform(gen, shape, -b, b)
    if scheme == "truncated_normal":
        return _truncated_normal(gen, shape) / math.sqrt(fan_in)
    if scheme.startswith("var_scaling"):
        if scheme.endswith("fan_in"):
            denom = fan_in
        elif scheme.endswith("fan_out"):
            denom = fan_out
        else:
            denom = 0.5 * (fan_in + fan_out)
        if "normal" in scheme:
            return _truncated_normal(gen, shape) * math.sqrt(1.0 / denom)
        lim = math.sqrt(3.0 / denom)
        return _uniform(gen, shape, -lim, lim)
    if scheme == "distribution":
        return _sample_distribution(gen, shape, distribution or {})
    raise ValueError(f"Unknown weight init scheme '{scheme}'")


def _sample_distribution(gen, shape, dist: dict):
    """A draw from a ``dist`` dict (the JAX package's ``type`` names and
    fields, with its defaults)."""
    kind = str(dist.get("type", "normal")).lower()
    if kind in ("normal", "gaussian"):
        mean, std = float(dist.get("mean", 0.0)), float(dist.get("std", 1.0))
        return mean + std * _normal(gen, shape)
    if kind == "uniform":
        return _uniform(gen, shape, float(dist.get("lower", -1.0)),
                        float(dist.get("upper", 1.0)))
    if kind == "binomial":
        n = int(dist.get("trials", 1))
        p = float(dist.get("probability", 0.5))
        out = torch.zeros(shape)
        for _ in range(n):
            out = out + (torch.rand(shape, generator=gen) < p).float()
        return out
    if kind == "constant":
        return torch.full(shape, float(dist.get("value", 0.0)))
    if kind in ("truncated_normal", "truncatednormal"):
        mean, std = float(dist.get("mean", 0.0)), float(dist.get("std", 1.0))
        return mean + std * _truncated_normal(gen, shape)
    raise ValueError(f"Unknown distribution type '{kind}'")
