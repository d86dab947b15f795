"""Activation functions (the subset the ported models use).

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same names
resolve to the same functions. ``gelu`` is the tanh approximation, as
``jax.nn.gelu`` computes it by default; ``softmax`` runs over the
feature axis (axis 1 of ``[N, F]`` / ``[N, F, T]``); ``sigmoid`` is
the output activation the losses pair with binary cross-entropy. The
rest of the set ports with the breadth modules (ROADMAP.md A1).

Both keep the JAX package's rounding points under the bf16 compute
policy (``tests/test_torch_transformer.py`` pins them bit for bit), so
they are written op by op rather than as ``F.gelu`` / ``torch.softmax``,
which round once from f32.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["ACTIVATIONS", "get"]


def _identity(x):
    return x


@functools.lru_cache(maxsize=None)
def _const(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float (JAX rounds a
    weakly typed constant to its operand's dtype before the op)."""
    return float(torch.tensor(value, dtype=dtype))


def _gelu(x):
    # jax.nn.gelu(approximate=True) op by op: each product and sum
    # rounds to x's dtype
    c = _const(math.sqrt(2.0 / math.pi), x.dtype)
    a = _const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def _softmax(x):
    # jax.nn.softmax op by op: the exponentials round to x's dtype, their
    # sum accumulates in f32 and rounds, then the rounded quotient
    dim = 1 if x.dim() > 1 else -1
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


ACTIVATIONS = {
    "identity": _identity,
    "relu": torch.relu,
    "gelu": _gelu,
    "sigmoid": torch.sigmoid,
    "softmax": _softmax,
}


def get(name):
    """Resolve an activation by name (case-insensitive), or pass a
    callable through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (ROADMAP.md A1); "
            f"ported: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
