"""Activation functions.

Counterpart of ``deeplearning4j_tpu/nn/activations.py``: the same 20
names resolve to the same functions, ``get`` takes the parameterized
form ``"name(0.3)"`` (it binds the function's second parameter: the
leaky relu's alpha, the thresholded relu's theta) and ``register`` adds
a custom one. ``gelu`` is the tanh approximation, as ``jax.nn.gelu``
computes it by default; ``softmax`` runs over the feature axis (axis 1
of ``[N, F]`` / ``[N, F, T]``).

Every function keeps the JAX package's rounding points under the bf16
compute policy: it is written as its JAX twin's ops in the JAX order,
each op rounding to the input's dtype, and each Python constant rounded
to that dtype first, as JAX rounds a weakly typed constant to its
operand's dtype (``tests/test_torch_numerics.py`` pins them op by op,
and ``tests/test_torch_transformer.py`` gelu and softmax in the
transformer). So there is no ``F.gelu``, ``torch.softmax``,
``F.softplus``, ``F.elu`` or ``torch.sigmoid`` here: each rounds once
from f32, where XLA's logistic is ``1 / (1 + exp(-x))``, three
roundings (its gradient is JAX's, ``g y (1 - y)``).
"""

from __future__ import annotations

import functools
import math
import re

import torch

__all__ = ["ACTIVATIONS", "get", "register"]


@functools.lru_cache(maxsize=None)
def _const(value, dtype):
    """``value`` rounded to ``dtype``, as a Python float (JAX rounds a
    weakly typed constant to its operand's dtype before the op)."""
    return float(torch.tensor(value, dtype=dtype))


def _identity(x):
    return x


class _Logistic(torch.autograd.Function):
    """XLA's logistic, ``1 / (1 + exp(-x))`` op by op, with JAX's
    gradient ``g y (1 - y)`` (finite where exp(-x) overflows)."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def _sigmoid(x):
    return _Logistic.apply(x)


def _cube(x):
    # x ** 3 is lax.integer_pow: x * (x * x), each product rounded
    return x * (x * x)


def _elu(x, alpha=1.0):
    # jax.nn.elu: where(x > 0, x, alpha * expm1(where(x > 0, 0, x)))
    pos = x > 0
    neg = torch.where(pos, torch.zeros_like(x), x)
    return torch.where(pos, x, _const(alpha, x.dtype) * torch.expm1(neg))


def _hardsigmoid(x):
    y = _const(0.2, x.dtype) * x + _const(0.5, x.dtype)
    return torch.clamp(y, 0.0, 1.0)


def _hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def _leakyrelu(x, alpha=0.01):
    return torch.where(x >= 0, x, _const(alpha, x.dtype) * x)


def _rationaltanh(x):
    # 1.7159 tanh(2x / 3) approximated rationally (ND4J's
    # ActivationRationalTanh), op by op as the JAX twin: ax ** 4 is
    # (ax * ax) * (ax * ax)
    d = x.dtype
    ax = torch.abs(_const(2.0, d) * x / _const(3.0, d))
    ax2 = ax * ax
    den = _const(1.0, d) + ax + ax2 + _const(1.41645, d) * (ax2 * ax2)
    approx = torch.sign(x) * (_const(1.0, d) - _const(1.0, d) / den)
    return _const(1.7159, d) * approx


def _rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0): where(isnan(x), x, max(x, 0) +
    # log1p(exp(-|x|)))
    y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, y)


def _softsign(x):
    return x / (_const(1.0, x.dtype) + torch.abs(x))


#: jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def _selu(x):
    return _const(_SELU_SCALE, x.dtype) * _elu(x, _SELU_ALPHA)


def _swish(x):
    return x * _sigmoid(x)


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


def _thresholdedrelu(x, theta=1.0):
    return torch.where(x > _const(theta, x.dtype), x, torch.zeros_like(x))


ACTIVATIONS = {
    "identity": _identity,
    "linear": _identity,
    "cube": _cube,
    "elu": _elu,
    "hardsigmoid": _hardsigmoid,
    "hardtanh": _hardtanh,
    "leakyrelu": _leakyrelu,
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": _rectifiedtanh,
    "relu": torch.relu,
    "relu6": _relu6,
    "sigmoid": _sigmoid,
    "softmax": _softmax,
    "softplus": _softplus,
    "softsign": _softsign,
    "tanh": torch.tanh,
    "selu": _selu,
    "swish": _swish,
    "gelu": _gelu,
    "thresholdedrelu": _thresholdedrelu,
}


def register(name: str, fn) -> None:
    """Register a custom activation under ``name``."""
    ACTIVATIONS[name.lower()] = fn


def get(name):
    """Resolve an activation by name (case-insensitive), or pass a
    callable through. ``"name(0.3)"`` binds the function's second
    parameter (the leaky relu's alpha, the thresholded relu's theta)."""
    if callable(name):
        return name
    key = str(name).lower()
    m = re.fullmatch(r"(\w+)\(([-+0-9.e]+)\)", key)
    if m:
        base, param = m.group(1), float(m.group(2))
        if base not in ACTIVATIONS:
            raise ValueError(f"Unknown activation '{base}'")
        fn = ACTIVATIONS[base]
        return lambda x: fn(x, param)
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]
