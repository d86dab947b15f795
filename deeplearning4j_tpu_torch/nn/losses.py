"""Loss functions.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``, ported whole: every
loss is a function ``loss(labels, out)`` of per-element scores,
differentiated by autograd, and :func:`score` reduces them to the mean
per-example loss of a pre-activation output.

Masking follows the JAX package: a per-example (or, with time folded
into the batch, per-timestep) mask multiplies the per-example score and
the mean is taken over the unmasked count.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn import activations as _act

__all__ = ["LOSSES", "get", "score"]

_EPS = 1e-7


def _reduce(per_elem: torch.Tensor, mask: Optional[torch.Tensor]):
    """Sum per-element scores to per-example ones, apply the mask, take
    the mean over (unmasked) examples."""
    per_example = per_elem.sum(dim=tuple(range(1, per_elem.dim())))
    if mask is not None:
        m = mask.reshape(per_example.shape).to(per_example.dtype)
        return (per_example * m).sum() / m.sum().clamp_min(1.0)
    return per_example.mean()


def _mse(y, out):
    return (out - y) ** 2


def _l1(y, out):
    return (out - y).abs()


def _xent(y, out):
    out = out.clamp(_EPS, 1.0 - _EPS)
    return -(y * torch.log(out) + (1.0 - y) * torch.log(1.0 - out))


def _mcxent(y, out):
    return -y * torch.log(out.clamp_min(_EPS))


def _kld(y, out):
    return y * (torch.log(y.clamp_min(_EPS)) - torch.log(out.clamp_min(_EPS)))


def _hinge(y, out):
    # labels in {-1, +1}
    return (1.0 - y * out).clamp_min(0.0)


def _squared_hinge(y, out):
    return (1.0 - y * out).clamp_min(0.0) ** 2


def _poisson(y, out):
    return out - y * torch.log(out.clamp_min(_EPS))


def _mape(y, out):
    return 100.0 * ((y - out) / y.abs().clamp_min(_EPS)).abs()


def _msle(y, out):
    return (torch.log1p(out.clamp_min(-1 + _EPS))
            - torch.log1p(y.clamp_min(-1 + _EPS))) ** 2


def _cosine_proximity(y, out):
    yn = y / torch.linalg.norm(y, dim=-1, keepdim=True).clamp_min(_EPS)
    on = out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(_EPS)
    return -yn * on


LOSSES = {
    "mse": _mse,
    "squared_loss": _mse,
    "l1": _l1,
    "mean_absolute_error": _l1,
    "l2": _mse,
    "xent": _xent,
    "binary_crossentropy": _xent,
    "mcxent": _mcxent,
    "negativeloglikelihood": _mcxent,
    "categorical_crossentropy": _mcxent,
    "kl_divergence": _kld,
    "reconstruction_crossentropy": _xent,
    "hinge": _hinge,
    "squared_hinge": _squared_hinge,
    "poisson": _poisson,
    "mean_absolute_percentage_error": _mape,
    "mean_squared_logarithmic_error": _msle,
    "cosine_proximity": _cosine_proximity,
}


def get(name):
    """Resolve a loss by name (case-insensitive), or pass a callable
    through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]


def score(labels: torch.Tensor, preout: torch.Tensor, loss,
          activation="identity", mask: Optional[torch.Tensor] = None):
    """Mean per-example loss of the pre-activation output ``preout``
    (``[batch, features]``).

    softmax + mcxent takes the log-softmax path and sigmoid + xent the
    stable path from logits, as the JAX package does; the rest apply
    the activation and then the loss."""
    lkey = str(loss).lower() if not callable(loss) else None
    akey = str(activation).lower() if not callable(activation) else None
    if lkey in ("mcxent", "negativeloglikelihood") and akey == "softmax":
        per_elem = -labels * torch.log_softmax(preout, dim=-1)
        return _reduce(per_elem, mask)
    if lkey in ("xent", "binary_crossentropy") and akey == "sigmoid":
        per_elem = (preout.clamp_min(0.0) - preout * labels
                    + torch.log1p(torch.exp(-preout.abs())))
        return _reduce(per_elem, mask)
    out = _act.get(activation)(preout)
    return _reduce(get(loss)(labels, out), mask)
