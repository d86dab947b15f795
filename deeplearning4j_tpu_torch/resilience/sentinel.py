"""The non-finite sentinel: a training step whose loss or gradients are
not finite leaves the model as it was.

Counterpart of ``deeplearning4j_tpu/resilience/sentinel.py``. One NaN
or Inf batch (a bad input, a bf16 overflow) would otherwise poison every
parameter for good. The test runs on the device, over the loss and the
raw gradients:

    ok  = isfinite(loss) & all(isfinite(g) for g in raw gradients)
    p'  = where(ok, p - step, p)        # the parameters
    u'  = where(ok, u_next, u)          # the updater state (Adam's t too)
    s'  = where(ok, s_next, s)          # the layer state (BN, RNN carries)

The gradients are tested before gradient normalization, so clipping
cannot hide an Inf by rescaling it. On a good step the result is
bit-equal to the step without the sentinel; on a bad one the parameters,
the updater state and the layer state are bit-equal to their values
before it (a state leaf the step created, such as the first tBPTT
chunk's h / c, falls back to zeros).

The JAX package selects on the device inside its jitted step. The port's
step (``nn/network_base.py`` ``_step``) reads ``ok`` on the host once,
after the update is queued, and runs :func:`guard_updates` only on a bad
step: its ``fit`` copies each batch from pageable host memory, which
already waits for the previous step, so the read adds no wait of its
own, where a select over every leaf on every step cost several
milliseconds of host time (PERF.md, §6).

Each step's flag is counted on the model's :class:`SentinelAccounting`
(``model._sentinel_accounting``): ``total_steps``, ``bad_steps``,
``skipped_updates`` and ``consecutive_bad``. (The JAX package queues
its device flags and settles them at the end of ``fit``; the port has
read its flag already.) The JAX package also publishes these counts to
its metrics registry; the port has no registry yet (ROADMAP.md A5).

Policies (:func:`set_default_nonfinite_policy`, or a model's
``nonfinite_policy``): ``"skip"`` (the default) keeps a bad step from
changing anything, ``"record"`` counts bad steps but applies them,
``"off"`` runs the step without the sentinel and without accounting.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deeplearning4j_tpu_torch.nn.updater import tree_leaves

POLICIES = ("skip", "record", "off")

_DEFAULT_POLICY = "skip"

_MISSING = object()

__all__ = ["POLICIES", "SentinelAccounting", "accounting_for",
           "effective_policy", "guard_updates", "record_step_flag",
           "set_default_nonfinite_policy", "tree_finite", "where_finite"]


def set_default_nonfinite_policy(policy: str) -> str:
    """Set the process-wide default policy; returns the previous one."""
    global _DEFAULT_POLICY
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    prev, _DEFAULT_POLICY = _DEFAULT_POLICY, policy
    return prev


def effective_policy(model=None) -> str:
    """A model's policy: its ``nonfinite_policy`` if set, else the
    process default."""
    p = getattr(model, "nonfinite_policy", None)
    if p is None:
        return _DEFAULT_POLICY
    if p not in POLICIES:
        raise ValueError(f"nonfinite_policy must be one of {POLICIES}, "
                         f"got {p!r}")
    return p


def tree_finite(loss, grads) -> torch.Tensor:
    """A 0-d bool tensor on the loss's device: the loss and every
    gradient leaf finite. The leaves are gathered into one flat f32
    buffer, so the check is a few launches whatever the tree's size."""
    flat = [loss.detach().reshape(-1).float()]
    flat += [g.detach().reshape(-1).float() for g in tree_leaves(grads)]
    return torch.isfinite(torch.cat(flat)).all()


def where_finite(ok, new, old):
    """``new`` where ``ok`` else ``old``, merged structurally over nested
    dicts. A leaf of ``new`` that ``old`` lacks, or whose shape differs,
    has no value to fall back to: on a bad step it becomes zeros (the
    absent-carry meaning of the layers), so a poisoned first tBPTT chunk
    cannot carry a NaN h / c past the skip. Leaves that are not tensors
    (None) pass through."""
    def merge(n, o):
        if isinstance(n, dict):
            o_map = o if isinstance(o, dict) else {}
            return {k: merge(v, o_map.get(k, _MISSING))
                    for k, v in n.items()}
        if not torch.is_tensor(n):
            return n
        if not torch.is_tensor(o) or o.shape != n.shape:
            return torch.where(ok, n, torch.zeros_like(n))
        return torch.where(ok, n, o)

    return merge(new, old)


def guard_updates(ok, policy: str, *pairs) -> Tuple:
    """The skip policy's select over ``(new, old)`` pairs (parameters,
    updater state, layer state): the one place it lives. Under "record"
    (and "off") the new values pass through."""
    if policy != "skip":
        return tuple(n for n, _ in pairs)
    return tuple(where_finite(ok, n, o) for n, o in pairs)


class SentinelAccounting:
    """A model's counts of training steps under the sentinel: all
    steps, bad ones, skipped ones and the current run of bad ones."""

    def __init__(self, model_name: str):
        self.model_name = model_name
        self.total_steps = 0
        self.bad_steps = 0
        self.skipped_updates = 0
        self.consecutive_bad = 0

    def record(self, ok: bool, skipped: bool) -> None:
        """Count one step: ``ok`` its flag, ``skipped`` whether a bad
        step's update was dropped."""
        self.total_steps += 1
        if ok:
            self.consecutive_bad = 0
            return
        self.bad_steps += 1
        self.consecutive_bad += 1
        if skipped:
            self.skipped_updates += 1


def accounting_for(model) -> SentinelAccounting:
    """The model's accounting, made on first use."""
    acct = getattr(model, "_sentinel_accounting", None)
    if acct is None:
        acct = SentinelAccounting(type(model).__name__)
        model._sentinel_accounting = acct
    return acct


def record_step_flag(model, ok: bool, policy: str) -> None:
    """The step's hook: count its flag; nothing under "off"."""
    if policy == "off":
        return
    accounting_for(model).record(ok, skipped=policy == "skip")
