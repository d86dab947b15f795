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

The JAX package selects on the device inside its jitted step. The port
has two steps (``nn/network_base.py``):

- the eager per-batch step reads ``ok`` on the host once, after the
  update is queued, and runs :func:`guard_updates` only on a bad step:
  its ``fit`` copies each batch from pageable host memory, which already
  waits for the previous step, so the read adds no wait of its own,
  where a select over every leaf on every step cost several
  milliseconds of host time (PERF.md, §6);
- the K-step group (``fit(steps_per_dispatch=K)``, one CUDA graph on
  the card) cannot read the host inside the graph, so it runs the JAX
  step's select on the device on every step and writes each step's
  flag into a ``[K]`` bool tensor.

Each step's flag is counted on the model's :class:`SentinelAccounting`
(``model._sentinel_accounting``): ``total_steps``, ``bad_steps``,
``skipped_updates`` and ``consecutive_bad``. As in the JAX package, the
flags are queued (a host bool from the eager step, a device ``[K]``
vector from a group) and settled in order: at a cadence only those
already computed (a CUDA event says so), and all of them in
``finalize_fit_telemetry`` at the end of ``fit``. Settling publishes the
counts to the metrics registry as ``dl4jtpu_bad_steps_total``,
``dl4jtpu_skipped_updates_total`` and ``dl4jtpu_consecutive_bad_steps``
(labelled by the model's class), the JAX package's series.

Policies (:func:`set_default_nonfinite_policy`, or a model's
``nonfinite_policy``): ``"skip"`` (the default) keeps a bad step from
changing anything, ``"record"`` counts bad steps but applies them,
``"off"`` runs the step without the sentinel and without accounting.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.nn.updater import tree_leaves

POLICIES = ("skip", "record", "off")

_DEFAULT_POLICY = "skip"

_MISSING = object()

__all__ = ["BAD_STEPS", "CONSECUTIVE_BAD", "POLICIES", "SKIPPED_UPDATES",
           "SentinelAccounting", "accounting_for", "declare_sentinel_series",
           "effective_policy", "flush_accounting", "guard_updates",
           "record_step_flag", "set_default_nonfinite_policy",
           "tree_finite", "where_finite"]


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


BAD_STEPS = "dl4jtpu_bad_steps_total"
SKIPPED_UPDATES = "dl4jtpu_skipped_updates_total"
CONSECUTIVE_BAD = "dl4jtpu_consecutive_bad_steps"


def _series(registry: Optional[MetricsRegistry] = None):
    r = registry or global_registry()
    return (r.counter(BAD_STEPS,
                      "Train steps with a non-finite loss or gradient",
                      ("model",)),
            r.counter(SKIPPED_UPDATES,
                      "Non-finite updates zeroed by the sentinel",
                      ("model",)),
            r.gauge(CONSECUTIVE_BAD,
                    "Current run of consecutive non-finite train steps",
                    ("model",)))


def declare_sentinel_series(registry: Optional[MetricsRegistry] = None
                            ) -> None:
    """Declare the sentinel's series (``monitoring.ensure_started``)."""
    _series(registry)


class SentinelAccounting:
    """A model's counts of training steps under the sentinel: all
    steps, bad ones, skipped ones and the current run of bad ones.

    ``record`` queues a step's flag (a host bool) or a group's flags (a
    device tensor with the CUDA event recorded after it was written);
    settling takes them in order and publishes the counts. The fit
    thread owns record and flush; the lock guards against concurrent
    readers (scrapes)."""

    def __init__(self, model_name: str, flush_every: int = 25,
                 registry: Optional[MetricsRegistry] = None):
        self.model_name = model_name
        self.flush_every = max(1, int(flush_every))
        self._registry = registry
        self._lock = threading.Lock()
        self._pending: List[Tuple[Any, Any, bool]] = []
        self.total_steps = 0
        self.bad_steps = 0
        self.skipped_updates = 0
        self.consecutive_bad = 0

    def record(self, flags: Any, skipped: bool, event=None) -> None:
        """Queue one step's flag or one group's ``[K]`` flags;
        ``event`` (a CUDA event recorded after the flags were written)
        says when device flags can be read without waiting. A host
        flag behind no device flags is settled at once; otherwise, at
        ``flush_every`` queued entries, the computed prefix is."""
        with self._lock:
            self._pending.append((flags, event, skipped))
            host_only = all(not torch.is_tensor(f)
                            for f, _, _ in self._pending)
            due = host_only or len(self._pending) >= self.flush_every
        if due:
            self.flush(force=host_only)

    @staticmethod
    def _is_ready(flags: Any, event) -> bool:
        if not torch.is_tensor(flags) or flags.device.type != "cuda":
            return True
        return event is not None and event.query()

    def flush(self, force: bool = True) -> None:
        """Settle the queued flags and publish the counts. ``force=False``
        settles only the longest prefix already computed (no wait); the
        end of ``fit`` forces all (a hard cap of ``4 * flush_every``
        queued entries forces too)."""
        with self._lock:
            if force or len(self._pending) >= 4 * self.flush_every:
                pending, self._pending = self._pending, []
            else:
                n = 0
                while n < len(self._pending) and \
                        self._is_ready(*self._pending[n][:2]):
                    n += 1
                pending, self._pending = (self._pending[:n],
                                          self._pending[n:])
        if not pending:
            return
        new_bad = new_skipped = new_total = 0
        consecutive = None
        for flags, _, skipped in pending:
            oks = (flags.detach().cpu().reshape(-1).tolist()
                   if torch.is_tensor(flags) else [flags])
            for ok in oks:
                new_total += 1
                if bool(ok):
                    consecutive = 0
                else:
                    new_bad += 1
                    consecutive = (self.consecutive_bad
                                   if consecutive is None else consecutive) + 1
                    if skipped:
                        new_skipped += 1
        with self._lock:
            self.total_steps += new_total
            self.bad_steps += new_bad
            self.skipped_updates += new_skipped
            if consecutive is not None:
                self.consecutive_bad = consecutive
        bad, skip, run = _series(self._registry)
        if new_bad:
            bad.inc(new_bad, model=self.model_name)
        if new_skipped:
            skip.inc(new_skipped, model=self.model_name)
        run.set(self.consecutive_bad, model=self.model_name)

    def reset_window(self) -> None:
        """Drop the queued flags and the run of bad steps (a rollback or
        a restore just put back a good state); the lifetime totals
        stay."""
        with self._lock:
            self._pending = []
            self.consecutive_bad = 0


def accounting_for(model) -> SentinelAccounting:
    """The model's accounting, made on first use."""
    acct = getattr(model, "_sentinel_accounting", None)
    if acct is None:
        acct = SentinelAccounting(type(model).__name__)
        model._sentinel_accounting = acct
    return acct


def record_step_flag(model, ok, policy: str, event=None) -> None:
    """The step's hook: queue its flag (a host bool) or a group's
    ``[K]`` device flags; nothing under "off"."""
    if policy == "off":
        return
    accounting_for(model).record(ok, skipped=policy == "skip", event=event)


def flush_accounting(model) -> Optional[SentinelAccounting]:
    """Settle the model's queued flags, if it has accounting (the end of
    ``fit``)."""
    acct = getattr(model, "_sentinel_accounting", None)
    if acct is not None:
        acct.flush()
    return acct
