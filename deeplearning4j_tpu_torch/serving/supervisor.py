"""Supervised engine recovery: request-preserving arena rebuilds.

Counterpart of ``deeplearning4j_tpu/serving/supervisor.py``. Without a
supervisor the engine has one answer to a step-cycle fault, ``_break``:
fail every in-flight and queued request and refuse new work. The device
arena is disposable, though: everything needed to rebuild any request's
stream lives on the host in the request ledger (the prompt, the
committed tokens, the per-request numpy ``Generator``, advanced once per
draw and never by the device, the sampling config and the deadline). A
request holding ``ids = prompt + generated`` has fed exactly
``len(ids) - 1`` tokens (the last drawn token is pending), wherever the
fault landed.

So the supervisor QUARANTINES instead of breaking: on a fault it drops
the arena wholesale (slot state, page pool tensors, scale sidecars,
page tables, prefix cache), builds a fresh one, and re-admits every
survivor by re-priming ``ids[:-1]`` with ``pending = ids[-1]``, no draw
and no rng touch. The next dispatch then computes the distribution the
unperturbed run would have seen, and the untouched rng draws the token
it would have drawn: greedy and sampled streams continue exactly in
f32 (test-pinned over the slot arena and the bf16 and int8 pools). In
bf16 on the card the re-prime sums the survivors' K/V in one prefill
where the unperturbed run took them one decode step at a time, so a
near-tie may flip (``chip_smoke.py``'s ``serve_survive`` states the
limit). The rebuild payload is the public ``RequestLedgerEntry``: it
rides the same ``export_ledger`` / re-admit path a cross-process
handoff uses.

Restarts are BUDGETED (``resilience.retry.RestartBudget``): a fault
burst inside the window is ridden out, but an exhausted budget means
the fault is persistent, and the supervisor escalates to the engine's
terminal ``_break`` (fail-all, health down, submits refused). Every
rebuild lands on ``dl4jtpu_serving_engine_rebuilds_total{cause}`` and
the engine's ``health()``.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

from deeplearning4j_tpu_torch.monitoring import flightrecorder
from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.resilience.retry import RestartBudget
from deeplearning4j_tpu_torch.serving.health import (
    SERVING_ENGINE_ESCALATIONS, SERVING_ENGINE_REBUILDS,
    SERVING_RECOVERED_REQUESTS)

log = logging.getLogger(__name__)

__all__ = ["EngineSupervisor"]

#: cause label values (one counter child per cause, touched at bind so
#: the schema renders on an engine that never faulted)
CAUSE_DECODE = "decode_fault"
CAUSE_ADMISSION = "admission_fault"


class EngineSupervisor:
    """Recovery policy for one :class:`~.engine.GenerationEngine`.

    Pass it as ``GenerationEngine(supervisor=...)``; the engine calls
    :meth:`on_dispatch_fault` from its step-cycle failure path and the
    supervisor decides recover-vs-escalate:

    - budget has room → quarantine + rebuild the arena, re-admit every
      survivor from the host-side ledger (bit-identical continuation),
      return True (the engine keeps serving);
    - budget exhausted (or the rebuild itself fails) → return False and
      the engine falls through to its terminal ``_break`` fail-all.

    One supervisor per engine: binding resolves the metric handles to
    the engine's model label.
    """

    def __init__(self, budget: Optional[RestartBudget] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.budget = budget if budget is not None else RestartBudget()
        self._registry = registry
        self._engine = None
        self.rebuilds = 0
        self.recovered_requests = 0
        self.escalations = 0
        self.last_fault: Optional[BaseException] = None
        self.last_cause: Optional[str] = None
        self.last_rebuild_t: Optional[float] = None

    # -- engine side ---------------------------------------------------
    def _bind(self, engine, registry: Optional[MetricsRegistry]) -> None:
        if self._engine is not None and self._engine is not engine:
            raise ValueError(
                "one EngineSupervisor supervises one engine — construct "
                "a fresh supervisor per GenerationEngine")
        self._engine = engine
        r = self._registry or registry or global_registry()
        rebuilds = r.counter(
            SERVING_ENGINE_REBUILDS,
            "Arena rebuilds by the serving supervisor", ("model", "cause"))
        self._rebuild_handles = {
            c: rebuilds.labels(model=engine._label, cause=c)
            for c in (CAUSE_DECODE, CAUSE_ADMISSION)}
        # escalations are NOT rebuilds: a separate series keeps
        # sum(rebuilds_total) equal to arenas actually rebuilt
        self._escalated = r.counter(
            SERVING_ENGINE_ESCALATIONS,
            "Faults escalated to the terminal fail-all (budget "
            "exhausted or rebuild failed)", ("model",)).labels(
            model=engine._label)
        self._recovered = r.counter(
            SERVING_RECOVERED_REQUESTS,
            "In-flight requests re-admitted bit-identically after an "
            "arena rebuild", ("model",)).labels(model=engine._label)

    def on_dispatch_fault(self, engine, exc: BaseException,
                          cause: str) -> bool:
        """Called by the engine (under its step lock) when a dispatch
        cycle raised. True = recovered, keep serving; False = escalate
        to the terminal fail-all."""
        self.last_fault = exc
        self.last_cause = cause
        if not self.budget.try_acquire():
            self.escalations += 1
            self._escalated.inc()
            self._escalation_telemetry(engine, exc, "budget_exhausted")
            log.error(
                "serving supervisor: restart budget exhausted "
                "(%d rebuilds / %.0fs window) — escalating %r to "
                "fail-all", self.budget.max_restarts,
                self.budget.window_s, exc)
            return False
        try:
            survivors = engine._quarantine_rebuild(exc)
        except Exception:  # noqa: BLE001 — a failed rebuild must escalate
            self.escalations += 1
            self._escalated.inc()
            self._escalation_telemetry(engine, exc, "rebuild_failed")
            log.exception(
                "serving supervisor: arena rebuild failed — escalating "
                "the original fault %r to fail-all", exc)
            return False
        self.rebuilds += 1
        self.recovered_requests += survivors
        self.last_rebuild_t = time.monotonic()
        self._rebuild_handles[cause].inc()
        self._recovered.inc(survivors)
        engine._emit_serving_event(
            "rebuild", cause=cause, survivors=survivors,
            budget_remaining=self.budget.remaining())
        log.warning(
            "serving supervisor: quarantined arena after %s (%r); "
            "rebuilt and re-admitted %d in-flight request(s) "
            "(%d budget restart(s) left)", cause, exc, survivors,
            self.budget.remaining())
        return True

    def _escalation_telemetry(self, engine, exc: BaseException,
                              why: str) -> None:
        """Timeline event + flight-record artifact at the moment the
        supervisor gives up — the last look at the arena before
        ``_break`` fails every handle (its own dump, fired next, is
        deduped by the per-trigger rate limit but kept as a distinct
        trigger for the unsupervised case)."""
        engine._emit_serving_event("escalate", why=why,
                                   error=repr(exc))
        flightrecorder.maybe_dump(
            "supervisor_escalation", error=exc,
            health=engine.health(),
            queue=engine.queue_snapshot(),
            traces=engine._flight_traces(),
            extra={"why": why, "supervisor": self.health()})

    # -- observability -------------------------------------------------
    def health(self) -> dict:
        return {
            "rebuilds": self.rebuilds,
            "recovered_requests": self.recovered_requests,
            "escalations": self.escalations,
            "budget_remaining": self.budget.remaining(),
            "last_cause": self.last_cause,
            "last_fault": (repr(self.last_fault)
                           if self.last_fault is not None else None),
        }
