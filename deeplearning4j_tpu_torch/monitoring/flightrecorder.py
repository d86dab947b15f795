"""Fault flight recorder: a post-mortem artifact for terminal failures.

Counterpart of ``deeplearning4j_tpu/monitoring/flightrecorder.py``, kept
as the port's own copy (the same artifact layout, caps and series).

An escalated serving fault (``GenerationEngine._break``), a supervisor
budget exhaustion, a fleet with no replica left to place on
(``NoReplicaAvailable``), or a training divergence
(``DivergenceError``) currently leaves ONE trace of itself: the raised
exception. Every question a post-mortem actually asks — what was the
queue doing, which requests were in flight and where had they been,
what did the ops timeline look like in the minute before — dies with
the process. This module dumps that context to disk at the moment of
failure, the way an aircraft flight recorder preserves the approach,
not just the impact.

One artifact per dump, JSONL, written ATOMICALLY (tmp sibling +
``os.replace`` via ``resilience.durable`` — a crash mid-dump leaves no
torn artifact):

    line 1:  header {trigger, error, time, pid, health, queue, extra}
    lines:   one per ring-buffer event (the ops-timeline tail)
    lines:   one per request trace ({"trace": ...} payload form)

Budget-capped on every axis so a dump can never OOM or disk-fill its
way into being a second incident: the event tail, the trace count, and
the total serialized bytes are all bounded, and dumps themselves are
rate-limited per trigger with a process-wide cap (a crash-looping
engine writes a handful of artifacts, not thousands).

Trigger matrix (see ARCHITECTURE.md "Structured events & request
tracing"):

    ``engine_break``          GenerationEngine._break (terminal fail-all)
    ``supervisor_escalation`` EngineSupervisor budget exhausted / rebuild
                              failed (fires just before engine_break —
                              the per-trigger rate limit keeps both)
    ``no_replica``            FleetRouter.submit with every replica
                              refusing / nothing healthy left
    ``divergence``            DivergenceWatchdog raising DivergenceError

All dumps are best-effort: ``maybe_dump`` never raises into the failure
path that invoked it.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.monitoring.events import global_event_log
from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

log = logging.getLogger(__name__)

__all__ = ["flight_dir", "last_record_path", "maybe_dump",
           "read_record", "reset_for_tests", "set_flight_dir"]

FLIGHT_DUMPS = "dl4jtpu_flight_records_total"

#: budget caps — the artifact must stay a bundle, not a database
MAX_EVENTS = 500
MAX_TRACES = 16
MAX_BYTES = 2 * 1024 * 1024
#: rate limits — a crash loop writes a handful of artifacts, not 1000s
MIN_INTERVAL_S = 10.0
MAX_DUMPS_PER_PROCESS = 32

_mu = threading.Lock()
_dir: Optional[str] = None
_last_by_trigger: Dict[str, float] = {}
_dump_count = 0
_last_path: Optional[str] = None


def set_flight_dir(path: Optional[str]) -> None:
    """Where artifacts land (None restores the default:
    ``$DL4JTPU_FLIGHT_DIR`` or ``<tmpdir>/dl4jtpu_flight``)."""
    global _dir
    with _mu:
        _dir = path


def flight_dir() -> str:
    with _mu:
        if _dir is not None:
            return _dir
    return os.environ.get(
        "DL4JTPU_FLIGHT_DIR",
        os.path.join(tempfile.gettempdir(), "dl4jtpu_flight"))


def last_record_path() -> Optional[str]:
    """Path of the most recent dump this process wrote (tests /
    operator logs)."""
    with _mu:
        return _last_path


def reset_for_tests() -> None:
    """Drop the rate-limit state so a test can dump deterministically."""
    global _dump_count, _last_path
    with _mu:
        _last_by_trigger.clear()
        _dump_count = 0
        _last_path = None


def _jsonable(obj: Any) -> Any:
    """Lossy-but-total JSON coercion: a flight record must always
    serialize, whatever a health()/queue payload happens to carry."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        return repr(obj)


def maybe_dump(trigger: str, error: Optional[BaseException] = None,
               health: Optional[dict] = None,
               queue: Optional[Any] = None,
               traces: Optional[List[Any]] = None,
               extra: Optional[dict] = None,
               registry: Optional[MetricsRegistry] = None
               ) -> Optional[str]:
    """Write one flight-record artifact if the budget allows; returns
    its path, or None when rate-limited / disabled / failed. Never
    raises — this runs inside failure paths that must stay failure
    paths, not become new ones.

    `traces` accepts ``serving.request.RequestTrace`` objects (or any
    object with ``to_payload()``), newest-first preferred — only the
    first ``MAX_TRACES`` are kept."""
    global _dump_count, _last_path
    now = time.monotonic()
    with _mu:
        if _dump_count >= MAX_DUMPS_PER_PROCESS:
            return None
        last = _last_by_trigger.get(trigger)
        if last is not None and now - last < MIN_INTERVAL_S:
            return None
        _last_by_trigger[trigger] = now
        _dump_count += 1
    try:
        return _dump(trigger, error, health, queue, traces, extra,
                     registry)
    except Exception:  # noqa: BLE001 — a recorder must never re-fail
        log.exception("flight recorder: dump for trigger %r failed",
                      trigger)
        # refund the process-wide slot: N transient write failures
        # must not permanently kill the recorder (the per-trigger
        # rate-limit stamp stays — it bounds the retry rate instead)
        with _mu:
            _dump_count -= 1
        return None


def _dump(trigger, error, health, queue, traces, extra,
          registry) -> Optional[str]:
    global _last_path
    events = global_event_log().tail(MAX_EVENTS)
    qdict = None
    if queue is not None:
        qdict = (dict(depth=queue.depth,
                      per_priority={str(k): v for k, v
                                    in queue.per_priority.items()},
                      oldest_wait_s=queue.oldest_wait_s)
                 if hasattr(queue, "per_priority") else _jsonable(queue))
    header = {
        "record": "dl4jtpu_flight", "version": 1,
        "trigger": trigger,
        "error": repr(error) if error is not None else None,
        "time": time.time(), "pid": os.getpid(),
        "health": _jsonable(health),
        "queue": qdict,
        "extra": _jsonable(extra),
        "events": len(events),
        "events_dropped": global_event_log().dropped_total,
    }
    lines = [json.dumps(header, default=repr)]
    for ev in events:
        lines.append(json.dumps(ev.as_dict(), default=repr))
    n_traces = 0
    for tr in (traces or [])[:MAX_TRACES]:
        payload = tr.to_payload() if hasattr(tr, "to_payload") else tr
        lines.append(json.dumps({"trace": _jsonable(payload)},
                                default=repr))
        n_traces += 1
    # the byte budget trims the event tail first (oldest events are the
    # cheapest history to lose), never the header or the traces
    while len(lines) > 1 + n_traces \
            and sum(len(l) + 1 for l in lines) > MAX_BYTES:
        lines.pop(1)
    d = flight_dir()
    os.makedirs(d, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S")
    path = os.path.join(
        d, f"flight_{trigger}_{stamp}_{os.getpid()}_"
           f"{global_event_log().total_emitted}.jsonl")
    from deeplearning4j_tpu_torch.resilience.durable import atomic_write_text
    atomic_write_text(path, "\n".join(lines) + "\n")
    with _mu:
        _last_path = path
    (registry or global_registry()).counter(
        FLIGHT_DUMPS, "Flight-record artifacts written, by trigger",
        ("trigger",)).inc(trigger=trigger)
    global_event_log().emit("flight", "dump", trigger=trigger, path=path)
    log.error("flight recorder: %s -> %s (%d events, %d traces)",
              trigger, path, len(lines) - 1 - n_traces, n_traces)
    return path


def read_record(path: str) -> dict:
    """Parse one artifact back into {header, events, traces} (tests,
    offline analysis)."""
    header, events, traces = None, [], []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            obj = json.loads(line)
            if header is None:
                header = obj
            elif "trace" in obj and "category" not in obj:
                traces.append(obj["trace"])
            else:
                events.append(obj)
    return {"header": header, "events": events, "traces": traces}
