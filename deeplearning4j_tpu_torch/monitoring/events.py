"""Process-wide structured event log: the fleet's flight timeline.

Counterpart of ``deeplearning4j_tpu/monitoring/events.py`` (the same
ring, series and event shape), kept as the port's own copy.

The metrics registry answers "how much / how fast" in aggregate; this
module answers "what happened, in what order". One process-wide,
thread-safe, sync-free ring buffer of typed :class:`Event` records that
every layer of the serving and resilience stack appends to — engine
rebuilds and brownout transitions, fleet migrations and scale events,
elastic re-meshes, checkpoint commits, divergence restarts — queryable
live (``tail()``, the UIServer ``/events`` endpoint, ``health()``
``last_events`` payloads) and dumped wholesale by the fault flight
recorder (``monitoring/flightrecorder.py``) when something terminal
fires.

Contract (the reason hot paths may call ``emit`` freely):

- **host-side only** — an event is a couple of dict inserts and two
  clock reads; no device syncs and no torch import, so tracing stays
  ON by default;
- **bounded** — a fixed-capacity ring: when full, the OLDEST event is
  overwritten and ``dl4jtpu_events_dropped_total`` counts the loss (an
  event storm costs memory of the past, never memory of the process);
- **non-blocking export** — readers snapshot the ring under the lock
  and filter/serialize OUTSIDE it, so a slow scrape or a fat JSON dump
  never stalls an ``emit`` (and the depth gauge reads a plain int,
  lock-free, so the registry scrape can never deadlock against an
  emitter incrementing the dropped counter).

Per-REQUEST detail deliberately does NOT ride this log (one line per
token across a fleet would be pure ring churn): request lifecycle lives
in ``serving.request.RequestTrace``, attached to each stream handle and
carried across replicas by the request ledger. This log is the
OPS-level timeline those traces interleave with.

See ARCHITECTURE.md "Structured events & request tracing".
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

__all__ = ["Event", "EventLog", "declare_event_series", "emit",
           "events_enabled", "global_event_log", "set_events_enabled"]

EVENTS_DEPTH = "dl4jtpu_events_depth"
EVENTS_DROPPED = "dl4jtpu_events_dropped_total"

#: default ring capacity — a few minutes of fleet churn; the flight
#: recorder caps its own tail separately
DEFAULT_CAPACITY = 2048

#: event categories in use across the stack (open vocabulary — these
#: are the taxonomy ARCHITECTURE.md documents, not an enum gate):
#: ``serving`` (engine lifecycle: rebuild/escalate/break/drain/shed/
#: early_reject/brownout), ``fleet`` (router: replica_join/replica_dead/
#: migration/rebalance/scale_out/scale_in/autoscale/generation),
#: ``resilience`` (remesh/checkpoint_save/checkpoint_commit/rollback/
#: restart/preemption/divergence), ``flight`` (recorder dumps),
#: ``transport`` (cross-process fleet mailbox/journal: admit/revoke/
#: duplicate/quarantine/nack/replace — serving/fleet/transport.py).
KNOWN_CATEGORIES = ("serving", "fleet", "resilience", "flight",
                    "transport")


class Event:
    """One timeline entry: monotonic + wall timestamps, a category, a
    short name, and a flat attrs dict. Immutable by convention (the
    ring hands out references; mutating one would rewrite history)."""

    __slots__ = ("seq", "mono", "wall", "category", "name", "attrs")

    def __init__(self, seq: int, mono: float, wall: float,
                 category: str, name: str, attrs: Dict[str, Any]):
        self.seq = seq
        self.mono = mono
        self.wall = wall
        self.category = category
        self.name = name
        self.attrs = attrs

    def as_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "mono": self.mono, "wall": self.wall,
                "category": self.category, "name": self.name,
                "attrs": dict(self.attrs)}

    def __repr__(self):
        return (f"Event({self.seq}, {self.category}.{self.name}, "
                f"{self.attrs})")


#: process-wide enable switch (tracing is ON by default; the bench A/B
#: flips it off to price the instrumentation). RequestTrace consults
#: the same flag, so one switch silences the whole event layer.
_enabled = True


def set_events_enabled(flag: bool) -> bool:
    """Flip structured-event tracing process-wide; returns the previous
    value (so benches can restore it). Disabled = ``emit`` and
    ``RequestTrace.record`` become no-ops; already-buffered events stay
    readable."""
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    return prev


def events_enabled() -> bool:
    return _enabled


class EventLog:
    """Thread-safe bounded ring of :class:`Event` records."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 registry: Optional[MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: "deque[Event]" = deque(maxlen=self.capacity)
        self._seq = 0
        #: plain ints, read lock-free by the depth gauge and the
        #: dropped-counter reconciler — never take self._lock from a
        #: registry-scrape callback (the emit path increments the
        #: registry counter while NOT holding self._lock, for the same
        #: no-lock-order-cycle reason)
        self._dropped = 0
        self._registry = registry
        self._dropped_handle = None
        self._sink_lock = threading.Lock()
        self._sink_path: Optional[str] = None

    # -- write side ----------------------------------------------------
    def emit(self, category: str, name: str, **attrs) -> Optional[Event]:
        """Append one event (no-op returning None while tracing is
        disabled). ``attrs`` values should be small JSON-able scalars —
        the ring is memory, the JSONL sink is a file, and the flight
        recorder serializes tails wholesale."""
        if not _enabled:
            return None
        mono, wall = time.monotonic(), time.time()
        with self._lock:
            self._seq += 1
            ev = Event(self._seq, mono, wall, str(category), str(name),
                       attrs)
            dropped = len(self._buf) >= self.capacity
            self._buf.append(ev)
            if dropped:
                self._dropped += 1
        if dropped:
            h = self._dropped_handle
            if h is not None:
                h.inc()           # outside self._lock: no ABBA with scrape
        sink = self._sink_path
        if sink is not None:
            self._sink_write(ev)
        return ev

    # -- read side (snapshot under lock, work outside it) --------------
    def tail(self, n: Optional[int] = None, category: Optional[str] = None,
             match: Optional[Dict[str, Any]] = None) -> List[Event]:
        """The most recent `n` events (oldest first), optionally
        filtered by category and/or exact attr matches. Non-mutating;
        filtering and any serialization happen on a snapshot taken
        under the lock, never while holding it."""
        with self._lock:
            snap = list(self._buf)
        if category is not None:
            snap = [e for e in snap if e.category == category]
        if match:
            snap = [e for e in snap
                    if all(e.attrs.get(k) == v for k, v in match.items())]
        if n is not None and n >= 0:
            snap = snap[-n:] if n else []   # [-0:] is the WHOLE list
        return snap

    def depth(self) -> int:
        return len(self._buf)       # deque len: atomic, lock-free

    @property
    def dropped_total(self) -> int:
        return self._dropped

    @property
    def total_emitted(self) -> int:
        return self._seq

    def clear(self) -> None:
        """Drop everything (tests; the dropped/seq counters survive —
        they are process-lifetime accounting, not buffer state)."""
        with self._lock:
            self._buf.clear()

    # -- optional JSONL sink -------------------------------------------
    def attach_jsonl(self, path: Optional[str]) -> None:
        """Stream every future event as one JSON line appended to
        `path` (None detaches). Best-effort: a failing write disables
        the sink rather than breaking the emitter."""
        with self._sink_lock:
            self._sink_path = path

    def _sink_write(self, ev: Event) -> None:
        with self._sink_lock:
            path = self._sink_path
            if path is None:
                return
            try:
                with open(path, "a") as f:
                    f.write(json.dumps(ev.as_dict(), default=repr) + "\n")
            except OSError:
                self._sink_path = None   # a dead sink must not wedge emit

    # -- telemetry -----------------------------------------------------
    def declare_series(self, registry: Optional[MetricsRegistry] = None
                       ) -> None:
        """Register the event-log depth gauge + dropped counter (called
        from ``monitoring.ensure_started`` for the global log). The
        depth gauge reads a lock-free len, so a registry scrape can
        never block on — or hold — the event-log lock."""
        r = registry or self._registry or global_registry()
        r.gauge(EVENTS_DEPTH, "Structured events currently buffered in "
                "the process-wide ring").set_function(self.depth)
        self._dropped_handle = r.counter(
            EVENTS_DROPPED, "Structured events overwritten by the "
            "bounded ring (oldest-first)").labels()


_global_log = EventLog()


def global_event_log() -> EventLog:
    """The process-wide default log every subsystem emits into."""
    return _global_log


def emit(category: str, name: str, **attrs) -> Optional[Event]:
    """``global_event_log().emit(...)`` — the one-liner hot paths use."""
    return _global_log.emit(category, name, **attrs)


def declare_event_series(registry: Optional[MetricsRegistry] = None) -> None:
    """Declare the global log's depth/dropped series so a scrape taken
    before the first event already shows the schema."""
    _global_log.declare_series(registry)
