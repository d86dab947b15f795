"""Admission control for the generation engine.

Counterpart of ``deeplearning4j_tpu/serving/scheduler.py``: a bounded
priority queue between ``submit()`` callers and the engine's admission
step, with the ``block`` (callers wait for space, bounded by their
deadline) and ``fail_fast`` (``ServingQueueFull`` at the limit)
policies. Higher ``priority`` admits first; arrival order breaks ties.
The snapshot, ``peek_all``, ``requeue``, ``depth_ahead`` and
``shed_lowest`` views serve the ledger and overload layers.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.serving.errors import (
    EngineShutdown, InferenceTimeout, ServingQueueFull)
from deeplearning4j_tpu_torch.serving.request import GenerationRequest

__all__ = ["AdmissionQueue", "QueueSnapshot"]


@dataclasses.dataclass(frozen=True)
class QueueSnapshot:
    """Non-mutating view of the admission queue for PLACEMENT scoring:
    total depth, per-priority depths, and the oldest enqueue's age. The
    fleet router reads this (via ``GenerationEngine.queue_snapshot``)
    instead of lock-probing queue internals — one immutable copy taken
    under the queue lock, safe to score against while the engine keeps
    admitting."""

    depth: int
    per_priority: Dict[int, int]
    oldest_wait_s: Optional[float]


class AdmissionQueue:
    """Bounded priority admission queue (``block`` | ``fail_fast``)."""

    def __init__(self, limit: int = 64, policy: str = "block"):
        if policy not in ("block", "fail_fast"):
            raise ValueError(f"queue_policy must be 'block' or "
                             f"'fail_fast', got {policy!r}")
        if limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {limit}")
        self.limit = limit
        self.policy = policy
        self._cond = threading.Condition()
        self._heap: List[tuple] = []     # (-priority, seq, request)
        self._seq = 0
        self._closed = False

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def full(self) -> bool:
        with self._cond:
            return len(self._heap) >= self.limit

    def snapshot(self, now: Optional[float] = None) -> QueueSnapshot:
        """One consistent, non-mutating placement view: total depth,
        per-priority class depths, and how long the oldest queued
        request has waited (None when empty). Reads only — no pop, no
        LRU touch, no notify."""
        now = time.monotonic() if now is None else now
        with self._cond:
            per: Dict[int, int] = {}
            oldest: Optional[float] = None
            for _, _, req in self._heap:
                per[req.priority] = per.get(req.priority, 0) + 1
                if oldest is None or req.submit_t < oldest:
                    oldest = req.submit_t
            return QueueSnapshot(
                depth=len(self._heap), per_priority=per,
                oldest_wait_s=None if oldest is None else now - oldest)

    def peek_all(self) -> List[GenerationRequest]:
        """Queued requests in admission order (priority desc, FIFO
        within a class) WITHOUT removing them — the ledger-export view."""
        with self._cond:
            return [req for _, _, req in
                    sorted(self._heap, key=lambda it: (it[0], it[1]))]

    def requeue(self, req: GenerationRequest) -> None:
        """Force-enqueue bypassing the limit and the closed flag: the
        re-admission path for ledger survivors (supervisor rebuild
        overflow, fleet migration). Survivors were already admitted
        once — dropping them at a full queue would turn a recovery into
        a failure — and the transient over-limit is bounded by the
        SOURCE's queue bound. Priority ordering is preserved; FIFO
        order within a class restarts at requeue order."""
        with self._cond:
            heapq.heappush(self._heap, (-req.priority, self._seq, req))
            self._seq += 1
            self._cond.notify_all()

    def depth_ahead(self, priority: int) -> int:
        """Queued requests that would be admitted BEFORE a new request
        of `priority`: every strictly-higher class plus the whole
        equal-priority class (admission is FIFO within a class, so an
        arriving request queues behind all of its peers). The overload
        controller's queue-position estimate for deadline-based early
        rejection."""
        with self._cond:
            return sum(1 for item in self._heap
                       if item[2].priority >= priority)

    def shed_lowest(self, keep: int) -> List[GenerationRequest]:
        """Remove (and return) queued requests until at most `keep`
        remain, victimizing the LOWEST priority class first and, within
        a class, the most recent arrival first (the request that would
        have waited longest sheds first — earlier arrivals have the
        most sunk queue-wait and the best chance of admission before
        their deadline). The engine fails the returned handles with
        ``ServingOverloaded``; the queue never touches handles
        itself."""
        with self._cond:
            n = len(self._heap) - max(0, int(keep))
            if n <= 0:
                return []
            # victims: ascending priority, then descending arrival seq
            order = sorted(self._heap,
                           key=lambda it: (-it[0], -it[1]))
            victims = order[:n]
            gone = {id(it[2]) for it in victims}
            self._heap = [it for it in self._heap
                          if id(it[2]) not in gone]
            heapq.heapify(self._heap)
            self._cond.notify_all()      # wake blocked submitters
            return [it[2] for it in victims]

    def submit(self, req: GenerationRequest) -> None:
        """Enqueue under the admission policy: ``block`` waits for space
        bounded by the request's deadline (forever with none); expiry
        raises InferenceTimeout, shutdown EngineShutdown, and
        ``fail_fast`` at the limit ServingQueueFull."""
        with self._cond:
            if self._closed:
                raise EngineShutdown("admission queue closed")
            if self.policy == "fail_fast" and \
                    len(self._heap) >= self.limit:
                raise ServingQueueFull(
                    f"admission queue at limit ({self.limit} requests)")
            while len(self._heap) >= self.limit:
                budget = 0.2 if req.deadline is None else \
                    min(0.2, req.deadline - time.monotonic())
                if budget <= 0:
                    raise InferenceTimeout(
                        "deadline expired waiting for queue space")
                self._cond.wait(budget)
                if self._closed:
                    raise EngineShutdown("admission queue closed")
            heapq.heappush(self._heap, (-req.priority, self._seq, req))
            self._seq += 1
            self._cond.notify_all()

    def reap(self, now: float) -> List[GenerationRequest]:
        """Remove (and return) queued requests that are cancelled or past
        their deadline, so a queued deadline fires on time even while
        the arena is full."""
        with self._cond:
            dead = [item[2] for item in self._heap
                    if item[2].handle.cancelled
                    or (item[2].deadline is not None
                        and now >= item[2].deadline)]
            if dead:
                gone = set(map(id, dead))
                self._heap = [item for item in self._heap
                              if id(item[2]) not in gone]
                heapq.heapify(self._heap)
                self._cond.notify_all()
            return dead

    def pop(self, admissible=None) -> Optional[GenerationRequest]:
        """Highest-priority queued request, or None (non-blocking).
        ``admissible(req)`` is consulted on the HEAD only: False leaves it
        queued (the paged engine's head-of-line block while the head
        needs more free pages than exist)."""
        with self._cond:
            if not self._heap:
                return None
            if admissible is not None and \
                    not admissible(self._heap[0][2]):
                return None
            _, _, req = heapq.heappop(self._heap)
            self._cond.notify_all()      # wake blocked submitters
            return req

    def wait(self, timeout: float) -> None:
        """Park until work arrives (or `timeout` seconds)."""
        with self._cond:
            if not self._heap and not self._closed:
                self._cond.wait(timeout)

    def close(self) -> List[GenerationRequest]:
        """Refuse new submissions and drain everything queued, in
        admission order."""
        with self._cond:
            self._closed = True
            drained = [req for _, _, req in
                       sorted(self._heap, key=lambda it: (it[0], it[1]))]
            self._heap.clear()
            self._cond.notify_all()
            return drained
