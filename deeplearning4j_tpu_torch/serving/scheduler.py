"""Admission control for the generation engine.

Counterpart of ``deeplearning4j_tpu/serving/scheduler.py``: a bounded
priority queue between ``submit()`` callers and the engine's admission
step, with the ``block`` (callers wait for space, bounded by their
deadline) and ``fail_fast`` (``ServingQueueFull`` at the limit)
policies. Higher ``priority`` admits first; arrival order breaks ties.
The snapshot, shedding and requeue views serve the overload, ledger and
fleet layers and come with them (ROADMAP.md A7, A10).
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import List, Optional

from deeplearning4j_tpu_torch.serving.errors import (
    EngineShutdown, InferenceTimeout, ServingQueueFull)
from deeplearning4j_tpu_torch.serving.request import GenerationRequest

__all__ = ["AdmissionQueue"]


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
