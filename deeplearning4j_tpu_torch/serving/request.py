"""Generation requests and their streaming handles.

Counterpart of ``deeplearning4j_tpu/serving/request.py``: a submitted
prompt becomes a ``GenerationRequest`` (the engine-side descriptor
riding the admission queue and a slot) paired with a
``GenerationStream`` (the caller-side handle tokens stream into). The
request ledger and ``RequestTrace`` come later (ROADMAP.md A7).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.errors import InferenceTimeout

__all__ = ["GenerationRequest", "GenerationStream"]

_DONE = object()     # terminal queue sentinel


class GenerationStream:
    """Caller-side handle for one generation request.

    Iterate it to consume tokens as they are generated (ends at
    retirement, re-raising the request's failure if any), or call
    :meth:`result` for the ``sample_stream`` contract (prompt + generated
    ids). ``finish_reason`` is one of ``stop`` / ``length`` /
    ``capacity`` / ``cancelled`` / ``error`` once done. The engine
    guarantees a terminal event on every path."""

    def __init__(self, prompt):
        self.prompt = list(prompt)
        self._ids: List[int] = list(prompt)
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.cancelled = False
        #: seconds from submit to first token / to admission
        self.ttft_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None

    # -- engine side ---------------------------------------------------
    def _push(self, token: int) -> None:
        self._ids.append(int(token))
        self._q.put(int(token))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._done.set()
        self._q.put(_DONE)

    def _fail(self, exc: BaseException, reason: str = "error") -> None:
        self._error = exc
        self._finish(reason)

    # -- caller side ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def generated(self) -> List[int]:
        """Snapshot of the tokens generated so far (prompt excluded)."""
        return list(self._ids[len(self.prompt):])

    def cancel(self) -> None:
        """Ask the engine to retire this request at its next step."""
        self.cancelled = True

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._done.is_set():
                    if self._error is not None:
                        raise self._error
                    return
                continue
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request retires; returns prompt + generated
        ids. Raises the request's failure, or InferenceTimeout if
        `timeout` seconds pass first."""
        if not self._done.wait(timeout):
            raise InferenceTimeout(
                f"no result within {timeout:g}s "
                f"(generated {len(self._ids) - len(self.prompt)} tokens)")
        if self._error is not None:
            raise self._error
        return list(self._ids)


class GenerationRequest:
    """Engine-side descriptor: sampling config, stop rules, deadline and
    priority for one prompt, plus the slot-lifecycle scratch (pending
    token, rng, timing marks)."""

    __slots__ = ("prompt", "steps", "want", "temperature", "top_k",
                 "top_p", "stop_tokens", "rng", "deadline", "priority",
                 "handle", "submit_t", "pending_token", "last_token_t")

    def __init__(self, prompt, steps: int, *, temperature: float = 1.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 stop_tokens=(), rng=None,
                 max_length: Optional[int] = None,
                 deadline: Optional[float] = None, priority: int = 0):
        self.prompt = [int(t) for t in prompt]
        self.steps = int(steps)
        self.want = len(self.prompt) + self.steps
        if max_length is not None:
            self.want = min(self.want, int(max_length))
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.stop_tokens = frozenset(int(t) for t in stop_tokens)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.deadline = deadline          # monotonic seconds, or None
        self.priority = int(priority)
        self.handle = GenerationStream(self.prompt)
        self.submit_t = time.monotonic()
        self.pending_token: Optional[int] = None
        self.last_token_t: Optional[float] = None
