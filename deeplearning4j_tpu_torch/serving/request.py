"""Generation requests, streaming handles, and the request ledger.

Counterpart of ``deeplearning4j_tpu/serving/request.py``, key for key in
the ledger's wire form. A submitted prompt becomes a
``GenerationRequest`` (the engine-side descriptor riding the admission
queue and a slot) paired with a ``GenerationStream`` (the caller-side
handle tokens stream into).

``RequestLedgerEntry`` is the public, versioned record of what the host
already holds to rebuild any in-flight request exactly: the prompt, the
committed token ids (whose last element is the pending, not yet fed
token), the per-request numpy ``Generator`` (advanced once per draw,
never by the device) and the sampling config. The supervisor's rebuild
and a cross-process handoff move requests as ledger entries through one
engine path (``GenerationEngine.export_ledger`` /
``admit_from_ledger``). The rng travels as numpy's own bit-generator
state, so a payload written by either package admits in the other.

``RequestTrace`` is the per-request observability half: every lifecycle
transition (submit, queue pop, prefill, seat, first token, decode
rollups, shed or early rejection, supervisor re-admissions, retirement)
lands as a timestamped record on the request's handle, so "why was this
request slow" splits into queue wait, prefill, decode and recovery.
Traces are host-side, bounded, and ride the ledger payload
(``LEDGER_VERSION`` 2; version-1 payloads still admit, trace-less).
``ttft_attribution`` aggregates a window of traces into the queue /
prefill / placement split of the mean TTFT.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.monitoring.events import events_enabled
from deeplearning4j_tpu_torch.serving.errors import InferenceTimeout

#: format version stamped into every exported ledger entry; bump on any
#: change to the payload fields or their meaning.
#: v1: prompt/ids/rng/config.  v2: + the request trace.
LEDGER_VERSION = 2

__all__ = ["GenerationRequest", "GenerationStream", "LEDGER_VERSION",
           "RequestLedgerEntry", "RequestTrace", "rng_state_payload",
           "ttft_attribution"]

_DONE = object()     # terminal queue sentinel


def rng_state_payload(rng) -> dict:
    """JSON-able snapshot of a numpy ``Generator``'s bit-generator
    state — the per-token consistency record the cross-process stream
    journal carries (``serving/fleet/transport.py``): a re-placement
    re-primes from (committed ids, this state) and continues
    bit-identically. Same normalization as the full ledger payload
    (``RequestLedgerEntry.payload``'s ``rng_state`` field); the state
    setter accepts the list form back."""
    return RequestLedgerEntry._jsonable(rng.bit_generator.state)

#: decode progress lands on a trace as ROLLUPS — one record per this
#: many committed tokens (plus a flush at retirement) — never one
#: record per token: a 4k-token stream is ~128 trace records, not 4k
TRACE_ROLLUP_EVERY = 32
#: per-trace record cap; overflow drops (counted) rather than growing
TRACE_MAX_RECORDS = 256


class RequestTrace:
    """Bounded host-side trace of one request's lifecycle.

    Records are small dicts ``{"event", "t", ...attrs}`` with ``t`` =
    wall-clock ``time.time()`` (wall, not monotonic, deliberately: a
    trace crosses process boundaries inside the ledger payload, and
    monotonic clocks do not). Thread-safe — the submit caller, the
    engine step thread, and a fleet poll thread may all touch one
    request. All methods are no-ops while
    ``monitoring.events.set_events_enabled(False)`` holds, except reads.

    ``breakdown()`` is the attribution contract: where did this
    request's wall time go — queue wait, prefill, decode — and how many
    migration hops / supervisor rebuilds did it survive.
    """

    __slots__ = ("records", "dropped", "_pend_tokens", "_pend_accepted",
                 "_pend_proposed", "_mu")

    def __init__(self, records: Optional[List[Dict[str, Any]]] = None,
                 dropped: int = 0):
        self.records: List[Dict[str, Any]] = records if records is not None \
            else []
        self.dropped = int(dropped)
        self._pend_tokens = 0
        self._pend_accepted = 0
        self._pend_proposed = 0
        self._mu = threading.Lock()

    # -- write side (engine / router / migration) ----------------------
    def record(self, event: str, **attrs) -> None:
        if not events_enabled():
            return
        rec = {"event": event, "t": time.time()}
        rec.update(attrs)
        with self._mu:
            if len(self.records) >= TRACE_MAX_RECORDS:
                if event == "decode":
                    self.dropped += 1
                    return
                # lifecycle records (retire, migrate, rebuild, ...)
                # outrank decode-progress history: evict the oldest
                # rollup so a very long stream still ends with its
                # retirement cause and hops on the trace
                for i, r in enumerate(self.records):
                    if r["event"] == "decode":
                        del self.records[i]
                        self.dropped += 1
                        break
                else:
                    self.dropped += 1
                    return
            self.records.append(rec)

    def rollup(self, tokens: int, accepted: Optional[int] = None,
               proposed: Optional[int] = None) -> None:
        """Accumulate decode progress; emits one ``decode`` record per
        ``TRACE_ROLLUP_EVERY`` committed tokens (the no-per-token-spam
        contract). Speculative steps pass accepted/proposed counts."""
        if not events_enabled():
            return
        with self._mu:
            self._pend_tokens += int(tokens)
            if accepted is not None:
                self._pend_accepted += int(accepted)
            if proposed is not None:
                self._pend_proposed += int(proposed)
            flush = self._pend_tokens >= TRACE_ROLLUP_EVERY
        if flush:
            self.flush_rollup()

    def flush_rollup(self) -> None:
        """Materialize any pending rollup (retirement / export calls
        this so a short stream still shows its decode record)."""
        with self._mu:
            n = self._pend_tokens
            acc, prop = self._pend_accepted, self._pend_proposed
            self._pend_tokens = 0
            self._pend_accepted = self._pend_proposed = 0
        if n:
            extra = {}
            if prop:
                extra = {"accepted": acc, "proposed": prop}
            self.record("decode", tokens=n, **extra)

    # -- read side -----------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the trace records (oldest first)."""
        with self._mu:
            return [dict(r) for r in self.records]

    def replicas(self) -> List[str]:
        """Engine labels this request was ever seated (or re-primed)
        on, in first-seen order — a migrated stream lists both sides of
        the hop."""
        seen: List[str] = []
        for r in self.events():
            eng = r.get("engine")
            if eng is not None and eng not in seen:
                seen.append(eng)
        return seen

    def breakdown(self) -> Dict[str, Any]:
        """Decompose the trace into the attribution dict:

        - ``queue_wait_s``: sum over every enqueue→pop span (a request
          can ride a queue more than once — requeue, migration);
          ``queue_wait_ttft_s`` is the subset accrued BEFORE the first
          token (what TTFT attribution may count — a migrated active
          stream's target-queue wait is recovery cost, not
          time-to-first-token);
        - ``prefill_s``: sum over prefill_start→prefill_end spans
          (re-prime prefills after a rebuild/migration included;
          ``prefill_ttft_s`` is the pre-first-token subset);
        - ``decode_s``: first token → retirement, MINUS any prefill
          spans inside that window (re-primes are recovery cost, not
          decode) — so the components partition the request's life;
        - ``migrations`` / ``rebuilds``: hop and re-admission counts;
        - ``ttft_s``: submit → first token when both were traced.
        """
        evs = self.events()
        out: Dict[str, Any] = {"queue_wait_s": 0.0,
                               "queue_wait_ttft_s": 0.0,
                               "prefill_s": 0.0, "prefill_ttft_s": 0.0,
                               "decode_s": None, "migrations": 0,
                               "rebuilds": 0, "ttft_s": None}
        enq_t: Optional[float] = None
        pre_t: Optional[float] = None
        submit_t: Optional[float] = None
        first_t: Optional[float] = None
        end_t: Optional[float] = None
        re_prefill = 0.0
        for r in evs:
            ev, t = r["event"], r["t"]
            if ev == "submit":
                submit_t = t
                enq_t = t
            elif ev in ("requeue", "migrate"):
                if ev == "migrate":
                    out["migrations"] += 1
                enq_t = t
            elif ev == "queue_pop":
                if enq_t is not None:
                    span = max(0.0, t - enq_t)
                    out["queue_wait_s"] += span
                    if first_t is None:
                        out["queue_wait_ttft_s"] += span
                    enq_t = None
            elif ev == "prefill_start":
                pre_t = t
            elif ev == "prefill_end":
                if pre_t is not None:
                    span = max(0.0, t - pre_t)
                    out["prefill_s"] += span
                    if first_t is not None:
                        re_prefill += span
                    else:
                        out["prefill_ttft_s"] += span
                    pre_t = None
            elif ev == "first_token":
                if first_t is None:
                    first_t = t
            elif ev == "rebuild":
                out["rebuilds"] += 1
            elif ev == "retire":
                end_t = t
        if submit_t is not None and first_t is not None:
            out["ttft_s"] = max(0.0, first_t - submit_t)
        if first_t is not None and end_t is not None:
            out["decode_s"] = max(0.0, end_t - first_t - re_prefill)
        return out

    # -- the ledger wire form ------------------------------------------
    def to_payload(self) -> dict:
        self.flush_rollup()
        with self._mu:
            return {"records": [dict(r) for r in self.records],
                    "dropped": self.dropped}

    @classmethod
    def from_payload(cls, payload: Optional[dict]) -> "RequestTrace":
        if not payload:
            return cls()
        return cls(records=[dict(r) for r in payload.get("records", ())],
                   dropped=int(payload.get("dropped", 0)))


def ttft_attribution(traces: Iterable[RequestTrace]) -> Dict[str, Any]:
    """Aggregate a window of request traces into the TTFT attribution
    dict: mean observed
    TTFT decomposed into queue wait + prefill + placement residue
    ("other": submit-side routing, admission bookkeeping, the dispatch
    the first token rode). Traces without a first token (shed, early
    rejected, failed pre-prefill) are excluded from the TTFT means but
    counted. All values are SECONDS; the caller renders units."""
    n = n_ttft = 0
    ttft = queue_w = prefill = 0.0
    migrations = rebuilds = 0
    for tr in traces:
        b = tr.breakdown()
        n += 1
        migrations += b["migrations"]
        rebuilds += b["rebuilds"]
        if b["ttft_s"] is None:
            continue
        n_ttft += 1
        ttft += b["ttft_s"]
        # only queue wait accrued BEFORE the first token counts toward
        # TTFT — a migrated stream's later target-queue ride is
        # recovery cost, not admission latency
        q = min(b["queue_wait_ttft_s"], b["ttft_s"])
        queue_w += q
        # prefill inside the TTFT window only (re-primes come later)
        prefill += min(b["prefill_ttft_s"], max(0.0, b["ttft_s"] - q))
    if n_ttft == 0:
        return {"requests": n, "with_ttft": 0}
    other = max(0.0, (ttft - queue_w - prefill) / n_ttft)
    return {"requests": n, "with_ttft": n_ttft,
            "ttft_mean_s": round(ttft / n_ttft, 6),
            "queue_wait_mean_s": round(queue_w / n_ttft, 6),
            "prefill_mean_s": round(prefill / n_ttft, 6),
            "other_mean_s": round(other, 6),
            "migrations": migrations, "rebuilds": rebuilds}


class GenerationStream:
    """Caller-side handle for one generation request.

    Tokens arrive as they are generated: iterate the handle to consume
    them (blocks until the engine produces the next one; ends at
    retirement, re-raising the request's failure if it has one), or call
    :meth:`result` for the classic one-shot ``sample_stream`` contract
    (full id list, prompt included). ``finish_reason`` is one of
    ``stop`` / ``length`` / ``capacity`` / ``cancelled`` / ``error``
    once done.

    The engine guarantees a terminal event on every path — retirement,
    request failure, engine shutdown — so consumers never block forever
    on a dead server (the ParallelInference no-hung-callers contract).
    """

    def __init__(self, prompt):
        self.prompt = list(prompt)
        self._ids: List[int] = list(prompt)
        self._q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self.finish_reason: Optional[str] = None
        self.cancelled = False
        #: seconds from submit to first token / to admission (set by the
        #: engine; None until known)
        self.ttft_s: Optional[float] = None
        self.queue_wait_s: Optional[float] = None
        self._trace = RequestTrace()

    def trace(self) -> RequestTrace:
        """This request's lifecycle trace (live — it keeps growing
        until retirement; ``breakdown()`` any time)."""
        return self._trace

    # -- engine side ---------------------------------------------------
    def _push(self, token: int) -> None:
        self._ids.append(int(token))
        self._q.put(int(token))

    def _finish(self, reason: str) -> None:
        self.finish_reason = reason
        self._trace.flush_rollup()
        self._trace.record("retire", reason=reason,
                           **({"error": repr(self._error)}
                              if self._error is not None else {}))
        self._done.set()
        self._q.put(_DONE)

    def _fail(self, exc: BaseException, reason: str = "error") -> None:
        self._error = exc
        self._finish(reason)

    # -- relay side (cross-process fleet transport) --------------------
    def relay_token(self, token: int) -> None:
        """Public engine-side push for a TRANSPORT RELAY: the
        out-of-process fleet router plays the engine's role for a
        handle whose real engine lives in another process, pushing each
        journaled committed token into the local stream
        (``serving/fleet/transport.py``). Identical semantics to the
        in-process engine push — the caller's iterator/result() cannot
        tell a relayed stream from a local one."""
        self._push(token)

    def relay_finish(self, reason: str,
                     error: Optional[BaseException] = None) -> None:
        """Transport-relay terminal event: finish (or fail) the local
        handle when the remote replica journals the request's
        retirement. No-op if the handle already has a terminal event
        (duplicate journal delivery must stay idempotent)."""
        if self._done.is_set():
            return
        if error is not None:
            self._fail(error, reason)
        else:
            self._finish(reason)

    # -- caller side ---------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def ids(self) -> List[int]:
        """Snapshot of prompt + tokens generated so far."""
        return list(self._ids)

    @property
    def generated(self) -> List[int]:
        """Snapshot of the tokens generated so far (prompt excluded)."""
        return list(self._ids[len(self.prompt):])

    def cancel(self) -> None:
        """Ask the engine to retire this request at its next step (frees
        the slot; a queued request is dropped at pop). Iterators/result()
        then raise RequestCancelled."""
        self.cancelled = True

    def __iter__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                # a finished, fully-drained stream (e.g. a SECOND
                # iteration after the terminal sentinel was consumed)
                # must end, not block forever
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
        ids (the ``sample_stream`` return contract). Raises the
        request's failure, or InferenceTimeout if `timeout` seconds pass
        first."""
        if not self._done.wait(timeout):
            raise InferenceTimeout(
                f"no result within {timeout:g}s "
                f"(generated {len(self._ids) - len(self.prompt)} tokens)")
        if self._error is not None:
            raise self._error
        return list(self._ids)


class GenerationRequest:
    """Engine-side descriptor: sampling config, stop rules, deadline and
    priority for one prompt, plus the slot-lifecycle scratch the engine
    tracks (pending token, rng, timing marks)."""

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
        self.handle._trace.record("submit", prompt_len=len(self.prompt),
                                  steps=self.steps,
                                  priority=self.priority)

    @property
    def trace(self) -> RequestTrace:
        """The handle's lifecycle trace (engine-side shorthand)."""
        return self.handle._trace

    @property
    def streamed(self) -> bool:
        """Whether any token has streamed: THE re-admission mode switch
        (re-prime ``ids[:-1]`` with the pending token vs a fresh
        admission) — one definition for the admission pop, the
        supervisor rebuild, and ``admit_from_ledger``. A fresh request
        can never read True before its admission draw (tokens only
        appear at admission)."""
        return len(self.handle._ids) > len(self.prompt)


@dataclasses.dataclass(frozen=True)
class RequestLedgerEntry:
    """One in-flight request as an exportable ledger record.

    ``ids`` is the capture-time snapshot of prompt + committed tokens;
    when the request has streamed at all, ``ids[-1]`` is the PENDING
    token (drawn but never yet fed to the model), so a re-admission
    re-primes ``ids[:-1]`` and the next dispatch recomputes exactly the
    distribution the unperturbed run would have seen. ``phase`` records
    where the request lived at export: ``active`` (seated in a slot),
    ``seating`` (the pop-to-seat handoff window, which ``_break`` sees
    and the export must carry the same way), or ``queued`` (never
    prefilled).

    The entry carries the LIVE ``GenerationRequest`` — its
    ``GenerationStream`` handle is the caller's, so an in-process
    re-admission (supervisor rebuild, fleet migration) continues the
    stream the caller is already consuming. :meth:`payload` /
    :meth:`from_payload` are the serialized form for a cross-process
    handoff: everything bit-exactness needs travels (rng bit-generator
    state included), but the reconstructed request has a FRESH handle —
    the original caller's stream cannot cross a process boundary.
    """

    version: int
    request: GenerationRequest
    ids: Tuple[int, ...]
    phase: str

    @classmethod
    def capture(cls, request: GenerationRequest,
                phase: str) -> "RequestLedgerEntry":
        return cls(LEDGER_VERSION, request,
                   tuple(request.handle._ids), phase)

    @property
    def streamed(self) -> bool:
        """Whether the request had streamed any token at CAPTURE time
        (the serialized counterpart of ``GenerationRequest.streamed``,
        which re-admission consults on the live request)."""
        return len(self.ids) > len(self.request.prompt)

    def resolve(self, exc: BaseException) -> None:
        """Terminally fail the carried request (no-op if it already has
        a terminal event) — the ledger holder's obligation when no
        engine can re-admit an entry: every exported request must end
        in a terminal event on SOME path, or its caller blocks forever."""
        if not self.request.handle.done:
            self.request.handle._fail(exc)

    @staticmethod
    def _jsonable(obj):
        """Recursively strip numpy types from an rng state dict: the
        default PCG64 state is plain ints, but e.g. MT19937 carries an
        ndarray key — the wire form must survive json.dumps for ANY
        Generator a caller submitted with (the state setters accept
        the list form back)."""
        if isinstance(obj, dict):
            return {k: RequestLedgerEntry._jsonable(v)
                    for k, v in obj.items()}
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.integer):
            return int(obj)
        return obj

    def payload(self) -> dict:
        """JSON-able form of everything a bit-identical continuation
        needs on another host. Deadlines travel as REMAINING budget
        (monotonic clocks don't cross processes); ``None`` stays None.
        Since v2 the request's lifecycle trace travels too (wall-clock
        timestamps — the one clock that crosses processes), so a
        migrated stream's post-mortem shows its whole history, hops
        included."""
        req = self.request
        remaining = None if req.deadline is None else \
            req.deadline - time.monotonic()
        return {
            "version": self.version,
            "phase": self.phase,
            "prompt": list(req.prompt),
            "ids": list(self.ids),
            "want": req.want,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "top_p": req.top_p,
            "stop_tokens": sorted(req.stop_tokens),
            "priority": req.priority,
            "deadline_remaining_s": remaining,
            "rng_state": self._jsonable(req.rng.bit_generator.state),
            "trace": req.handle._trace.to_payload(),
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "RequestLedgerEntry":
        """Rebuild an admissible entry from :meth:`payload`. The rng is
        restored bit-exactly (same bit-generator type + state), the
        committed ids are replayed into a fresh handle, and the pending
        token is restored — ``admit_from_ledger`` then continues the
        stream exactly as an in-process entry would. v1 payloads (no
        trace) still admit cleanly: the continuation starts a fresh
        trace with an import marker instead of refusing the request."""
        version = int(payload["version"])
        if version > LEDGER_VERSION:
            raise ValueError(
                f"ledger entry version {version} is newer than this "
                f"build understands ({LEDGER_VERSION})")
        state = payload["rng_state"]
        bit_gen = getattr(np.random, state["bit_generator"])()
        bit_gen.state = state
        prompt = [int(t) for t in payload["prompt"]]
        remaining = payload.get("deadline_remaining_s")
        # deadline re-anchoring contract (test-pinned): the wire form
        # carries REMAINING budget and the deadline is re-anchored on
        # the RECEIVER's monotonic clock — sender/receiver wall-clock
        # skew can neither extend nor prematurely expire a migrated
        # request. An already-expired budget (remaining < 0) stays
        # expired: the deadline lands in the receiver's past.
        deadline = None if remaining is None else \
            time.monotonic() + float(remaining)
        req = GenerationRequest(
            prompt, int(payload["want"]) - len(prompt),
            temperature=payload["temperature"],
            top_k=payload["top_k"], top_p=payload["top_p"],
            stop_tokens=payload["stop_tokens"],
            rng=np.random.Generator(bit_gen), deadline=deadline,
            priority=int(payload["priority"]))
        ids = [int(t) for t in payload["ids"]]
        if len(ids) > len(prompt):
            req.handle._ids = list(ids)
            req.pending_token = ids[-1]
        trace_payload = payload.get("trace")
        if trace_payload:
            req.handle._trace = RequestTrace.from_payload(trace_payload)
        else:
            # a v1 (trace-less) payload: keep the fresh trace the
            # request constructor started, marked so attribution knows
            # this history begins at the import boundary
            req.handle._trace.record("imported",
                                     payload_version=version)
        return cls(version, req, tuple(ids), str(payload["phase"]))
