"""Continuous-batching generation engine over a slot-based KV arena.

Counterpart of ``deeplearning4j_tpu/serving/engine.py``:

- **Slot arena**: the net's streaming state (attention KV caches, LSTM
  h / c) lives at a fixed batch of S slots; ONE ``[S, V, 1]`` decode
  forward advances every active request per step. Per-slot positions
  ride the per-row ``kv_pos`` vector; free slots idle harmlessly (their
  outputs are discarded).
- **Admission mid-flight**: a request primes at batch 1 into a detached
  state that is then joined to the arena at its slot, so running
  requests never wait for a newcomer's prompt.
- **Retirement per request**: stop token, length, capacity, deadline or
  cancellation free the slot at once; the next queued request takes it
  on the same step.
- **Streaming**: tokens stream to a per-request ``GenerationStream``.
- ``paging=PagedKVConfig(...)`` makes the KV storage block-paged
  (``serving/paging.py``): capacity is a token budget, admission checks
  a request's worst-case pages against the free pool, and decode runs
  directly on the pool: each step appends one token per row in place
  and attends through the page table with the hand-written CUDA
  paged-attention kernel (``serving/paged_kernel.py``; its plain
  version on the CPU). ``prefix_cache=True`` (default) primes shared
  full-block prompt prefixes once (``serving/prefix_cache.py``).
- ``PagedKVConfig(kv_dtype="int8")`` stores the pool as int8 with
  per-(page, kv-head) power-of-two scales (``serving/quant.py``): every
  request primes through the pool (quantize-once: the prompt's pool
  bytes come from the same quantized append the decode steps run), a
  prefix hit starts past the shared pages in place, and each decode
  step appends int8 K/V and attends with the int8 paged-decode kernel.
  ``total_bytes=`` buys about twice the pages; ``kv_dtype="auto"``
  takes int8 only where the measured store says it wins on this card
  (``tuning/plan.resolve_kv_dtype``).
- ``speculation=SpeculationConfig(draft, gamma)`` folds speculative
  decoding into the decode loop: each step the host ``draft`` (e.g.
  ``util.decoding.prompt_lookup_proposer()``) proposes up to gamma
  tokens per active slot and ONE widened ``[S, V, 1+gamma]`` verify
  forward scores them all, through the paged-attention kernels at
  query width 1 + gamma on a page pool; each row's rejection walk
  (``util.decoding.accept_proposals``) commits its accepted prefix and
  one more token, and a per-row rewind (``rewind_stream_state``'s, in
  place on the shared ``kv_pos``) drops the rejected positions (free
  rows rewind the whole width). Greedy streams equal plain
  ``sample_stream``'s; sampled ones keep the target's distribution and
  draw each request's rng in the JAX engine's order.
- The text LSTM (``TextGenerationLSTM``'s ``MultiLayerNetwork``) serves
  in the slot arena: each GravesLSTM's h / c rows are joined at
  admission, and every decode step runs the LSTM forward kernel once a
  layer at batch S. Its refusals are the JAX engine's: a page pool's
  int8 storage or prefix cache, and speculation (h / c cannot rewind).

Survivability and observability:

- ``supervisor=EngineSupervisor(...)`` replaces the terminal fail-all
  with request-preserving recovery: a step-cycle fault quarantines the
  arena (pool tensors, scale sidecars, tables and the views in
  ``net.state`` all released) and rebuilds it from the host-side request
  ledger, re-priming every in-flight request; a windowed
  ``RestartBudget`` bounds the rebuild rate and escalates to ``_break``.
- the chaos seams: ``prefill_chaos`` fires before each admission's
  prime (a raise fails THAT request only), ``seat_chaos`` in the
  pop-to-seat window, and ``decode_chaos`` before each decode or verify
  dispatch INSIDE the optional ``decode_retry`` policy (the fault fires
  before any state mutates, so a retried dispatch is the fault-free
  one). The admission seams pass the request as the event's context.
- ``overload=OverloadConfig(...)``: sustained-breach shedding of
  low-priority queued work (``ServingOverloaded``), deadline-based early
  rejection at submit, and the page-pressure brownout ladder (reduced
  gamma, then speculation off, then no prefix-cache inserts; the verify
  width stays 1 + gamma at every rung).
- ``drain(timeout)`` stops admission and finishes the actives.
- the request ledger (``export_ledger`` / ``admit_from_ledger``): every
  in-flight request exports as a versioned ``RequestLedgerEntry`` in the
  JAX package's wire form and re-admits on this or another engine.
- ``registry=`` / ``name=``: the ``dl4jtpu_serving_*`` series
  (``serving/health.py``), handles resolved at construction and fed once
  a step; ``health()``; request traces; a flight record at ``_break``.

Greedy (top_k=1) outputs equal one-shot ``sample_stream`` with the same
rng (tested): the arena feeds each request exactly the token sequence a
dedicated stream would, and each request draws from its own rng in
generation order.

The decode step as one CUDA graph (the JAX engine's one jitted dispatch
a step): on a CUDA device every decode and verify dispatch is one replay
of a graph captured per query width (1, or 1 + gamma) over the arena's
fixed tensors: the page pools and int8 scale sidecars, the ``[S,
n_max]`` page table (its rows written in place at admission and
retirement), each layer's ``kv_pos`` (reset, advanced and rewound in
place) and the LSTM ``h`` / ``c`` rows. The graph holds the one-hot of
a static token buffer (one host-to-device copy before each replay), the
forward through the paged view with its in-place KV append, the state's
new leaves copied back into the fixed ones, and the f32 head; one
device-to-host copy of the distributions follows, and the draws stay on
the host. The host half of ``rnn_time_step`` (the streaming budget, the
position mirrors) runs around each replay. A rebuild, or the arena's
first build, drops the graphs (their private pools with them) and the
next step captures anew (``dl4jtpu_jit_compiles_total``); so does a new
compute copy of the parameters. A failed capture or replay is a
dispatch fault like any other: the step never re-runs eagerly. On the
CPU the same device part runs eagerly.

Speculation drafted by a second network is the one-shot
``util.decoding.speculative_sample`` (the JAX engine refuses a network
draft too), beside ``speculative_beam_search``. Not ported: the choice
of decode read path (``decode_impl``: the port has one on the card, the
kernel). ``sample_stream_batch`` waits for masked streaming (ROADMAP.md
A6). The fleet's hooks (``detach_ledger``, ``detach_queued``,
``load_stats``, the prefix chain export and import) come with the fleet
(ROADMAP.md A10).
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.monitoring import flightrecorder
from deeplearning4j_tpu_torch.monitoring.events import emit as emit_event
from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)
from deeplearning4j_tpu_torch.monitoring.runtime import record_capture
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BATCHED_STREAM_KEYS, PositionalEmbeddingLayer, check_rewindable,
    stream_capacity)
from deeplearning4j_tpu_torch.nn.network_base import _collector_paused
from deeplearning4j_tpu_torch.nn.updater import tree_leaves
from deeplearning4j_tpu_torch.resilience.chaos import fire as _fire_chaos
from deeplearning4j_tpu_torch.resilience.retry import RetryPolicy, retry_call
from deeplearning4j_tpu_torch.serving.errors import (
    EngineShutdown, InferenceTimeout, RequestCancelled, ServingOverloaded,
    ServingQueueFull)
from deeplearning4j_tpu_torch.serving.health import (
    SERVING_ACTIVE_SLOTS, SERVING_BROWNOUT_LEVEL,
    SERVING_DEADLINE_EXCEEDED, SERVING_DISPATCH_LATENCY, SERVING_DRAINING,
    SERVING_EARLY_REJECTED, SERVING_ERRORS, SERVING_KV_BYTES_MOVED,
    SERVING_KV_PAGES_TOTAL, SERVING_KV_PAGES_USED, SERVING_PREFIX_HITS,
    SERVING_PREFIX_MISSES, SERVING_PREFIX_REUSED_TOKENS,
    SERVING_QUEUE_REJECTED, SERVING_QUEUE_WAIT, SERVING_REQUESTS,
    SERVING_SHED, SERVING_SPEC_ACCEPTANCE, SERVING_TOKENS, SERVING_TPOT,
    SERVING_TTFT, register_serving_metrics, scrape_probe)
from deeplearning4j_tpu_torch.serving.overload import (
    BROWNOUT_NO_PREFIX_INSERTS, BROWNOUT_NO_SPECULATION,
    BROWNOUT_REDUCED_GAMMA, OverloadConfig, OverloadController)
from deeplearning4j_tpu_torch.serving.paging import (
    PagedKVConfig, PagePool, gather_pages, pages_needed)
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.quant import kv_page_bytes, pool_leaves
from deeplearning4j_tpu_torch.serving.request import (
    GenerationRequest, GenerationStream, RequestLedgerEntry)
from deeplearning4j_tpu_torch.serving.scheduler import AdmissionQueue
from deeplearning4j_tpu_torch.util.decoding import (
    _check_seed, _stream_layers, _vocab, accept_proposals, draw,
    filter_probs, prime_prompt, stop_reason)

__all__ = ["GenerationEngine", "SpeculationConfig"]

log = logging.getLogger(__name__)

#: stream-state keys the admission join writes into the arena row
_SCATTER_KEYS = frozenset(BATCHED_STREAM_KEYS | {"kv_pos"})
_PAGED_VIEW = {"kv_k": "kv_page_k", "kv_v": "kv_page_v"}
_SCALE_VIEW = {"kv_k": "kv_page_scale_k", "kv_v": "kv_page_scale_v"}
#: the keys of the paged view the engine installs around a forward
_VIEW_KEYS = frozenset({*_PAGED_VIEW.values(), *_SCALE_VIEW.values(),
                        "kv_page_table", "kv_page_prime"})
#: latency samples kept per plain-attribute window (ttft_s, tpot_s)
METRIC_WINDOW = 4096


@dataclass
class SpeculationConfig:
    """In-engine speculative decoding (the JAX package's).

    ``draft`` is a HOST proposer callable ``(ids, gamma) -> proposals``
    (e.g. ``util.decoding.prompt_lookup_proposer()``): no extra device
    work, applied per active slot each step. ``gamma`` caps the
    proposals a slot makes a step; the verify forward has the fixed
    ``[S, V, 1+gamma]`` width whatever each row proposed (short rows
    pad with dummies that causality hides and the per-row rewind
    drops). Drafting with a second network is the one-shot
    ``util.decoding.speculative_sample`` (as in the JAX package, the
    engine refuses a network draft)."""

    draft: Callable
    gamma: int = 4

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if hasattr(self.draft, "rnn_time_step") or \
                not callable(self.draft):
            raise TypeError(
                "in-engine speculation takes a host proposer callable "
                "(ids, gamma) -> proposals, e.g. "
                "util.decoding.prompt_lookup_proposer(); to draft with "
                "a network use the one-shot "
                "util.decoding.speculative_sample(net, draft, ...)")


class GenerationEngine:
    """Continuous-batching generation over a fixed S-slot arena.

    Drive it manually (``submit()`` then ``step()`` /
    ``run_until_idle()``) or start the background loop (``start()`` /
    ``shutdown()``) and consume ``GenerationStream`` handles from any
    thread. ``device`` defaults to ``"cuda"`` and must be the net's.

    ``prime_padded`` is accepted for the JAX signature and changes no
    result: the port primes each prompt unpadded in one chunk, which
    computes what the JAX package's masked, left-padded bucket prime
    computes (eager PyTorch has no shapes to bound)."""

    def __init__(self, net, vocab_size: int, slots: int = 8,
                 queue_limit: int = 64, queue_policy: str = "block",
                 prime_padded: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 name: Optional[str] = None,
                 prefill_chaos=None, decode_chaos=None, seat_chaos=None,
                 decode_retry: Optional[RetryPolicy] = None,
                 paging: Optional[PagedKVConfig] = None,
                 speculation: Optional["SpeculationConfig"] = None,
                 supervisor=None, overload=None, device=None):
        if not hasattr(net, "rnn_time_step"):
            raise TypeError("GenerationEngine needs a streaming net "
                            "(rnn_time_step / rnn_clear_previous_state)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        if not net._initialized:
            net.init(self.device)
        if resolve_device(net.device) != self.device:
            raise ValueError(f"net lives on {net.device}, engine device "
                             f"is {self.device}")
        net_inputs = getattr(net.conf, "network_inputs", None)
        if net_inputs is not None and len(net_inputs) != 1:
            raise ValueError("GenerationEngine serves single-input "
                             "decoder graphs only")
        n_in = _vocab(net)
        if vocab_size != n_in:
            raise ValueError(f"vocab_size {vocab_size} != the net's input "
                             f"size {n_in}")
        layers = list(_stream_layers(net))
        if any(isinstance(l, PositionalEmbeddingLayer) for l in layers):
            raise ValueError(
                "continuous batching needs per-slot positions: learned "
                "positional tables carry a shared pos_offset (use a rope, "
                "position-free or recurrent model)")
        recurrent = any(getattr(l, "carries_recurrent_state", False)
                        for l in layers)
        self._speculation = speculation
        if speculation is not None:
            # a verify rewinds up to its whole width (gamma + 1: a free
            # row keeps nothing); h / c cannot rewind
            check_rewindable(net, speculation.gamma + 1)
        self.net = net
        self.V = int(vocab_size)
        self.slots = int(slots)
        self._cap = stream_capacity(layers)
        del prime_padded        # the port primes unpadded (see above)
        self._label = name or f"engine:{type(net).__name__}"
        self._graph_vertices = tuple(
            n for n, v in (getattr(net.conf, "vertices", None) or {}).items()
            if getattr(getattr(v, "layer", None), "supports_streaming",
                       False))
        self._pending = AdmissionQueue(queue_limit, queue_policy)
        self._slots: List[Optional[GenerationRequest]] = [None] * slots
        self._row_pos = np.zeros(slots, np.int64)
        self._arena_ready = False
        self._merge_keys = None
        # -- block-paged KV arena ---------------------------------------
        self._pool: Optional[PagePool] = None
        self._prefix: Optional[PrefixCache] = None
        self._page_store = None            # pools, one per paged leaf
        self._scale_store = None           # int8: [P, Hkv] f32 per leaf
        self._paged_keys = None            # [(layer name, kv_k|kv_v)]
        #: the pool's storage ("bf16": the net's own KV dtype; "int8":
        #: serving/quant.py) and the paged_decode_quant store key that
        #: kv_dtype="auto" consulted (None unless int8 or auto was asked)
        self._kv_dtype = "bf16"
        self._quant_key: Optional[str] = None
        self._quant_dims = None
        self._page_tables: List[List[int]] = [[] for _ in range(slots)]
        #: the [S, n_max] int32 device table, made with the pool's store
        #: and kept: admission and retirement write its rows in place (a
        #: decode graph reads it at a fixed address); a rebuild makes a
        #: new one
        self._table_dev = None
        #: a retirement freed a slot whose kv_pos keeps coasting (+1 per
        #: dispatch): the next dispatch zeroes free rows' positions in
        #: place so an idle slot that once held a long context does not
        #: make the kernel walk its dead pages every step
        self._kv_pos_dirty = False
        #: the decode-step CUDA graphs by query width (the card only),
        #: the stream they are captured and replayed on, and the captures
        #: taken (each also counted in dl4jtpu_jit_compiles_total)
        self._graphs = {}
        self._graph_stream = None
        self.graph_captures = 0
        #: modeled KV bytes (serving/health.SERVING_KV_BYTES_MOVED): the
        #: running total, the bytes of one position over every leaf, and
        #: an int8 pool's scale row over every leaf
        self._kv_bytes_total = 0
        self._tok_bytes = 0
        self._scale_row_bytes = 0
        if paging is not None:
            kv_layers = [l for l in layers
                         if getattr(l, "supports_streaming", False)
                         and getattr(l, "cache_length", 0)]
            if not kv_layers:
                raise ValueError(
                    "block-paged KV needs attention KV streaming state "
                    "(a layer with cache_length > 0): a pure-recurrent "
                    "net has no per-token pages to manage")
            lens = {int(l.cache_length) for l in kv_layers}
            if len(lens) != 1:
                raise ValueError(f"block-paged KV needs one shared "
                                 f"cache_length, got {sorted(lens)}")
            self._L = lens.pop()
            self._ps = paging.page_size
            self._n_max = -(-self._L // self._ps)
            # kv_dtype before pool sizing: a byte budget depends on it
            l0 = kv_layers[0]
            native = getattr(net.conf, "dtype", None) or "float32"
            kv_dtype = paging.kv_dtype
            if kv_dtype != "bf16":
                from deeplearning4j_tpu_torch.tuning.plan import (
                    quant_key_for_engine, resolve_kv_dtype)
                self._quant_key = quant_key_for_engine(
                    self._ps, l0.n_out // l0.n_heads,
                    getattr(l0, "n_kv_heads", None) or l0.n_heads,
                    self._L, native)
                if kv_dtype == "auto":
                    # eligible: no recurrent h / c (the JAX gate)
                    kv_dtype = resolve_kv_dtype(not recurrent,
                                                self._quant_key,
                                                device=self.device)
            if kv_dtype == "int8" and recurrent:
                raise ValueError(
                    "kv_dtype='int8' quantizes position-indexed KV pages "
                    "only; recurrent h/c state is a function of the whole "
                    "prefix and cannot re-prime through the paged path "
                    "(use kv_dtype='bf16', or a pure-attention model)")
            self._kv_dtype = kv_dtype
            dims = self._paged_layer_dims()
            if paging.total_bytes is not None:
                usable = paging.resolve_pages_bytes(kv_page_bytes(
                    [(h, d) for _, h, d in dims], self._ps, kv_dtype,
                    native))
            else:
                usable = paging.resolve_pages(slots, self._n_max)
            self._pool = PagePool(usable + 1, self._ps)   # +1: null page
            if paging.prefix_cache:
                if recurrent:
                    raise ValueError(
                        "the prefix cache reuses position-indexed KV pages "
                        "only; recurrent h/c state is a function of the "
                        "whole prefix and lives outside the pages: "
                        "construct with PagedKVConfig(prefix_cache=False)")
                self._prefix = PrefixCache(self._pool)
            if kv_dtype == "int8":
                # built eagerly: the int8 prime writes through the pool,
                # so it exists before the first admission
                self._quant_dims = dims
                self._init_quant_store()
        # -- chaos seams, retry, survivability ----------------------------
        self._prefill_chaos = prefill_chaos
        self._decode_chaos = decode_chaos
        self._seat_chaos = seat_chaos
        self._decode_retry = decode_retry
        self._supervisor = supervisor
        if isinstance(overload, OverloadConfig):
            overload = OverloadController(overload)
        self._overload: Optional[OverloadController] = overload
        if overload is not None:
            overload._bind(self)
        self._brownout = 0
        self._draining = False
        # -- plain metrics (the registry's series carry the rest) --------
        self.admissions = 0
        self.dispatches = 0
        self.dispatch_s_total = 0.0
        self.tokens_generated = 0
        self.ttft_s = deque(maxlen=METRIC_WINDOW)
        self.tpot_s = deque(maxlen=METRIC_WINDOW)
        #: speculation: the totals of proposed and accepted drafts
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: a request popped from the queue but not yet seated: a fault in
        #: that window fails (or recovers) it instead of stranding it
        self._seating: Optional[GenerationRequest] = None
        #: traces of recently retired requests: the flight recorder's
        #: "last requests" context when the engine breaks
        self._recent_traces = deque(maxlen=16)
        #: this engine's recent lifecycle events (health() reads this,
        #: not a scan of the global ring)
        self._own_events = deque(maxlen=10)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._broken: Optional[BaseException] = None
        # ONE lock serializes every arena/net touch
        self._lock = threading.RLock()
        net.rnn_clear_previous_state()     # the engine owns the stream
        self._register_metrics(registry)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _register_metrics(self, registry) -> None:
        """The JAX engine's series, names, help and labels; every handle
        resolved here, so a step feeds each series with one inc or
        observe (``observe_many``) and never a lookup."""
        r = registry or global_registry()
        self._handles = register_serving_metrics(self, self._label,
                                                 registry)
        lab = dict(model=self._label)
        self._tokens = r.counter(
            SERVING_TOKENS, "Tokens generated by the serving engine",
            ("model",)).labels(**lab)
        self._ttft_hist = r.histogram(
            SERVING_TTFT, "Seconds from submit to first token",
            ("model",)).labels(**lab)
        self._tpot_hist = r.histogram(
            SERVING_TPOT, "Seconds between consecutive tokens of one "
            "request", ("model",)).labels(**lab)
        self._queue_wait_hist = r.histogram(
            SERVING_QUEUE_WAIT, "Seconds a request waited for admission",
            ("model",)).labels(**lab)
        self._dispatch_hist = r.histogram(
            SERVING_DISPATCH_LATENCY, "Wall seconds per decode/verify "
            "dispatch cycle (paged modes include the KV path around it)",
            ("model",)).labels(**lab)
        if self._pool is not None:
            self._kv_bytes = r.counter(
                SERVING_KV_BYTES_MOVED, "Modeled bytes the KV path "
                "moves between the page pool and the dispatch (legacy: "
                "full gather+scatter round trip; direct: in-dispatch "
                "read + one-token append)", ("model",)).labels(**lab)
        r.gauge(SERVING_ACTIVE_SLOTS, "Arena slots holding an active "
                "request", ("model",)).set_function(
            scrape_probe(self, lambda s: s.active_slots()),
            model=self._label)
        if self._pool is not None:
            r.gauge(SERVING_KV_PAGES_TOTAL, "Allocatable KV pages in "
                    "the paged arena's pool", ("model",)).set_function(
                scrape_probe(self, lambda s: s._pool.usable),
                model=self._label)
            r.gauge(SERVING_KV_PAGES_USED, "KV pages currently held by "
                    "slots or the prefix cache", ("model",)).set_function(
                scrape_probe(self, lambda s: s._pool.used_count()),
                model=self._label)
        if self._prefix is not None:
            self._prefix_hits = r.counter(
                SERVING_PREFIX_HITS, "Admissions that reused >= 1 "
                "cached prefix block", ("model",)).labels(**lab)
            self._prefix_misses = r.counter(
                SERVING_PREFIX_MISSES, "Admissions that reused no "
                "cached prefix block", ("model",)).labels(**lab)
            self._prefix_reused = r.counter(
                SERVING_PREFIX_REUSED_TOKENS, "Prompt tokens whose "
                "prefill was skipped via cached pages",
                ("model",)).labels(**lab)
        if self._speculation is not None:
            self._spec_accept_hist = r.histogram(
                SERVING_SPEC_ACCEPTANCE, "Per-slot fraction of draft "
                "proposals accepted by a verify dispatch",
                ("model",)).labels(**lab)
        r.gauge(SERVING_DRAINING, "Engine draining: admission stopped, "
                "actives finishing (1) or serving normally (0)",
                ("model",)).set_function(
            scrape_probe(self, lambda s: 1.0 if s._draining else 0.0),
            model=self._label)
        if self._supervisor is not None:
            self._supervisor._bind(self, registry)
        if self._overload is not None:
            self._shed_counter = r.counter(
                SERVING_SHED, "Queued requests shed under a sustained "
                "SLO breach", ("model",)).labels(**lab)
            self._early_rejected = r.counter(
                SERVING_EARLY_REJECTED, "Submits refused because their "
                "deadline provably cannot be met",
                ("model",)).labels(**lab)
            r.gauge(SERVING_BROWNOUT_LEVEL, "Brownout ladder rung: 0 "
                    "off, 1 reduced gamma, 2 speculation off, 3 prefix "
                    "inserts off", ("model",)).set_function(
                scrape_probe(self, lambda s: float(s._brownout)),
                model=self._label)

    @property
    def label(self) -> str:
        """The model label this engine's telemetry and events carry."""
        return self._label

    @property
    def trace_identity(self) -> str:
        """The identity request traces record per lifecycle event: the
        model label (a fleet's replica suffix comes with ROADMAP.md
        A10)."""
        return self._label

    def _emit_serving_event(self, name: str, **attrs) -> None:
        """Publish one serving-lifecycle event under this engine's trace
        identity and mirror it into the bounded tail ``health()``
        serves (the supervisor emits its rebuild and escalate events
        through this too)."""
        ev = emit_event("serving", name, engine=self.trace_identity,
                        **attrs)
        if ev is not None:
            self._own_events.append({"name": ev.name, "wall": ev.wall,
                                     "attrs": dict(ev.attrs)})

    # ------------------------------------------------------------------
    # health / readiness
    # ------------------------------------------------------------------
    def is_healthy(self) -> bool:
        if self._broken is not None or self._stop.is_set():
            return False
        return self._worker is None or self._worker.is_alive()

    def is_ready(self) -> bool:
        return self.is_healthy() and not self._draining \
            and not self._pending.full()

    def queue_depth(self) -> int:
        return self._pending.depth()

    def active_slots(self) -> int:
        return sum(r is not None for r in self._slots)

    def _decode_path(self) -> str:
        """The port's one paged read path: the CUDA kernel on a CUDA
        device, its plain version on the CPU."""
        return "direct-cuda" if self.device.type == "cuda" \
            else "direct-plain"

    def health(self) -> dict:
        out = {"healthy": self.is_healthy(), "ready": self.is_ready(),
               "label": self.trace_identity,
               "pid": os.getpid(),
               "queue_depth": self.queue_depth(),
               "active_slots": self.active_slots(),
               "slots": self.slots,
               "decode_dispatch": {
                   "count": self.dispatches,
                   "mean_ms": round(self.dispatch_s_total * 1e3
                                    / max(1, self.dispatches), 3)}}
        if self._pool is not None:
            out["kv_pages"] = {"total": self._pool.usable,
                               "used": self._pool.used_count(),
                               "free": self._pool.free_count(),
                               "page_size": self._pool.page_size}
            out["kv_traffic"] = {
                "decode_path": self._decode_path(),
                "kv_dtype": self._kv_dtype,
                "bytes_moved_total": self._kv_bytes_total,
                "dispatches": self.dispatches,
            }
        if self._prefix is not None:
            out["prefix_cache"] = {"entries": len(self._prefix),
                                   "hits": self._prefix.hits,
                                   "misses": self._prefix.misses,
                                   "reused_tokens":
                                       self._prefix.reused_tokens}
        if self._speculation is not None:
            out["speculation"] = {"gamma": self._speculation.gamma}
        if self._draining:
            out["draining"] = True
        if self._supervisor is not None:
            out["supervisor"] = self._supervisor.health()
        if self._overload is not None:
            out["overload"] = {
                "brownout_level": self._brownout,
                "shed_total": self._overload.shed_total,
                "early_rejected_total":
                    self._overload.early_rejected_total,
            }
        out["last_events"] = list(self._own_events)
        return out

    @property
    def page_pool(self) -> Optional[PagePool]:
        """The paged arena's pool (None in slot-arena mode): the seam
        ``resilience.chaos.PageExhaustionInjector`` drives."""
        return self._pool

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        return self._prefix

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt, steps: int, *, temperature: float = 1.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               stop_tokens=(), rng=None, timeout: Optional[float] = None,
               priority: int = 0,
               max_length: Optional[int] = None) -> GenerationStream:
        """Queue one prompt for up to `steps` generated tokens; returns
        its streaming handle at once. Arguments mirror ``sample_stream``
        (same rng, same stop semantics, `max_length` defaulting to the
        net's streaming capacity) plus `timeout` (end-to-end deadline in
        seconds) and `priority` (higher admitted first)."""
        if self._broken is not None:
            raise EngineShutdown(f"GenerationEngine is broken: "
                                 f"{self._broken!r}")
        if self._stop.is_set():
            raise EngineShutdown("GenerationEngine shut down")
        if self._draining:
            raise EngineShutdown("GenerationEngine draining: submit to "
                                 "the replacement instance")
        prompt = [int(t) for t in prompt]
        if max_length is None:
            max_length = self._cap
        _check_seed(prompt, steps, max_length)
        if self._cap is not None and len(prompt) > self._cap:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds the "
                             f"net's streaming capacity ({self._cap})")
        want = len(prompt) + int(steps)
        if max_length is not None:
            want = min(want, int(max_length))
        spec = self._speculation
        if spec is not None and self._cap is not None \
                and want > self._cap - spec.gamma + 1:
            raise ValueError(
                f"prompt + steps ({want} ids) needs speculative "
                f"headroom: every verify transiently takes 1 + gamma "
                f"positions, so in-engine speculation serves at most "
                f"capacity - gamma + 1 = {self._cap - spec.gamma + 1} ids")
        if self._pool is not None:
            store = self._store_positions(want)
            if pages_needed(store, self._ps) > self._pool.usable:
                raise ValueError(
                    f"prompt + steps would hold {store} KV positions "
                    f"({pages_needed(store, self._ps)} pages of "
                    f"{self._ps} tokens) but the pool has only "
                    f"{self._pool.usable} pages: it can never be admitted")
        self._handles[SERVING_REQUESTS].inc()
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        req = GenerationRequest(
            prompt, steps, temperature=temperature, top_k=top_k,
            top_p=top_p, stop_tokens=stop_tokens, rng=rng,
            max_length=max_length, deadline=deadline, priority=priority)
        if self._overload is not None:
            reason = self._overload.reject_at_submit(
                self, req, time.monotonic())
            if reason is not None:
                self._early_rejected.inc()
                req.trace.record("early_reject", reason=reason)
                self._emit_serving_event("early_reject")
                raise ServingOverloaded(reason)
        try:
            self._pending.submit(req)
        except ServingQueueFull:
            self._handles[SERVING_QUEUE_REJECTED].inc()
            raise
        except InferenceTimeout:
            self._handles[SERVING_DEADLINE_EXCEEDED].inc()
            raise
        return req.handle

    # ------------------------------------------------------------------
    # the step cycle
    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One engine cycle: expire/cancel, shed under overload, admit
        into free slots, one decode (or widened verify) forward over the
        arena, sample + stream + retire. Returns whether any progress
        was made (False = idle).

        The whole cycle past reaping is one failure domain: a fault
        anywhere (the pop-to-seat window included) lands where the
        supervisor, if any, can quarantine and rebuild the arena from
        the request ledger; without one, or with its budget spent, the
        engine falls to the terminal ``_break``."""
        with self._lock:
            if self._stop.is_set() or self._broken is not None:
                return False
            now = time.monotonic()
            progress = self._reap(now) > 0
            try:
                if self._overload is not None:
                    progress = self._apply_overload(now) or progress
                if not self._draining:
                    progress = self._admit_ready(now) > 0 or progress
                active = [s for s, r in enumerate(self._slots)
                          if r is not None]
                if not active:
                    return progress
                if self._speculation is not None:
                    self._step_speculative(active)
                else:
                    self._step_plain(active)
            except Exception as e:  # noqa: BLE001 — fail waiters, not hang
                self._handles[SERVING_ERRORS].inc()
                if self._recover(e):
                    return True
                self._break(e)
                return False
            return True

    def _recover(self, exc: BaseException) -> bool:
        """Hand a step-cycle fault to the supervisor (if any): True = the
        arena was rebuilt and every in-flight request re-admitted."""
        if self._supervisor is None:
            return False
        cause = ("admission_fault" if self._seating is not None
                 else "decode_fault")
        return self._supervisor.on_dispatch_fault(self, exc, cause)

    def _apply_overload(self, now: float) -> bool:
        """One overload-control tick before admission: shed queued work
        under a sustained SLO breach, refresh the brownout rung from
        page pressure."""
        ov = self._overload
        victims = ov.shed(self)
        for req in victims:
            self._shed_counter.inc()
            req.trace.record("shed", engine=self.trace_identity)
            req.handle._fail(ServingOverloaded(
                "shed from the admission queue under a sustained "
                "latency-SLO breach (lowest-priority first)"))
        if victims:
            self._emit_serving_event("shed", victims=len(victims))
        prev = self._brownout
        self._brownout = ov.brownout_level(self)
        if self._brownout != prev:
            self._emit_serving_event("brownout", level=self._brownout,
                                     prev=prev)
        return bool(victims)

    def _commit(self, req: GenerationRequest, tokens, now: float,
                tpots: list) -> Optional[str]:
        """Stream ``tokens`` (one step's commits of one row) to ``req``:
        its TPOT samples go to ``tpots`` (observed once a step), and the
        first stop reason met ends the commit."""
        reason = None
        for tok in tokens:
            if req.last_token_t is not None:
                tpots.append(now - req.last_token_t)
            req.last_token_t = now
            req.handle._push(tok)
            self.tokens_generated += 1
            reason = stop_reason(tok, len(req.handle._ids), req.want,
                                 req.stop_tokens)
            if reason:
                break
        return reason

    def _observe_step(self, n_tokens: int, tpots: list) -> None:
        """A step's token and TPOT samples: one registry entry each."""
        self.tpot_s.extend(tpots)
        self._tpot_hist.observe_many(tpots)
        if n_tokens:
            self._tokens.inc(n_tokens)

    def _step_plain(self, active) -> None:
        """One [S, V, 1] decode forward + one host draw per row."""
        probs = self._dispatch_step()
        now = time.monotonic()
        t0, tpots = self.tokens_generated, []
        for s in active:
            req = self._slots[s]
            if req is None:        # retired by the capacity guard
                continue
            tok = draw(probs[s], req.temperature, req.rng,
                       top_k=req.top_k, top_p=req.top_p)
            reason = self._commit(req, (tok,), now, tpots)
            req.trace.rollup(1)
            if reason:
                self._retire(s, reason)
            else:
                req.pending_token = tok
        self._observe_step(self.tokens_generated - t0, tpots)

    def _step_speculative(self, active) -> None:
        """One widened ``[S, V, 1+gamma]`` verify forward: the host draft
        proposes per slot, the target scores each row's pending token and
        proposals in ONE forward, each row commits its accepted prefix
        and one replacement or bonus token (``accept_proposals``), and a
        per-row rewind drops the rejected positions: ``gamma - accepted``
        of a row that verified, the whole width of a free row. The
        brownout ladder caps the proposals (``g_cap``): a reduced or zero
        gamma pads the SAME widened forward with fewer real proposals."""
        k = self._speculation.gamma
        g_cap = k
        if self._brownout >= BROWNOUT_NO_SPECULATION:
            g_cap = 0
        elif self._brownout >= BROWNOUT_REDUCED_GAMMA:
            g_cap = self._overload.brownout_gamma(k)
        if self._cap is not None:
            for s in active:
                if self._slots[s] is not None \
                        and self._row_pos[s] >= self._cap:
                    self._retire(s, "capacity")
        chunk = np.zeros((self.slots, 1 + k), np.int64)
        props: List[List[int]] = [[] for _ in range(self.slots)]
        riders = []
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            riders.append(s)
            g = min(g_cap, req.want - len(req.handle._ids))
            # g <= 0 (rung 2+, or one token wanted): no host draft
            p = ([int(t) for t in self._speculation.draft(
                list(req.handle._ids), g)][:g] if g > 0 else [])
            props[s] = p
            chunk[s, 0] = req.pending_token
            chunk[s, 1:1 + len(p)] = p
        if not riders:
            return                 # everything retired at the guard
        self._sync_accounting()
        tp = self._run_dispatch(chunk)
        now = time.monotonic()
        t0, tpots, fracs = self.tokens_generated, [], []
        amounts = np.full(self.slots, 1 + k, np.int64)   # free rows: all
        for s in riders:
            req = self._slots[s]
            g = len(props[s])
            p_dists = [filter_probs(tp[s, :, j], req.temperature,
                                    req.top_k, req.top_p)
                       for j in range(g)]
            p_bonus = filter_probs(tp[s, :, g], req.temperature,
                                   req.top_k, req.top_p)
            accepted, nxt = accept_proposals(props[s], p_dists, [None] * g,
                                             p_bonus, req.rng)
            if g:
                fracs.append(accepted / g)
                self.spec_proposed += g
                self.spec_accepted += accepted
            committed = props[s][:accepted] + [nxt]
            req.trace.rollup(len(committed), accepted=accepted,
                             proposed=g)
            self._row_pos[s] += 1 + accepted
            amounts[s] = k - accepted
            reason = self._commit(req, committed, now, tpots)
            if reason:
                self._retire(s, reason)
            else:
                req.pending_token = committed[-1]
        self._spec_accept_hist.observe_many(fracs)
        self._observe_step(self.tokens_generated - t0, tpots)
        self._rewind_rows(amounts)
        self._sync_accounting()

    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Drive ``step()`` until nothing is active or admissible.
        Returns the number of cycles taken."""
        n = 0
        while self.step():
            n += 1
            if n >= max_steps:
                raise RuntimeError(f"engine still busy after {n} steps")
        return n

    def _reap(self, now: float) -> int:
        """Retire expired/cancelled requests, active and queued."""
        n = 0
        for req in self._pending.reap(now):
            n += 1
            if req.handle.cancelled:
                req.handle._fail(RequestCancelled(
                    "request cancelled while queued"), reason="cancelled")
            else:
                self._handles[SERVING_DEADLINE_EXCEEDED].inc()
                req.handle._fail(InferenceTimeout(
                    "deadline expired in the admission queue"))
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            if req.handle.cancelled:
                self._retire(s, "cancelled",
                             RequestCancelled("request cancelled"))
                n += 1
            elif req.deadline is not None and now >= req.deadline:
                self._handles[SERVING_DEADLINE_EXCEEDED].inc()
                self._retire(s, "error", InferenceTimeout(
                    "deadline expired mid-generation "
                    f"({len(req.handle._ids) - len(req.prompt)} tokens "
                    "streamed)"))
                n += 1
        return n

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _store_positions(self, want: int) -> int:
        """KV positions a request of `want` total ids holds at worst
        (the final drawn token never re-enters the cache), plus, under
        speculation, the gamma positions past it a verify writes before
        its rewind, so a widened append never writes past the row's
        pages: the one formula behind the never-fits rejection, the
        head-of-line gate and the page reservation."""
        store = want - 1
        if self._speculation is not None:
            store += self._speculation.gamma
        return store if self._cap is None else min(store, self._cap)

    def _pages_admissible(self, req: GenerationRequest) -> bool:
        """Admit the head request only when its full reservation fits the
        free pool plus what the prefix cache could evict."""
        store = self._store_positions(req.want)
        avail = self._pool.free_count() + (
            self._prefix.evictable_pages() if self._prefix is not None
            else 0)
        return pages_needed(store, self._ps) <= avail

    def _admit_ready(self, now: float) -> int:
        """Fill free slots from the admission queue in priority order
        (paged: while the head request's pages fit). Every popped
        request is pinned to ``self._seating`` until it is seated or
        carries a terminal event, so a fault in the pop-to-seat window
        cannot strand its handle."""
        n = 0
        gate = self._pages_admissible if self._pool is not None else None
        while None in self._slots:
            req = self._pending.pop(admissible=gate)
            if req is None:
                break
            self._seating = req
            n += 1
            if self._fail_if_dead(req, now, "in the admission queue"):
                self._seating = None
                continue
            _fire_chaos(self._seat_chaos, self.admissions, ctx=req)
            req.trace.record("queue_pop", engine=self.trace_identity)
            req.handle.queue_wait_s = now - req.submit_t
            self._queue_wait_hist.observe(req.handle.queue_wait_s)
            if self._overload is not None:
                self._overload.observe_queue_wait(req.handle.queue_wait_s)
            # a popped request that already streamed is a ledger survivor
            # riding the queue: it re-primes instead of admitting fresh
            self._admit_one(req, self._slots.index(None),
                            readmit=req.streamed)
            self._seating = None
        return n

    def _fail_if_dead(self, req, now: float, where: str) -> bool:
        """Give `req` its terminal event if it was cancelled or its
        deadline passed (or it already carries one); True means skip it.
        The one gate the admission pop and the rebuild share."""
        if req.handle.done:
            return True
        if req.handle.cancelled:
            req.handle._fail(RequestCancelled(
                f"request cancelled {where}"), reason="cancelled")
            return True
        if req.deadline is not None and now >= req.deadline:
            self._handles[SERVING_DEADLINE_EXCEEDED].inc()
            req.handle._fail(InferenceTimeout(f"deadline expired {where}"))
            return True
        return False

    def _alloc_request_pages(self, req: GenerationRequest):
        """Reserve the request's worst-case pages: map the longest cached
        full-block prefix (shared, refcount + 1), evict unmapped cache
        entries if the fresh allocation falls short, allocate the rest.
        Returns ``(table, hit_len)``."""
        hit_len, shared = 0, []
        if self._prefix is not None:
            if self._page_store is not None:
                hit_len, shared = self._prefix.lookup(req.prompt)
            else:
                self._prefix.misses += 1   # nothing cached before the
            (self._prefix_hits if shared   # first arena build
             else self._prefix_misses).inc()
            if hit_len:
                self._prefix_reused.inc(hit_len)
        store = self._store_positions(req.want)
        need_new = pages_needed(store, self._ps) - len(shared)
        # retain the shared pages BEFORE evicting: a deep shortfall must
        # not reclaim the very blocks this admission is about to map
        for p in shared:
            self._pool.retain(p)
        try:
            short = need_new - self._pool.free_count()
            if short > 0 and self._prefix is not None:
                self._prefix.evict(short)
            fresh = self._pool.alloc(need_new)
        except Exception:
            for p in shared:
                self._pool.release(p)
            raise
        return shared + fresh, hit_len

    def _install_prefix(self, table, hit_len: int) -> None:
        """Seed the detached prefill state with the cached prefix: the
        mapped pages gather into a batch-1 dense cache and kv_pos starts
        at the block boundary, so the suffix prime continues the stream
        as if the prefix had just been primed."""
        net = self.net
        row = np.zeros((1, self._n_max), np.int32)
        row[0, :hit_len // self._ps] = table[:hit_len // self._ps]
        dense = gather_pages(self._page_store,
                             torch.as_tensor(row, device=self.device),
                             length=self._L)
        self._kv_traffic(self._L * self._tok_bytes)   # one-row gather
        pos = torch.tensor(hit_len, dtype=torch.int32, device=self.device)
        for (n, k), leaf in zip(self._paged_keys, dense):
            cur = dict(net.state.get(n) or {})
            cur[k] = leaf.contiguous()
            cur["kv_pos"] = pos
            net.state[n] = cur
        net._stream_pos_map = {n: hit_len for n in self._graph_vertices}

    def _admit_one(self, req: GenerationRequest, slot: int,
                   readmit: bool = False) -> None:
        """Prime `req` at batch 1 and join it to the arena at `slot`. A
        prime failure fails THAT request only: the arena state is
        restored untouched and the request's pages released.

        ``readmit=True`` is the recovery path (the supervisor's rebuild,
        a ledger admission): the request already streamed, so the prime
        feeds ``ids[:-1]`` (what the lost arena row had consumed) and
        nothing else happens: no draw (the rng stays at its fault-time
        position), no token push, no TTFT or queue-wait observation, no
        prefill chaos. The next dispatch recomputes the next-token
        distribution the unperturbed run would have seen."""
        net = self.net
        saved_state = dict(net.state)
        saved_acct = self._save_accounting()
        prime_ids = req.handle._ids[:-1] if readmit else req.prompt
        table, hit_len = [], 0
        try:
            if self._pool is not None:
                table, hit_len = self._alloc_request_pages(req)
            if not readmit:
                _fire_chaos(self._prefill_chaos, self.admissions, ctx=req)
            net.rnn_clear_previous_state()
            fed = len(prime_ids) - hit_len
            # no width bucket: the port primes unpadded in one chunk
            req.trace.record("prefill_start", engine=self.trace_identity,
                             width=fed, bucket=None, prefix_hit=hit_len,
                             readmit=readmit)
            if self._kv_dtype == "int8":
                # the prime runs through the pool; a prefix hit starts
                # kv_pos past the shared pages, read in place
                self._install_prime_paged_state(table, hit_len)
            elif hit_len:
                self._install_prefix(table, hit_len)
            p0 = prime_prompt(net, prime_ids[hit_len:])
            req.trace.record("prefill_end")
            primed_pos = self._net_pos()
        except Exception as e:  # noqa: BLE001 — per-request failure domain
            net.state = saved_state
            self._restore_accounting(saved_acct)
            self._release_pages(table)
            if not readmit:
                self.admissions += 1
            self._handles[SERVING_ERRORS].inc()
            req.handle._fail(e)
            self._recent_traces.append(req.trace)
            return
        primed_state = dict(net.state)
        if self._kv_dtype == "int8":
            primed_state = self._extract_prime_paged_state(primed_state)
        if readmit:
            tok = req.handle._ids[-1]    # pending, drawn before the fault
            req.trace.record("readmit", engine=self.trace_identity)
        else:
            self.admissions += 1
            tok = draw(p0, req.temperature, req.rng, top_k=req.top_k,
                       top_p=req.top_p)
            now = time.monotonic()
            req.handle.ttft_s = now - req.submit_t
            self.ttft_s.append(req.handle.ttft_s)
            self._ttft_hist.observe(req.handle.ttft_s)
            if self._overload is not None:
                self._overload.observe_ttft(req.handle.ttft_s, now)
            req.last_token_t = now
            req.trace.record("first_token", engine=self.trace_identity)
            req.handle._push(tok)
            self.tokens_generated += 1
            self._tokens.inc()
            reason = stop_reason(tok, len(req.handle._ids), req.want,
                                 req.stop_tokens)
            if reason is None and self._cap is not None \
                    and primed_pos >= self._cap:
                reason = "capacity"    # the prompt filled the stream
            if reason:
                # one-token request: never enters the arena at all
                net.state = saved_state
                self._restore_accounting(saved_acct)
                self._release_pages(table)
                req.handle._finish(reason)
                self._recent_traces.append(req.trace)
                return
        if not self._arena_ready:
            if self._pool is not None and self._page_store is None:
                self._init_page_store(primed_state)
            saved_state = self._build_arena(primed_state, saved_state)
            self._arena_ready = True
            self._drop_graphs()             # a new arena: new addresses
        net.state = self._merge(saved_state, primed_state, slot)
        if self._pool is not None:
            if self._kv_dtype == "int8":
                # the prime wrote the pool in place: charge the prime's
                # pool traffic (the whole context read, `fed` appended)
                self._kv_traffic((self._L + fed) * self._tok_bytes)
            else:
                self._scatter_primed_pages(primed_state, table)
            self._page_tables[slot] = table
            self._write_table_row(slot, table)
            if self._prefix is not None \
                    and self._brownout < BROWNOUT_NO_PREFIX_INSERTS:
                self._prefix.insert(req.prompt, table)
        self._slots[slot] = req
        self._row_pos[slot] = primed_pos
        req.pending_token = tok
        req.trace.record("seat", engine=self.trace_identity, slot=slot)
        self._sync_accounting()

    def _release_pages(self, table) -> None:
        for p in table:
            self._pool.release(p)

    # ------------------------------------------------------------------
    # supervised recovery (serving/supervisor.py drives this)
    # ------------------------------------------------------------------
    def _quarantine_rebuild(self, exc: Optional[BaseException] = None
                            ) -> int:
        """Drop the (possibly poisoned) arena WHOLESALE and rebuild it
        from the host-side request ledger: a fresh page pool (the page
        allocator), tables and prefix cache (re-seeded by the re-primes),
        the page store zeroed, a fresh arena on the first re-admission,
        every survivor re-primed from prompt + committed tokens with its
        pending token and untouched rng. Returns the survivors
        re-admitted. Runs under the step lock.

        The page store (the pools and, int8, the scale sidecars) is the
        one device allocation of the arena too large for the caching
        allocator's exact small blocks, so it is made once, at its first
        build, and a rebuild zeroes it in place (``_zero_page_store``)
        rather than allocating it anew: a fresh
        large block may be handed a cached block up to 1 MiB bigger
        than asked, whole, so its counted bytes depend on what the
        process freed before (ROADMAP.md C9). Zeroed pools and scales
        also mean no page of a re-prime reads a scale the old arena
        left. The rest of the old arena's device memory is released
        before the re-primes allocate anew: the cached table, the views
        in ``net.state``, and the locals of the failed cycle's frames in
        ``exc``'s traceback (which would otherwise keep them alive as
        long as the supervisor keeps the fault).

        A fault raised inside the re-admissions strands nobody: every
        survivor not seated by then fails with it before it escalates.
        The survivors travel as ``RequestLedgerEntry`` records through
        ``export_ledger`` (the seating request included)."""
        if exc is not None and exc.__traceback__ is not None:
            traceback.clear_frames(exc.__traceback__)
        entries = self.export_ledger()      # actives + _seating
        self._drop_graphs()                 # they read the old arena
        self._seating = None
        self._slots = [None] * self.slots
        self._row_pos = np.zeros(self.slots, np.int64)
        self._arena_ready = False
        self._merge_keys = None
        self.net.rnn_clear_previous_state()
        if self._pool is not None:
            # fresh pool: the old refcounts may be mid-mutation from the
            # failed cycle (and chaos seizures die with it)
            self._pool = PagePool(self._pool.total_pages, self._ps)
            self._prefix = (PrefixCache(self._pool)
                            if self._prefix is not None else None)
            self._page_tables = [[] for _ in range(self.slots)]
            self._kv_pos_dirty = False   # the rebuilt state is fresh
            # zeroed pools and scales before the re-primes, which write
            # through them (int8) or into them
            self._zero_page_store()
        self._sync_accounting()
        if self._overload is not None:
            # the replacement pool starts fresh: recompute the rung so
            # pre-fault pressure does not gate the re-primes (rung 3
            # would skip re-seeding the prefix cache)
            self._brownout = self._overload.brownout_level(self)
        now = time.monotonic()
        n = 0
        try:
            for entry in entries:
                req = entry.request
                if self._fail_if_dead(req, now, "during recovery"):
                    continue
                req.trace.record("rebuild", engine=self.trace_identity)
                slot = self._slots.index(None)
                self._admit_one(req, slot, readmit=req.streamed)
                if self._slots[slot] is req or (
                        req.handle.done and req.handle.error is None):
                    n += 1                   # seated, or finished clean
        except BaseException as e:
            seated = {id(r) for r in self._slots if r is not None}
            for entry in entries:
                if id(entry.request) not in seated \
                        and not entry.request.handle.done:
                    entry.request.handle._fail(e)
            raise
        return n

    # ------------------------------------------------------------------
    # the request-ledger seam (serving/request.RequestLedgerEntry)
    # ------------------------------------------------------------------
    def export_ledger(self, include_queued: bool = False
                      ) -> List[RequestLedgerEntry]:
        """Snapshot every in-flight request as a versioned ledger entry:
        active slots (in slot order), the pop-to-seat ``_seating``
        request if the export lands in that window, and, with
        ``include_queued``, the admission queue in admission order.
        Non-mutating; safe on a stopped or broken engine."""
        with self._lock:
            entries = [RequestLedgerEntry.capture(r, "active")
                       for r in self._slots if r is not None]
            if self._seating is not None:
                entries.append(RequestLedgerEntry.capture(
                    self._seating, "seating"))
            if include_queued:
                entries.extend(
                    RequestLedgerEntry.capture(r, "queued")
                    for r in self._pending.peek_all())
            return entries

    def admit_from_ledger(self, entries, where: str = "during migration"
                          ) -> int:
        """Re-admit ledger entries on THIS engine: streamed survivors
        re-prime from ``ids[:-1]`` with their pending token and
        untouched rng, never-streamed entries admit fresh. Entries that
        find no free slot ride the admission queue (requeued past the
        limit: they were admitted once). Returns how many requests this
        engine took over; dead entries are resolved and skipped."""
        with self._lock:
            if self._broken is not None:
                raise EngineShutdown("GenerationEngine is broken: "
                                     f"{self._broken!r}")
            if self._stop.is_set():
                raise EngineShutdown("GenerationEngine shut down")
            if self._draining:
                raise EngineShutdown("GenerationEngine draining: "
                                     "migrate to another replica")
            now = time.monotonic()
            n = 0
            for entry in entries:
                req = entry.request
                if self._fail_if_dead(req, now, where):
                    continue
                if self._pool is not None:
                    store = self._store_positions(req.want)
                    if pages_needed(store, self._ps) > self._pool.usable:
                        req.handle._fail(ValueError(
                            f"migrated request holds {store} KV "
                            f"positions but this replica's pool has "
                            f"only {self._pool.usable} pages"))
                        continue
                free = (self._slots.index(None)
                        if None in self._slots else None)
                if free is not None and (
                        self._pool is None
                        or self._pages_admissible(req)):
                    self._admit_one(req, free, readmit=req.streamed)
                    if self._slots[free] is req or (
                            req.handle.done
                            and req.handle.error is None):
                        n += 1
                else:
                    req.trace.record("requeue", engine=self.trace_identity)
                    self._pending.requeue(req)
                    n += 1
            return n

    def queue_snapshot(self):
        """Non-mutating admission-queue view (per-priority depths and
        the oldest wait): ``serving.scheduler.QueueSnapshot``."""
        return self._pending.snapshot()

    # ------------------------------------------------------------------
    # the page pool
    # ------------------------------------------------------------------
    def _init_page_store(self, primed_state) -> None:
        """First-admission pool build: one ``[total_pages, Hkv,
        page_size, D]`` tensor per paged leaf (kv_k / kv_v of every
        attention layer) in the leaf's dtype."""
        keys, store = [], []
        for n in sorted(primed_state):
            s = primed_state[n]
            if not isinstance(s, dict):
                continue
            for k in ("kv_k", "kv_v"):
                if k not in s:
                    continue
                v = s[k]                       # [1, Hkv, L, D]
                if v.shape[2] != self._L:
                    raise RuntimeError(
                        f"paged leaf {n}.{k} carries length {v.shape[2]} "
                        f"!= cache_length {self._L}")
                keys.append((n, k))
                store.append(v.new_zeros((self._pool.total_pages,
                                          v.shape[1], self._ps,
                                          v.shape[3])))
        if not keys:
            raise RuntimeError("paged mode found no kv_k/kv_v leaves in "
                               "the primed stream state")
        self._paged_keys = keys
        self._page_store = store
        self._table_dev = self._new_table()
        self._tok_bytes = sum(int(p.shape[1]) * int(p.shape[3])
                              * p.element_size() for p in store)

    def _paged_layer_dims(self):
        """(state name, Hkv, head dim) per paged attention layer, sorted
        by name: the (name, leaf) order ``_init_page_store`` derives
        from a primed state, so the eager int8 store and the lazy bf16
        one address the same leaves."""
        named = [(str(i), l) for i, l in
                 enumerate(getattr(self.net, "layers", None) or [])]
        named += [(n, v.layer) for n, v in
                  (getattr(self.net.conf, "vertices", None) or {}).items()
                  if getattr(v, "layer", None) is not None]
        out = []
        for n, l in named:
            if getattr(l, "supports_streaming", False) \
                    and getattr(l, "cache_length", 0):
                hkv = getattr(l, "n_kv_heads", None) or l.n_heads
                out.append((n, int(hkv), int(l.n_out // l.n_heads)))
        return sorted(out)

    def _init_quant_store(self) -> None:
        """The int8 store (``serving/quant.py``): zeroed ``[P, Hkv,
        page_size, D]`` int8 pools and ``[P, Hkv]`` f32 scale sidecars,
        two leaves (k, v) per attention layer. Built at construction; a
        rebuild zeroes it in place (:meth:`_zero_page_store`)."""
        self._paged_keys = [(n, k) for n, _, _ in self._quant_dims
                            for k in ("kv_k", "kv_v")]
        self._page_store, self._scale_store = pool_leaves(
            self._pool.total_pages, self._ps,
            [(h, d) for _, h, d in self._quant_dims], device=self.device)
        self._table_dev = self._new_table()
        self._tok_bytes = sum(2 * h * d for _, h, d in self._quant_dims)
        self._scale_row_bytes = sum(2 * h * 4
                                    for _, h, _ in self._quant_dims)

    def _zero_page_store(self) -> None:
        """A rebuild's store: the pools (and int8 scale sidecars) built
        first, zeroed in place, and a new page table; with no store yet
        (a bf16 store before its first arena) the first re-admission
        builds one."""
        if self._page_store is None:
            self._table_dev = None
            return
        for t in list(self._page_store) + list(self._scale_store or ()):
            t.zero_()
        self._table_dev = self._new_table()

    def _paged_view(self, table):
        """``{layer name: {view key: tensor}}``: each paged layer's pools
        (and, int8, scale sidecars) and the page table ``table``."""
        view = {}
        for i, (n, k) in enumerate(self._paged_keys):
            d = view.setdefault(n, {"kv_page_table": table})
            d[_PAGED_VIEW[k]] = self._page_store[i]
            if self._scale_store is not None:
                d[_SCALE_VIEW[k]] = self._scale_store[i]
        return view

    def _install_prime_paged_state(self, table, hit_len: int) -> None:
        """Arm the batch-1 prime to run through the pool (int8): the
        pools and scale sidecars, the request's one-row table, kv_pos at
        the prefix hit length, and the ``kv_page_prime`` marker (the
        layer then keeps shared pages read-only and reads through its
        dequantizing gather). On a hit the suffix attends the shared
        pages in place: ``_install_prefix``'s dense gather has no int8
        equivalent."""
        row = np.zeros((1, self._n_max), np.int32)
        row[0, :len(table)] = table
        row_dev = torch.as_tensor(row, device=self.device)
        pos = torch.full((1,), hit_len, dtype=torch.int32,
                         device=self.device)
        st = dict(self.net.state)
        for n, view in self._paged_view(row_dev).items():
            st[n] = {**(st.get(n) or {}), **view, "kv_pos": pos,
                     "kv_page_prime": True}
        self.net.state = st
        self.net._stream_pos_map = {n: hit_len for n in self._graph_vertices}

    def _extract_prime_paged_state(self, primed_state):
        """Strip the paged view from the prime's state: what the arena
        build and merge see keeps the ``[1]`` kv_pos for the slot. The
        prime wrote the pools and sidecars in place (so, unlike the JAX
        engine, there is nothing to take back), and only at the
        request's own fresh pages and the null page: on a failed prime
        the store stays authoritative, and its pages are released."""
        out = {n: (dict(v) if isinstance(v, dict) else v)
               for n, v in primed_state.items()}
        for n in dict.fromkeys(n for n, _ in self._paged_keys):
            out[n] = {k: v for k, v in out[n].items() if k not in _VIEW_KEYS}
        return out

    def _scatter_primed_pages(self, primed_state, table) -> None:
        """Commit the primed batch-1 KV into the slot's pages. Shared
        prefix pages are rewritten with the identical values they were
        gathered from."""
        idx = torch.as_tensor(table, dtype=torch.long, device=self.device)
        nb = len(table)
        for (n, k), pool in zip(self._paged_keys, self._page_store):
            _, h, ps, d = pool.shape
            dense = primed_state[n][k][0]                 # [Hkv, L, D]
            if nb * ps > dense.shape[1]:
                dense = torch.nn.functional.pad(
                    dense, (0, 0, 0, nb * ps - dense.shape[1]))
            blocks = dense[:, :nb * ps].reshape(h, nb, ps, d).transpose(0, 1)
            pool.index_copy_(0, idx, blocks.to(pool.dtype))
        self._kv_traffic(self._L * self._tok_bytes)   # one-row commit

    def _new_table(self) -> torch.Tensor:
        return torch.zeros((self.slots, self._n_max), dtype=torch.int32,
                           device=self.device)

    def _tables(self) -> torch.Tensor:
        """The ``[S, n_max]`` int32 device page table (0 = the null
        page), one tensor from the store's build to the next rebuild."""
        return self._table_dev

    def _write_table_row(self, slot: int, pages) -> None:
        """Write ``slot``'s row of the device table in place (one small
        host-to-device copy): its pages, zeros past them."""
        row = np.zeros(self._n_max, np.int32)
        row[:len(pages)] = pages
        self._table_dev[slot].copy_(torch.from_numpy(row))

    def _reset_free_rows(self) -> None:
        """Zero the free rows' ``kv_pos`` in place after a retirement (the
        one tensor the layers share keeps its address)."""
        if not self._kv_pos_dirty:
            return
        free = torch.as_tensor([r is None for r in self._slots],
                               device=self.device)
        for t in self._kv_pos():
            t.masked_fill_(free, 0)
        self._kv_pos_dirty = False

    def _rewind_rows(self, amounts) -> None:
        """Move each row's ``kv_pos`` back by its entry of ``amounts``
        in place after a verify (``rewind_stream_state``'s per-row
        rewind, clamped at 0, on the one ``[S]`` tensor the layers share
        and the decode graph reads): the rejected slots drop out of the
        masks and the next append overwrites them. The host mirrors are
        ``_sync_accounting``'s; ``check_rewindable`` ran at
        construction."""
        for t in self._kv_pos():
            t.sub_(torch.as_tensor(amounts, dtype=t.dtype,
                                   device=t.device)).clamp_min_(0)

    def _kv_pos(self) -> list:
        """The distinct ``kv_pos`` tensors of the attention layers (one,
        shared, once the arena is built)."""
        return list({id(s["kv_pos"]): s["kv_pos"]
                     for s in self.net.state.values()
                     if isinstance(s, dict)
                     and torch.is_tensor(s.get("kv_pos"))}.values())

    def _install_paged_state(self) -> None:
        """Install the paged decode view for the coming forward: each
        paged layer's state gains its pool pair (and, int8, its scale
        sidecars) and the page table. No bytes move: the pools and
        sidecars are updated in place by the forward's append, so
        (unlike the JAX engine's donated buffers and per-layer table
        copies) there is nothing to hand back."""
        st = dict(self.net.state)
        for n, view in self._paged_view(self._tables()).items():
            st[n] = {**st[n], **view}
        self.net.state = st

    def _extract_paged_state(self) -> None:
        """Drop the paged view from ``net.state`` after the forward."""
        st = dict(self.net.state)
        for n in dict.fromkeys(n for n, _ in self._paged_keys):
            if isinstance(st.get(n), dict):
                st[n] = {k: v for k, v in st[n].items()
                         if k not in _VIEW_KEYS}
        self.net.state = st

    # -- modeled KV traffic (serving/health.SERVING_KV_BYTES_MOVED) ----
    def _kv_traffic(self, nbytes: int) -> None:
        if nbytes:
            self._kv_bytes_total += int(nbytes)
            self._kv_bytes.inc(int(nbytes))

    def _kv_dispatch_bytes(self, width: int) -> int:
        """Bytes the KV path moves around ONE dispatch, summed over the
        attention leaves: the paged kernel (its plain version on the
        CPU) reads each active row's LIVE pages only (the row's
        page-rounded context after the append, at most L), the append
        writes ``width`` positions a row, and an int8 pool adds one
        scale row a live page. This is the JAX engine's ``direct-pallas``
        term, the port's one read path."""
        if self._tok_bytes == 0:
            return 0
        S, L, ps = self.slots, self._L, self._ps
        append = S * width * self._tok_bytes
        live = sum(min(-(-int(self._row_pos[s] + width) // ps) * ps, L)
                   for s, r in enumerate(self._slots) if r is not None)
        return (live * self._tok_bytes + append
                + (live // ps) * self._scale_row_bytes)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _dispatch_step(self):
        """ONE decode forward advancing every active slot (free rows feed
        token 0; their outputs are discarded). Slots at streaming
        capacity retire first."""
        if self._cap is not None:
            for s, req in enumerate(self._slots):
                if req is not None and self._row_pos[s] >= self._cap:
                    self._retire(s, "capacity")
        toks = np.zeros(self.slots, np.int64)
        for s, req in enumerate(self._slots):
            if req is not None:
                toks[s] = req.pending_token
        if not any(r is not None for r in self._slots):
            return None     # everything retired at the capacity guard
        self._sync_accounting()
        probs = self._run_dispatch(toks[:, None])[:, :, 0]
        for s, req in enumerate(self._slots):
            if req is not None:
                self._row_pos[s] += 1
        self._sync_accounting()
        return probs

    def _run_dispatch(self, chunk):
        """The ONE paged / chaos / retry wrapper around a decode or verify
        dispatch of ``chunk`` ``[S, W]`` token ids (W = 1 plain, 1 +
        gamma speculative); returns the ``[S, V, W]`` distributions. The
        chaos hook fires INSIDE the retried callable, before any state
        mutates, so a retried dispatch is numerically the fault-free
        one. Each cycle lands in the dispatch-latency histogram and its
        modeled KV bytes in the KV counter. A kernel's (or a graph's)
        failure is a fault like any other (no fallback re-runs it on the
        plain version or eagerly)."""
        paged = self._pool is not None
        width = int(chunk.shape[1])
        if paged:
            self._reset_free_rows()

        def once():
            _fire_chaos(self._decode_chaos, self.dispatches)
            return self._dispatch(chunk)

        t0 = time.perf_counter()
        out = (retry_call(once, policy=self._decode_retry,
                          op="serving_decode")
               if self._decode_retry is not None else once())
        dt = time.perf_counter() - t0
        self.dispatch_s_total += dt
        self._dispatch_hist.observe(dt)
        if paged:
            self._kv_traffic(self._kv_dispatch_bytes(width))
        self.dispatches += 1
        return out

    # -- the dispatch: rnn_time_step's host part around its device part,
    # -- which on the card is one replay of the width's CUDA graph ------
    #: a measuring seam (set on an instance, never by the package): True
    #: runs the device part eagerly on the card too, to hold the graph's
    #: distributions and streams against
    _measure_eager = False

    def _dispatch(self, chunk):
        net = self.net
        ticket = net._stream_begin(int(chunk.shape[1]))
        if self.device.type == "cuda" and not self._measure_eager:
            out = self._replay(chunk)
        else:
            out = self._eager(chunk)
        net._stream_end(ticket)
        return out

    def _eager(self, chunk) -> np.ndarray:
        """The device part run eagerly (the CPU; the measuring seam)."""
        ids = torch.as_tensor(chunk, device=self.device)
        paged = self._pool is not None
        if paged:
            self._install_paged_state()
        try:
            out = self._decode_body(ids)
        finally:
            if paged:
                self._extract_paged_state()
        return out.cpu().numpy()

    def _decode_body(self, ids: torch.Tensor) -> torch.Tensor:
        """The device part of one dispatch, what a decode graph holds: the
        one-hot ``[S, V, W]`` of the device ids ``[S, W]``, the streaming
        forward (the paged view's append in place), each new state leaf
        copied into the fixed one it replaces (``kv_pos``, ``h`` / ``c``;
        the pools and a dense cache are written in place already), and
        the f32 head, returned. Reads nothing on the host."""
        net = self.net
        fixed = net.state
        x = torch.zeros((ids.shape[0], self.V, ids.shape[1]),
                        device=ids.device)
        x.scatter_(1, ids[:, None, :], 1.0)
        out = net._stream_apply(net._stream_input(x))
        new = net.state
        done = set()                 # the layers share one kv_pos
        for n, s in fixed.items():
            if not isinstance(s, dict):
                continue
            for k in _SCATTER_KEYS.intersection(s):
                if new[n][k] is not s[k] and id(s[k]) not in done:
                    s[k].copy_(new[n][k])
                    done.add(id(s[k]))
        net.state = fixed
        return out[0] if isinstance(out, list) else out

    def _step_leaves(self):
        """Every tensor a dispatch reads or writes in place, by name: the
        pools and scale sidecars, the page table, and each layer's
        ``kv_pos`` (one tensor the layers share), ``h`` / ``c`` and dense
        ``kv_k`` / ``kv_v``. A decode graph holds their addresses."""
        out = {}
        for i, t in enumerate(self._page_store or ()):
            out[f"pool{i}"] = t
        for i, t in enumerate(self._scale_store or ()):
            out[f"scales{i}"] = t
        if self._table_dev is not None:
            out["table"] = self._table_dev
        for n, s in self.net.state.items():
            if isinstance(s, dict):
                for k in sorted(_SCATTER_KEYS.intersection(s)):
                    out[f"{n}.{k}"] = s[k]
        return out

    def _graph_reads(self):
        """What a decode graph baked in: the step's leaves and the compute
        parameters' leaves (a new compute copy, or any new leaf, needs a
        new capture)."""
        return (tuple(self._step_leaves().values())
                + tuple(tree_leaves(self.net._compute_params())))

    def _drop_graphs(self) -> None:
        """Drop the decode graphs (their private pools freed with them):
        the next dispatch captures anew."""
        self._graphs = {}

    def _replay(self, chunk) -> np.ndarray:
        """One replay of the width's decode graph (captured first if the
        width has none, or if what it baked in moved): the ids in by one
        host-to-device copy, the distributions out by one device-to-host
        copy, on the graph's stream."""
        width = int(chunk.shape[1])
        g = self._graphs.get(width)
        if g is not None and not _same_tensors(g.reads, self._graph_reads()):
            self._drop_graphs()
            g = None
        if g is None:
            g = self._capture(width)
        stream = self._graph_stream
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        g.ids_host.numpy()[:] = chunk
        with torch.cuda.stream(stream):
            g.ids.copy_(g.ids_host, non_blocking=True)
            g.graph.replay()
            g.out_host.copy_(g.out, non_blocking=True)
            g.done.record(stream)
        cur.wait_stream(stream)
        g.done.synchronize()
        return g.out_host.numpy().copy()

    def _capture(self, width: int) -> "_DecodeGraph":
        """Capture the width's decode graph on the engine's graph stream
        (one stream an engine, so its replays share the paged kernel's
        counters in stream order):
        first one eager pass of the device part over scratch state (the
        cuBLAS workspace and the paged kernel's counters of this stream
        exist before the capture; the pass writes only the null page and
        scratch rows, see :meth:`_scratch_state`), then the capture under
        the paused cyclic collector, which runs nothing: the step's work
        runs at the first replay."""
        t0 = time.perf_counter()
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        stream = self._graph_stream
        g = _DecodeGraph(self.slots, self.V, width, self.device)
        paged = self._pool is not None
        net = self.net
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            if paged:
                self._install_paged_state()
            real = net.state
            try:
                net.state = self._scratch_state(real)
                self._decode_body(g.ids)
                net.state = real
                with _collector_paused(), torch.cuda.graph(
                        g.graph, stream=stream,
                        capture_error_mode="thread_local"):
                    g.out = self._decode_body(g.ids)
            finally:
                net.state = real
                if paged:
                    self._extract_paged_state()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        g.reads = self._graph_reads()
        self._graphs[width] = g
        self.graph_captures += 1
        record_capture(f"{self._label}.decode_graph_w{width}",
                       time.perf_counter() - t0)
        return g

    def _scratch_state(self, state):
        """``state`` with every leaf a dispatch writes swapped for a
        harmless stand-in, for the warm-up pass before a capture: a zero
        page table and ``kv_pos`` 0 (a paged layer appends to the null
        page only, which no valid position reads), ``kv_pos`` at the
        cache length (a dense cache rewrites nothing), copies of ``h`` /
        ``c``."""
        out = {}
        for n, s in state.items():
            if not isinstance(s, dict):
                out[n] = s
                continue
            d = dict(s)
            paged = "kv_page_table" in s
            if paged:
                d["kv_page_table"] = torch.zeros_like(s["kv_page_table"])
            if "kv_pos" in s:
                d["kv_pos"] = torch.full_like(
                    s["kv_pos"], 0 if paged else s["kv_k"].shape[2])
            for k in ("h", "c"):
                if k in s:
                    d[k] = s[k].clone()
            out[n] = d
        return out

    def _retire(self, slot: int, reason: str,
                exc: Optional[BaseException] = None) -> None:
        """Free `slot` at once (host bookkeeping only): the row's stale
        state is invisible until the next admission overwrites it."""
        req = self._slots[slot]
        self._slots[slot] = None
        self._row_pos[slot] = 0
        if self._pool is not None:
            # blocks the prefix cache also references stay resident at
            # the cache's own refcount, warm for the next sharer
            self._release_pages(self._page_tables[slot])
            self._page_tables[slot] = []
            self._write_table_row(slot, ())
            self._kv_pos_dirty = True
        if exc is not None:
            req.handle._fail(exc, reason)
        else:
            req.handle._finish(reason)
        self._recent_traces.append(req.trace)

    # ------------------------------------------------------------------
    # arena state plumbing
    # ------------------------------------------------------------------
    def _build_arena(self, primed_state, base_state):
        """First-admission skeleton: every stream key of the primed
        structure at S zeroed rows (an LSTM's h / c, a dense KV cache),
        the per-row kv_pos vector at 0: ONE tensor that every attention
        layer's state holds (every layer's positions move together, so a
        reset or a rewind is one update, not one a layer). In paged mode
        the dense kv_k / kv_v leaves are dropped: the pool is the only
        KV storage."""
        S = self.slots
        arena = {}
        pos = None
        for name, s in primed_state.items():
            if not isinstance(s, dict):
                arena[name] = s
                continue
            d = dict(base_state.get(name) or {})
            d.update({k: v for k, v in s.items() if k not in _SCATTER_KEYS})
            for k, v in s.items():
                if k not in _SCATTER_KEYS:
                    continue
                if self._pool is not None and k in _PAGED_VIEW:
                    continue
                if k == "kv_pos":
                    if pos is None:
                        pos = torch.zeros(S, dtype=v.dtype, device=v.device)
                    d[k] = pos
                else:                      # batch-leading cache / carry
                    d[k] = v.new_zeros((S,) + tuple(v.shape[1:]))
            arena[name] = d
        return arena

    def _merge(self, arena_state, primed_state, slot: int):
        """Join the primed row into the arena at `slot`, in place:
        batch-leading leaves take the primed row 0, kv_pos [S] takes the
        primed scalar."""
        if self._merge_keys is None:
            self._merge_keys = [
                (n, k) for n in sorted(primed_state)
                if isinstance(primed_state[n], dict)
                for k in sorted(primed_state[n])
                if k in _SCATTER_KEYS
                and not (self._pool is not None and k in _PAGED_VIEW)]
        out = {n: (dict(v) if isinstance(v, dict) else v)
               for n, v in arena_state.items()}
        for n, k in self._merge_keys:
            a, p = out[n][k], primed_state[n][k]
            a[slot] = p[0] if p.dim() == a.dim() else p
        return out

    def _net_pos(self) -> int:
        pm = getattr(self.net, "_stream_pos_map", None)
        if pm:
            return int(max(pm.values()))
        return int(getattr(self.net, "_stream_pos", 0) or 0)

    def _save_accounting(self):
        net = self.net
        pm = getattr(net, "_stream_pos_map", None)
        return (getattr(net, "_stream_pos", None),
                getattr(net, "_stream_pos_rows", None),
                dict(pm) if pm is not None else None)

    def _restore_accounting(self, saved) -> None:
        pos, rows, pmap = saved
        net = self.net
        if pos is not None:
            net._stream_pos = pos
        net._stream_pos_rows = rows
        if pmap is not None:
            net._stream_pos_map = pmap

    def _sync_accounting(self) -> None:
        """Engine-owned host position mirrors: the streaming budget guard
        sees the furthest ACTIVE row, so an idle slot whose device
        position coasts never trips it."""
        rows = [int(self._row_pos[s]) for s, r in enumerate(self._slots)
                if r is not None]
        pos = max(rows, default=0)
        net = self.net
        if hasattr(net, "_stream_pos"):
            net._stream_pos = pos
        if self._graph_vertices:
            net._stream_pos_map = {n: pos for n in self._graph_vertices}
        net._stream_pos_rows = None

    # ------------------------------------------------------------------
    # warmup and lifecycle
    # ------------------------------------------------------------------
    def warmup(self, max_prompt_len: Optional[int] = None,
               steps: int = 2) -> "GenerationEngine":
        """Drive one synthetic greedy request through admission, prime
        and decode before traffic, so the first real request does not
        pay the one-time setup: the arena and page pool allocations,
        the CUDA kernel library's build and load, the matmul library's
        handles, the decode graph's capture (on the card). Eager PyTorch
        compiles nothing per shape, so where the JAX engine warms one
        request per prime bucket, one request of ``max_prompt_len``
        tokens (default: capacity - 1) covers every prompt length. The
        prefix cache is bypassed, so warmup prompts never occupy it, and
        the overload controller forgets the warmup's samples."""
        if self._worker is not None and self._worker.is_alive():
            raise RuntimeError("warm up before start(): warmup drives "
                               "step() manually")
        top = max_prompt_len
        if top is None:
            top = (self._cap - 1) if self._cap is not None else 64
        if self._cap is not None:
            top = min(int(top), self._cap - 1)
            if self._speculation is not None:
                # the verify's headroom: a request serves at most
                # capacity - gamma + 1 ids
                top = min(top, self._cap - self._speculation.gamma + 1
                          - int(steps))
        prefix, self._prefix = self._prefix, None
        try:
            h = self.submit([1 if self.V > 1 else 0] * max(1, int(top)),
                            steps=steps, top_k=1,
                            rng=np.random.default_rng(0))
            self.run_until_idle()
            h.result(timeout=0)
        finally:
            self._prefix = prefix
        if self._overload is not None:
            self._overload.reset_observations()
        return self

    def start(self) -> "GenerationEngine":
        """Run the dispatch loop on a background thread."""
        if self._stop.is_set():
            raise EngineShutdown("GenerationEngine shut down")
        if self._worker is not None and self._worker.is_alive():
            return self
        self._worker = threading.Thread(target=self._engine_loop,
                                        daemon=True)
        self._worker.start()
        return self

    def _engine_loop(self):
        try:
            while not self._stop.is_set():
                if not self.step():
                    if self._draining:
                        # the queue is closed while draining: wait()
                        # would return at once and spin
                        time.sleep(0.02)
                    else:
                        self._pending.wait(0.02)
        except Exception as e:  # noqa: BLE001 — strand no waiters
            log.exception("GenerationEngine loop died")
            self._break(e)

    def _flight_traces(self) -> list:
        """The flight recorder's request context: in-flight traces
        (slots and the pop-to-seat window) first, then recently retired
        ones."""
        traces = [r.trace for r in self._slots if r is not None]
        if self._seating is not None:
            traces.append(self._seating.trace)
        traces.extend(reversed(self._recent_traces))
        return traces

    def _break(self, exc: BaseException) -> None:
        """Terminal failure: fail every in-flight and queued request with
        the original error and refuse new work. With a supervisor this
        is the escalation (budget spent or rebuild failed). A flight
        record of the state the fault found is written first."""
        with self._lock:
            self._broken = exc
            self._stop.set()
            self._emit_serving_event("break", error=repr(exc))
            flightrecorder.maybe_dump(
                "engine_break", error=exc, health=self.health(),
                queue=self._pending.snapshot(),
                traces=self._flight_traces())
            if self._seating is not None:
                req, self._seating = self._seating, None
                if not req.handle.done:
                    req.handle._fail(exc)
            for s, req in enumerate(self._slots):
                if req is not None:
                    self._retire(s, "error", exc)
            for req in self._pending.close():
                req.handle._fail(exc)
            self._drop_graphs()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission and finish the actives: the clean handoff point
        for a planned restart. New submits are refused
        (``EngineShutdown``), queued never-primed requests fail at once
        with the same, and every ACTIVE request runs to its natural
        retirement. Works under the background loop (waits for it) or in
        manual mode (drives ``step()`` itself). Returns True when the
        arena emptied within `timeout` (None = wait forever); False on
        timeout or a broken or shut-down engine."""
        self._draining = True
        self._emit_serving_event("drain")
        for req in self._pending.close():
            req.handle._fail(EngineShutdown(
                "GenerationEngine draining: resubmit to the replacement "
                "instance"))
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        threaded = self._worker is not None and self._worker.is_alive()
        while self.active_slots() > 0 and self._broken is None \
                and not self._stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            if threaded:
                time.sleep(0.005)
            elif not self.step():
                break
        return self.active_slots() == 0 and self._broken is None \
            and not self._stop.is_set()

    def shutdown(self) -> None:
        """Stop the loop and fail everything still in flight. Idempotent."""
        self._stop.set()
        for req in self._pending.close():
            req.handle._fail(EngineShutdown("GenerationEngine shut down"))
        if self._worker is not None and self._worker.is_alive():
            self._worker.join(timeout=5.0)
        with self._lock:
            if self._seating is not None:
                req, self._seating = self._seating, None
                if not req.handle.done:
                    req.handle._fail(EngineShutdown(
                        "GenerationEngine shut down"))
            for s, req in enumerate(self._slots):
                if req is not None:
                    self._retire(s, "error", EngineShutdown(
                        "GenerationEngine shut down"))
            self._drop_graphs()


class _DecodeGraph:
    """One query width's decode-step CUDA graph: the static ids ``[S,
    W]`` (device, and their pinned host stage), the distributions ``[S,
    V, W]`` the graph writes (from its private pool) and their pinned
    host copy, the event that marks the copy done, and what the capture
    baked in (``reads``)."""

    def __init__(self, slots: int, vocab: int, width: int, device):
        self.graph = torch.cuda.CUDAGraph()
        self.ids = torch.zeros((slots, width), dtype=torch.int64,
                               device=device)
        self.ids_host = torch.zeros((slots, width), dtype=torch.int64,
                                    pin_memory=True)
        self.out = None
        self.out_host = torch.empty((slots, vocab, width),
                                    dtype=torch.float32, pin_memory=True)
        self.done = torch.cuda.Event()
        self.reads = ()


def _same_tensors(a, b) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))
