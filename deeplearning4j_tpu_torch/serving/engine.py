"""Continuous-batching generation engine over a slot-based KV arena.

Counterpart of ``deeplearning4j_tpu/serving/engine.py``:

- **Slot arena**: the net's streaming state lives at a fixed batch of S
  slots; ONE ``[S, V, 1]`` decode forward advances every active request
  per step. Per-slot positions ride the per-row ``kv_pos`` vector; free
  slots idle harmlessly (their outputs are discarded).
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

Greedy (top_k=1) outputs equal one-shot ``sample_stream`` with the same
rng (tested): the arena feeds each request exactly the token sequence a
dedicated stream would, and each request draws from its own rng in
generation order.

Not ported yet, and refused at construction with ``NotImplementedError``
rather than ignored: speculation, the supervisor, overload control, the
chaos seams and ``decode_retry``, and the metrics registry (ROADMAP.md
A7, A5). The request ledger, traces, ``health()`` with its KV traffic
and the fleet hooks come later too (ROADMAP.md A7, A10), and so does
the choice of decode read path (``decode_impl``: the port has one on
the card, the kernel; ROADMAP.md A.1). Metrics are plain attributes for
now.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BATCHED_STREAM_KEYS, PositionalEmbeddingLayer, stream_capacity)
from deeplearning4j_tpu_torch.serving.errors import (
    EngineShutdown, InferenceTimeout, RequestCancelled)
from deeplearning4j_tpu_torch.serving.paging import (
    PagedKVConfig, PagePool, gather_pages, pages_needed)
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.quant import kv_page_bytes, pool_leaves
from deeplearning4j_tpu_torch.serving.request import (
    GenerationRequest, GenerationStream)
from deeplearning4j_tpu_torch.serving.scheduler import AdmissionQueue
from deeplearning4j_tpu_torch.util.decoding import (
    _check_seed, _stream_layers, draw, prime_prompt, step_tokens,
    stop_reason)

__all__ = ["GenerationEngine"]

log = logging.getLogger(__name__)

#: stream-state keys the admission join writes into the arena row
_SCATTER_KEYS = frozenset(BATCHED_STREAM_KEYS | {"kv_pos"})
_PAGED_VIEW = {"kv_k": "kv_page_k", "kv_v": "kv_page_v"}
_SCALE_VIEW = {"kv_k": "kv_page_scale_k", "kv_v": "kv_page_scale_v"}
#: the keys of the paged view the engine installs around a forward
_VIEW_KEYS = frozenset({*_PAGED_VIEW.values(), *_SCALE_VIEW.values(),
                        "kv_page_table", "kv_page_prime"})
#: latency samples kept per metric (the monitoring port replaces these)
METRIC_WINDOW = 4096

#: constructor arguments of the JAX engine this slice leaves out
_NOT_PORTED = {"speculation": "A7", "supervisor": "A7", "overload": "A7",
               "prefill_chaos": "A7", "decode_chaos": "A7",
               "seat_chaos": "A7", "decode_retry": "A7", "registry": "A5"}


class GenerationEngine:
    """Continuous-batching generation over a fixed S-slot arena.

    Drive it manually (``submit()`` then ``step()`` /
    ``run_until_idle()``) or start the background loop (``start()`` /
    ``shutdown()``) and consume ``GenerationStream`` handles from any
    thread. ``device`` defaults to ``"cuda"`` and must be the net's."""

    def __init__(self, net, vocab_size: int, slots: int = 8,
                 queue_limit: int = 64, queue_policy: str = "block",
                 paging: Optional[PagedKVConfig] = None, device=None,
                 **not_ported):
        for arg, value in not_ported.items():
            if arg not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {arg!r}")
            if value is not None:
                raise NotImplementedError(
                    f"GenerationEngine({arg}=...) is not ported yet "
                    f"(ROADMAP.md {_NOT_PORTED[arg]})")
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
        if len(net.conf.network_inputs) != 1:
            raise ValueError("GenerationEngine serves single-input "
                             "decoder graphs only")
        n_in = net.conf.input_types[net.conf.network_inputs[0]].size
        if vocab_size != n_in:
            raise ValueError(f"vocab_size {vocab_size} != the net's input "
                             f"size {n_in}")
        layers = list(_stream_layers(net))
        if any(isinstance(l, PositionalEmbeddingLayer) for l in layers):
            raise ValueError(
                "continuous batching needs per-slot positions: learned "
                "positional tables carry a shared pos_offset (use a rope "
                "or position-free model)")
        self.net = net
        self.V = int(vocab_size)
        self.slots = int(slots)
        self._cap = stream_capacity(layers)
        self._graph_vertices = tuple(
            n for n, v in net.conf.vertices.items()
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
        self._page_tables: List[List[int]] = [[] for _ in range(slots)]
        #: the [S, n_max] int32 device table, rebuilt only after a table
        #: mutation (admit / retire), not per step
        self._table_dev = None
        #: a retirement freed a slot whose kv_pos keeps coasting (+1 per
        #: dispatch): the next install zeroes free rows' positions so an
        #: idle slot that once held a long context does not make the
        #: kernel walk its dead pages every step
        self._kv_pos_dirty = False
        if paging is not None:
            kv_layers = [l for l in layers
                         if getattr(l, "supports_streaming", False)
                         and getattr(l, "cache_length", 0)]
            if not kv_layers:
                raise ValueError("block-paged KV needs attention KV "
                                 "streaming state (cache_length > 0)")
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
                    # eligible: the port streams pure-attention nets only
                    # (recurrent h/c state comes with ROADMAP.md A.4)
                    kv_dtype = resolve_kv_dtype(True, self._quant_key,
                                                device=self.device)
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
                self._prefix = PrefixCache(self._pool)
            if kv_dtype == "int8":
                # built eagerly: the int8 prime writes through the pool,
                # so it exists before the first admission
                self._init_quant_store(dims)
        # -- plain metrics ------------------------------------------------
        self.admissions = 0
        self.dispatches = 0
        self.dispatch_s_total = 0.0
        self.tokens_generated = 0
        self.errors = 0
        self.ttft_s = deque(maxlen=METRIC_WINDOW)
        self.tpot_s = deque(maxlen=METRIC_WINDOW)
        self.queue_wait_s = deque(maxlen=METRIC_WINDOW)
        #: a request popped from the queue but not yet seated: a fault in
        #: that window fails it instead of stranding its handle
        self._seating: Optional[GenerationRequest] = None
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._broken: Optional[BaseException] = None
        # ONE lock serializes every arena/net touch
        self._lock = threading.RLock()
        net.rnn_clear_previous_state()     # the engine owns the stream

    # ------------------------------------------------------------------
    def is_healthy(self) -> bool:
        if self._broken is not None or self._stop.is_set():
            return False
        return self._worker is None or self._worker.is_alive()

    @property
    def page_pool(self) -> Optional[PagePool]:
        return self._pool

    @property
    def prefix_cache(self) -> Optional[PrefixCache]:
        return self._prefix

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
        if self._pool is not None:
            store = self._store_positions(want)
            if pages_needed(store, self._ps) > self._pool.usable:
                raise ValueError(
                    f"prompt + steps would hold {store} KV positions "
                    f"({pages_needed(store, self._ps)} pages of "
                    f"{self._ps} tokens) but the pool has only "
                    f"{self._pool.usable} pages: it can never be admitted")
        deadline = None if timeout is None else \
            time.monotonic() + float(timeout)
        req = GenerationRequest(
            prompt, steps, temperature=temperature, top_k=top_k,
            top_p=top_p, stop_tokens=stop_tokens, rng=rng,
            max_length=max_length, deadline=deadline, priority=priority)
        self._pending.submit(req)
        return req.handle

    def step(self) -> bool:
        """One engine cycle: expire/cancel, admit into free slots, one
        decode forward over the arena, sample + stream + retire. Returns
        whether any progress was made (False = idle). A fault past
        reaping breaks the engine: every waiter gets the error."""
        with self._lock:
            if self._stop.is_set() or self._broken is not None:
                return False
            now = time.monotonic()
            progress = self._reap(now) > 0
            try:
                progress = self._admit_ready(now) > 0 or progress
                active = [s for s, r in enumerate(self._slots)
                          if r is not None]
                if not active:
                    return progress
                self._step_plain(active)
            except Exception as e:  # noqa: BLE001 — fail waiters, not hang
                self.errors += 1
                self._break(e)
                return False
            return True

    def _step_plain(self, active) -> None:
        """One [S, V, 1] decode forward + one host draw per row."""
        probs = self._dispatch_step()
        now = time.monotonic()
        for s in active:
            req = self._slots[s]
            if req is None:        # retired by the capacity guard
                continue
            tok = draw(probs[s], req.temperature, req.rng,
                       top_k=req.top_k, top_p=req.top_p)
            if req.last_token_t is not None:
                self.tpot_s.append(now - req.last_token_t)
            req.last_token_t = now
            req.handle._push(tok)
            self.tokens_generated += 1
            reason = stop_reason(tok, len(req.handle._ids), req.want,
                                 req.stop_tokens)
            if reason:
                self._retire(s, reason)
            else:
                req.pending_token = tok

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
        (the final drawn token never re-enters the cache): the one
        formula behind the never-fits rejection, the head-of-line gate
        and the page reservation."""
        return want - 1 if self._cap is None else min(want - 1, self._cap)

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
        (paged: while the head request's pages fit)."""
        n = 0
        gate = self._pages_admissible if self._pool is not None else None
        while None in self._slots:
            req = self._pending.pop(admissible=gate)
            if req is None:
                break
            self._seating = req
            n += 1
            if req.handle.cancelled:
                req.handle._fail(RequestCancelled(
                    "request cancelled in the admission queue"),
                    reason="cancelled")
            elif req.deadline is not None and now >= req.deadline:
                req.handle._fail(InferenceTimeout(
                    "deadline expired in the admission queue"))
            else:
                req.handle.queue_wait_s = now - req.submit_t
                self.queue_wait_s.append(req.handle.queue_wait_s)
                self._admit_one(req, self._slots.index(None))
            self._seating = None
        return n

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
        store = self._store_positions(req.want)  # first arena build
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
        pos = torch.tensor(hit_len, dtype=torch.int32, device=self.device)
        for (n, k), leaf in zip(self._paged_keys, dense):
            cur = dict(net.state.get(n) or {})
            cur[k] = leaf.contiguous()
            cur["kv_pos"] = pos
            net.state[n] = cur
        net._stream_pos_map = {n: hit_len for n in self._graph_vertices}

    def _admit_one(self, req: GenerationRequest, slot: int) -> None:
        """Prime `req` at batch 1 and join it to the arena at `slot`. A
        prime failure fails THAT request only: the arena state is
        restored untouched and the request's pages released."""
        net = self.net
        saved_state = dict(net.state)
        saved_pos = dict(net._stream_pos_map)
        table, hit_len = [], 0
        try:
            if self._pool is not None:
                table, hit_len = self._alloc_request_pages(req)
            net.rnn_clear_previous_state()
            if self._kv_dtype == "int8":
                # the prime runs through the pool; a prefix hit starts
                # kv_pos past the shared pages, read in place
                self._install_prime_paged_state(table, hit_len)
            elif hit_len:
                self._install_prefix(table, hit_len)
            p0 = prime_prompt(net, req.prompt[hit_len:])
            primed_pos = self._net_pos()
        except Exception as e:  # noqa: BLE001 — per-request failure domain
            net.state = saved_state
            net._stream_pos_map = saved_pos
            self._release_pages(table)
            self.admissions += 1
            self.errors += 1
            req.handle._fail(e)
            return
        primed_state = dict(net.state)
        if self._kv_dtype == "int8":
            primed_state = self._extract_prime_paged_state(primed_state)
        self.admissions += 1
        tok = draw(p0, req.temperature, req.rng, top_k=req.top_k,
                   top_p=req.top_p)
        now = time.monotonic()
        req.handle.ttft_s = now - req.submit_t
        self.ttft_s.append(req.handle.ttft_s)
        req.last_token_t = now
        req.handle._push(tok)
        self.tokens_generated += 1
        reason = stop_reason(tok, len(req.handle._ids), req.want,
                             req.stop_tokens)
        if reason is None and self._cap is not None \
                and primed_pos >= self._cap:
            reason = "capacity"    # the prompt filled the stream
        if reason:
            # one-token request: never enters the arena at all
            net.state = saved_state
            net._stream_pos_map = saved_pos
            self._release_pages(table)
            req.handle._finish(reason)
            return
        if not self._arena_ready:
            if self._pool is not None and self._page_store is None:
                self._init_page_store(primed_state)
            saved_state = self._build_arena(primed_state, saved_state)
            self._arena_ready = True
        net.state = self._merge(saved_state, primed_state, slot)
        if self._pool is not None:
            if self._kv_dtype != "int8":   # int8: the prime wrote the pool
                self._scatter_primed_pages(primed_state, table)
            self._page_tables[slot] = table
            self._table_dev = None
            if self._prefix is not None:
                self._prefix.insert(req.prompt, table)
        self._slots[slot] = req
        self._row_pos[slot] = primed_pos
        req.pending_token = tok
        self._sync_accounting()

    def _release_pages(self, table) -> None:
        for p in table:
            self._pool.release(p)

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

    def _paged_layer_dims(self):
        """(state name, Hkv, head dim) per paged attention layer, sorted
        by name: the (name, leaf) order ``_init_page_store`` derives
        from a primed state, so the eager int8 store and the lazy bf16
        one address the same leaves."""
        out = []
        for n, v in self.net.conf.vertices.items():
            l = getattr(v, "layer", None)
            if getattr(l, "supports_streaming", False) \
                    and getattr(l, "cache_length", 0):
                hkv = getattr(l, "n_kv_heads", None) or l.n_heads
                out.append((n, int(hkv), int(l.n_out // l.n_heads)))
        return sorted(out)

    def _init_quant_store(self, dims) -> None:
        """The eager int8 store (``serving/quant.py``): zeroed ``[P, Hkv,
        page_size, D]`` int8 pools and ``[P, Hkv]`` f32 scale sidecars,
        two leaves (k, v) per attention layer."""
        self._paged_keys = [(n, k) for n, _, _ in dims
                            for k in ("kv_k", "kv_v")]
        self._page_store, self._scale_store = pool_leaves(
            self._pool.total_pages, self._ps, [(h, d) for _, h, d in dims],
            device=self.device)

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

    def _tables(self) -> torch.Tensor:
        if self._table_dev is None:
            t = np.zeros((self.slots, self._n_max), np.int32)
            for s, pages in enumerate(self._page_tables):
                t[s, :len(pages)] = pages
            self._table_dev = torch.as_tensor(t, device=self.device)
        return self._table_dev

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
        if self._kv_pos_dirty:
            free = torch.as_tensor([r is None for r in self._slots],
                                   device=self.device)
            for n in dict.fromkeys(n for n, _ in self._paged_keys):
                st[n]["kv_pos"] = torch.where(
                    free, torch.zeros_like(st[n]["kv_pos"]),
                    st[n]["kv_pos"])
            self._kv_pos_dirty = False
        self.net.state = st

    def _extract_paged_state(self) -> None:
        """Drop the paged view from ``net.state`` after the forward."""
        st = dict(self.net.state)
        for n in dict.fromkeys(n for n, _ in self._paged_keys):
            st[n] = {k: v for k, v in st[n].items() if k not in _VIEW_KEYS}
        self.net.state = st

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
        if self._pool is not None:
            self._install_paged_state()
        t0 = time.perf_counter()
        probs = step_tokens(self.net, toks)    # host copy: synchronizes
        self.dispatch_s_total += time.perf_counter() - t0
        self.dispatches += 1
        if self._pool is not None:
            self._extract_paged_state()
        for s, req in enumerate(self._slots):
            if req is not None:
                self._row_pos[s] += 1
        self._sync_accounting()
        return probs

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
            self._table_dev = None
            self._kv_pos_dirty = True
        if exc is not None:
            req.handle._fail(exc, reason)
        else:
            req.handle._finish(reason)

    # ------------------------------------------------------------------
    # arena state plumbing
    # ------------------------------------------------------------------
    def _build_arena(self, primed_state, base_state):
        """First-admission skeleton: every stream key of the primed
        structure at S zeroed rows, the per-row kv_pos vector at 0. In
        paged mode the dense kv_k/kv_v leaves are dropped: the pool is
        the only KV storage."""
        S = self.slots
        arena = {}
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
                    d[k] = torch.zeros(S, dtype=v.dtype, device=v.device)
                else:                      # batch-leading cache
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
        return int(max(self.net._stream_pos_map.values(), default=0))

    def _sync_accounting(self) -> None:
        """Engine-owned host position mirror: the streaming budget guard
        sees the furthest ACTIVE row, so an idle slot whose device
        position coasts never trips it."""
        rows = [int(self._row_pos[s]) for s, r in enumerate(self._slots)
                if r is not None]
        pos = max(rows, default=0)
        self.net._stream_pos_map = {n: pos for n in self._graph_vertices}

    # ------------------------------------------------------------------
    # warmup and lifecycle
    # ------------------------------------------------------------------
    def warmup(self, max_prompt_len: Optional[int] = None,
               steps: int = 2) -> "GenerationEngine":
        """Drive one synthetic greedy request through admission, prime
        and decode before traffic, so the first real request does not
        pay the one-time setup: the arena and page pool allocations,
        the CUDA kernel library's build and load, the matmul library's
        handles. Eager PyTorch compiles nothing per shape, so where the
        JAX engine warms one request per prime bucket, one request of
        ``max_prompt_len`` tokens (default: capacity - 1) covers every
        prompt length. The prefix cache is bypassed, so warmup prompts
        never occupy it."""
        if self._worker is not None and self._worker.is_alive():
            raise RuntimeError("warm up before start(): warmup drives "
                               "step() manually")
        top = max_prompt_len
        if top is None:
            top = (self._cap - 1) if self._cap is not None else 64
        if self._cap is not None:
            top = min(int(top), self._cap - 1)
        prefix, self._prefix = self._prefix, None
        try:
            h = self.submit([1 if self.V > 1 else 0] * max(1, int(top)),
                            steps=steps, top_k=1,
                            rng=np.random.default_rng(0))
            self.run_until_idle()
            h.result(timeout=0)
        finally:
            self._prefix = prefix
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
                    self._pending.wait(0.02)
        except Exception as e:  # noqa: BLE001 — strand no waiters
            log.exception("GenerationEngine loop died")
            self._break(e)

    def _break(self, exc: BaseException) -> None:
        """Terminal failure: fail every in-flight and queued request with
        the original error and refuse new work."""
        with self._lock:
            self._broken = exc
            self._stop.set()
            if self._seating is not None:
                req, self._seating = self._seating, None
                if not req.handle.done:
                    req.handle._fail(exc)
            for s, req in enumerate(self._slots):
                if req is not None:
                    self._retire(s, "error", exc)
            for req in self._pending.close():
                req.handle._fail(exc)

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
