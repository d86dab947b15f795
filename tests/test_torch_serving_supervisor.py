"""The port's serving survivability (deeplearning4j_tpu_torch/serving/
supervisor.py, overload.py, the engine's rebuild, chaos seams,
``decode_retry`` and ``drain()``) on the CPU, torch against torch: the
contracts the JAX package pins inside itself (tests/test_serving_
supervisor.py), re-pinned on the port.

- Recovery: a mid-stream fault rebuilds the arena and every stream ends
  equal to an unperturbed run's, greedy and sampled, over the slot arena,
  the net's own page pool ("bf16" by name; f32 here), the int8 pool and
  speculation; a burst within the budget; the old arena's tensors are
  released (weak references die) but the page store, which is zeroed in
  place before the re-primes; an int8 arena left with huge scales by
  the fault recovers only because the rebuild starts from zeroed pools
  (with the zeroing taken out the re-prime reads them and the streams
  change); a fault mid-rebuild strands nobody; an expired survivor fails
  at the rebuild.
- Escalation: a spent budget fails every waiter with the original error
  and writes a flight record; a zero budget is the unsupervised fail-all;
  ``decode_retry`` rides out a transient fault with no rebuild.
- The pop-to-seat window, the request-targeted injector and the page
  seizure.
- Overload: shedding lowest priority first, early rejection (an injected
  ETA, and none before the rate calibrates), the brownout ladder (enter,
  hold, release; prefix inserts off; greedy streams unchanged), drain;
  the admission queue's shedding, snapshot, requeue and close.
"""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.monitoring import flightrecorder
from deeplearning4j_tpu_torch.monitoring.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.resilience.retry import (
    RestartBudget, RetryPolicy)
from deeplearning4j_tpu_torch.serving import (
    AdmissionQueue, EngineShutdown, EngineSupervisor, GenerationEngine,
    GenerationRequest, InferenceTimeout, OverloadConfig, OverloadController,
    PagedKVConfig, RequestCancelled, ServingOverloaded, SpeculationConfig)
from deeplearning4j_tpu_torch.serving.health import (
    SERVING_DRAINING, SERVING_ENGINE_ESCALATIONS, SERVING_ENGINE_REBUILDS,
    SERVING_RECOVERED_REQUESTS)
from deeplearning4j_tpu_torch.util.decoding import prompt_lookup_proposer
from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
from torch_threads import one_thread  # noqa: F401 (autouse)

V, PS = 12, 4
PROMPTS = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10, 1], [2, 4, 6]]
SHARED = [3, 1, 2, 0] * 2                 # two full 4-token blocks


@pytest.fixture(autouse=True, scope="module")
def _flight_records(tmp_path_factory):
    """The engines that break here write their flight records into a
    temporary directory."""
    flightrecorder.set_flight_dir(str(tmp_path_factory.mktemp("flight")))
    yield
    flightrecorder.set_flight_dir(None)


@pytest.fixture(scope="module")
def net():
    return TextGenerationTransformer(
        vocab_size=V, embed_dim=16, n_heads=2, n_layers=2, max_length=32,
        positional="rope").init(device="cpu")


def _spec():
    return SpeculationConfig(draft=prompt_lookup_proposer(2), gamma=2)


#: the arenas a rebuild must restore: the slot arena, the page pool in
#: the net's dtype, the int8 pool, and speculation over the page pool
ARENAS = {"slots": {},
          "paged": dict(paging=PagedKVConfig(page_size=PS)),
          "int8": dict(paging=PagedKVConfig(page_size=PS, kv_dtype="int8")),
          "spec": dict(paging=PagedKVConfig(page_size=PS),
                       speculation=_spec())}


def _run(net, prompts=None, steps=5, sampled=False, n_slots=2, **kw):
    """Drive a trace to completion on a fresh engine; returns (engine,
    handles)."""
    eng = GenerationEngine(net, V, slots=n_slots, device="cpu", **kw)
    hs = []
    for i, p in enumerate(prompts or PROMPTS[:3]):
        s = (dict(temperature=1.3, top_p=0.9) if sampled
             else dict(top_k=1))
        hs.append(eng.submit(p, steps=steps,
                             rng=np.random.default_rng(i), **s))
    eng.run_until_idle()
    return eng, hs


def _outs(handles):
    return [h.result(timeout=0) for h in handles]


_BASE = {}


def _want(net, key, **kw):
    """The unperturbed run's streams, once per configuration."""
    if key not in _BASE:
        _BASE[key] = _outs(_run(net, **kw)[1])
    return _BASE[key]


# ---------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------
@pytest.mark.parametrize("arena", list(ARENAS))
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_a_rebuild_continues_every_stream_exactly(net, arena, sampled):
    """f32: the streams after a decode fault's rebuild equal the
    unperturbed run's token for token (the rng is host-side and a failed
    dispatch never drew from it)."""
    cfg = dict(ARENAS[arena], sampled=sampled)
    want = _want(net, (arena, sampled), **cfg)
    sup = EngineSupervisor(budget=RestartBudget(3, 60.0))
    eng, hs = _run(net, supervisor=sup,
                   decode_chaos=chaos.FaultBurstInjector(n=2, k=1), **cfg)
    assert _outs(hs) == want
    assert eng.is_healthy()
    assert sup.rebuilds == 1 and sup.recovered_requests >= 1
    assert sup.escalations == 0
    if eng.page_pool is not None:        # fresh pool: no page leaked
        held = len(eng.prefix_cache) if eng.prefix_cache else 0
        assert eng.page_pool.used_count() == held


def test_paged_prefix_cache_is_reseeded_by_the_reprimes(net):
    prompts = [SHARED + [5], SHARED + [7, 8], [9, 9]]
    cfg = dict(prompts=prompts, paging=PagedKVConfig(page_size=PS))
    want = _want(net, "prefix", **cfg)
    sup = EngineSupervisor()
    eng, hs = _run(net, supervisor=sup,
                   decode_chaos=chaos.FaultBurstInjector(n=3, k=1), **cfg)
    assert _outs(hs) == want
    assert sup.rebuilds == 1
    assert eng.prefix_cache.hits >= 1      # a re-prime took a hit
    assert eng.page_pool.used_count() == len(eng.prefix_cache)


def test_a_burst_within_the_budget_costs_one_rebuild_a_fault(net):
    want = _want(net, "steps7", steps=7)
    sup = EngineSupervisor(budget=RestartBudget(3, 60.0))
    eng, hs = _run(net, steps=7, supervisor=sup,
                   decode_chaos=chaos.FaultBurstInjector(n=1, k=3))
    assert _outs(hs) == want
    assert sup.rebuilds == 3 and eng.is_healthy()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_the_rebuild_releases_the_old_arena(net, kv):
    """Every tensor of the old arena but the page store dies with the
    rebuild (the cached table, the views and rows in ``net.state``),
    even while the supervisor keeps the fault whose traceback saw them:
    on the card the rebuild must not double the KV memory. The page
    store (the pools and, int8, the scale sidecars) is the one built
    first, zeroed in place before the re-primes: a rebuild allocates no
    large block, whose counted bytes would depend on the allocator's
    cache (ROADMAP.md C9)."""
    eng = GenerationEngine(net, V, slots=2, device="cpu",
                           supervisor=EngineSupervisor(),
                           paging=PagedKVConfig(page_size=PS, kv_dtype=kv))
    hs = [eng.submit(p, steps=6, top_k=1) for p in PROMPTS[:2]]
    eng.step()
    eng.step()
    store = list(eng._page_store) + list(eng._scale_store or ())
    assert any(bool(t.any()) for t in store)
    old = [weakref.ref(eng._tables())]
    old += [weakref.ref(v) for s in net.state.values()
            if isinstance(s, dict) for v in s.values()
            if isinstance(v, torch.Tensor) and
            not any(v is t for t in store)]
    at_readmit = []
    real_admit = eng._admit_one

    def admit(req, slot, readmit=False):
        if readmit and not at_readmit:     # the first re-prime's store
            at_readmit.append([bool(t.any()) for t in store])
        return real_admit(req, slot, readmit=readmit)
    eng._admit_one = admit
    eng._decode_chaos = chaos.FaultBurstInjector(k=1)
    eng.step()                              # fault, rebuild
    gc.collect()
    assert eng._supervisor.rebuilds == 1
    assert eng._supervisor.last_fault is not None
    assert [r for r in old if r() is not None] == []
    kept = list(eng._page_store) + list(eng._scale_store or ())
    assert len(kept) == len(store) and all(
        a is b for a, b in zip(kept, store))
    assert at_readmit == [[False] * len(store)]
    eng.run_until_idle()
    assert all(h.result(timeout=0) for h in hs)


def _poison_then_fault(eng):
    """A fault that leaves the int8 arena's pools and scales huge (a
    poisoned arena: dequantized, every entry overflows to inf)."""
    def fault():
        for p in eng._page_store:
            p.fill_(127)
        for s in eng._scale_store:
            s.fill_(2.0 ** 126)
        return chaos.InjectedFault()
    return chaos.FaultBurstInjector(n=1, k=1, exc=fault)


@pytest.mark.parametrize("zeroed", [True, False],
                         ids=["zeroed", "zeroing_taken_out"])
def test_an_int8_rebuild_starts_from_zeroed_pools(net, monkeypatch,
                                                  zeroed):
    """The re-prime reads every page of its row's table through the
    dequantizing gather, the reserved pages not yet written included
    (masked, but a masked inf times its zero weight is NaN). A rebuild
    that kept the old store would read the scales the fault left there:
    with the zeroing taken out the streams change."""
    cfg = ARENAS["int8"]
    want = _want(net, ("int8", False), **cfg)
    eng = GenerationEngine(net, V, slots=2, device="cpu",
                           supervisor=EngineSupervisor(), **cfg)
    eng._decode_chaos = _poison_then_fault(eng)
    if not zeroed:
        def no_zeroing():                     # the old values kept
            eng._table_dev = eng._new_table()
        monkeypatch.setattr(eng, "_zero_page_store", no_zeroing)
    hs = [eng.submit(p, steps=5, top_k=1, rng=np.random.default_rng(i))
          for i, p in enumerate(PROMPTS[:3])]
    eng.run_until_idle()
    got = [h.result(timeout=0) if h.error is None else None for h in hs]
    if zeroed:
        assert eng._supervisor.rebuilds == 1 and got == want
    else:
        # the re-primes read the inf entries: NaN distributions, a
        # rebuild a step until the budget escalates
        assert got != want and eng._supervisor.escalations == 1


def test_a_fault_mid_rebuild_strands_no_waiters(net):
    sup = EngineSupervisor()
    eng = GenerationEngine(net, V, slots=2, device="cpu", supervisor=sup,
                           decode_chaos=chaos.FaultBurstInjector(n=1, k=1))
    hs = [eng.submit(p, steps=6, top_k=1) for p in PROMPTS[:2]]
    orig_admit = eng._admit_one
    state = {"readmits": 0}

    def flaky_admit(req, slot, readmit=False):
        if readmit:
            state["readmits"] += 1
            if state["readmits"] == 2:     # the second survivor's seat
                raise RuntimeError("device died mid-rebuild")
        return orig_admit(req, slot, readmit=readmit)
    eng._admit_one = flaky_admit
    eng.run_until_idle()
    assert all(h.done for h in hs), "a survivor was stranded"
    assert not eng.is_healthy()
    assert sup.rebuilds == 0 and sup.escalations == 1


def test_an_expired_survivor_fails_at_the_rebuild(net):
    sup = EngineSupervisor()
    eng = GenerationEngine(net, V, slots=1, device="cpu", supervisor=sup)
    h = eng.submit(PROMPTS[0], steps=20, top_k=1, timeout=60.0)
    eng.step()                             # seated, mid-stream

    def expire_then_fault():
        eng._slots[0].deadline = time.monotonic() - 1.0
        return chaos.InjectedFault()
    eng._decode_chaos = chaos.FaultBurstInjector(k=1, exc=expire_then_fault)
    eng.run_until_idle()
    with pytest.raises(InferenceTimeout):
        h.result(timeout=2.0)
    assert eng.is_healthy()
    assert sup.rebuilds == 1 and sup.recovered_requests == 0


def test_one_controller_and_one_supervisor_an_engine(net):
    ctl = OverloadController(OverloadConfig())
    GenerationEngine(net, V, slots=1, device="cpu", overload=ctl)
    with pytest.raises(ValueError, match="one OverloadController"):
        GenerationEngine(net, V, slots=1, device="cpu", overload=ctl)
    sup = EngineSupervisor()
    GenerationEngine(net, V, slots=1, device="cpu", supervisor=sup)
    with pytest.raises(ValueError, match="one EngineSupervisor"):
        GenerationEngine(net, V, slots=1, device="cpu", supervisor=sup)


def test_rebuild_telemetry_and_health(net):
    reg = MetricsRegistry()
    sup = EngineSupervisor()
    eng, hs = _run(net, registry=reg, name="engine:sup", supervisor=sup,
                   decode_chaos=chaos.FaultBurstInjector(n=2, k=1))
    assert all(h.done for h in hs)
    snap = reg.snapshot_compact()
    assert snap[SERVING_ENGINE_REBUILDS
                + "{cause=decode_fault,model=engine:sup}"] == 1
    assert snap[SERVING_RECOVERED_REQUESTS + "{model=engine:sup}"] >= 1
    h = eng.health()
    assert h["supervisor"]["rebuilds"] == 1
    assert h["supervisor"]["last_cause"] == "decode_fault"
    assert [e["name"] for e in h["last_events"]] == ["rebuild"]
    assert any(r["event"] == "rebuild" for r in hs[0].trace().events())


# ---------------------------------------------------------------------
# escalation, retry
# ---------------------------------------------------------------------
def test_a_spent_budget_escalates_to_fail_all(net, tmp_path):
    reg = MetricsRegistry()
    flightrecorder.set_flight_dir(str(tmp_path))
    flightrecorder.reset_for_tests()
    try:
        sup = EngineSupervisor(budget=RestartBudget(2, 60.0))
        eng, hs = _run(net, supervisor=sup, registry=reg,
                       name="engine:esc",
                       decode_chaos=chaos.FaultBurstInjector(n=1, k=10))
        record = flightrecorder.last_record_path()
    finally:
        flightrecorder.set_flight_dir(str(tmp_path / "after"))
        flightrecorder.reset_for_tests()
    assert not eng.is_healthy()
    assert sup.escalations == 1
    snap = reg.snapshot_compact()
    assert snap[SERVING_ENGINE_ESCALATIONS + "{model=engine:esc}"] == 1
    assert snap[SERVING_ENGINE_REBUILDS
                + "{cause=decode_fault,model=engine:esc}"] == 2
    for h in hs:
        assert h.done
        with pytest.raises(chaos.InjectedFault):
            h.result(timeout=0)
    with pytest.raises(EngineShutdown):
        eng.submit([1, 2], steps=2)
    assert record is not None and record.startswith(str(tmp_path))
    rec = flightrecorder.read_record(record)
    assert rec["header"]["trigger"] in ("supervisor_escalation",
                                        "engine_break")
    assert rec["header"]["health"]["supervisor"]["escalations"] == 1


def test_a_zero_budget_is_the_unsupervised_fail_all(net):
    sup = EngineSupervisor(budget=RestartBudget(0, 60.0))
    eng, _ = _run(net, supervisor=sup,
                  decode_chaos=chaos.FaultBurstInjector(n=1, k=1))
    assert not eng.is_healthy() and sup.rebuilds == 0


def test_decode_retry_rides_out_a_transient_fault(net):
    """The chaos hook fires inside the retried callable, before any
    state mutates: a retried dispatch is the fault-free one, and no
    rebuild happens."""
    want = _want(net, ("paged", False), **ARENAS["paged"])
    sup = EngineSupervisor()
    eng, hs = _run(net, supervisor=sup,
                   decode_retry=RetryPolicy(max_attempts=3, base_delay=0.0,
                                            retry_on=(chaos.InjectedFault,)),
                   decode_chaos=chaos.FaultBurstInjector(n=2, k=2),
                   **ARENAS["paged"])
    assert _outs(hs) == want
    assert sup.rebuilds == 0 and eng.is_healthy()


def test_the_budget_window_slides():
    t = [0.0]
    b = RestartBudget(2, 10.0, clock=lambda: t[0])
    assert b.try_acquire() and b.try_acquire()
    assert not b.try_acquire()
    t[0] = 10.5
    assert b.remaining() == 2
    assert b.try_acquire()


# ---------------------------------------------------------------------
# the pop-to-seat window and the targeted injectors
# ---------------------------------------------------------------------
def test_a_seat_fault_without_a_supervisor_fails_terminally(net):
    eng = GenerationEngine(net, V, slots=1, device="cpu",
                           seat_chaos=chaos.RaiseOnBatch(None, n=1))
    h0 = eng.submit(PROMPTS[0], steps=4, top_k=1)
    h1 = eng.submit(PROMPTS[1], steps=4, top_k=1)
    eng.run_until_idle()
    with pytest.raises(chaos.InjectedFault):
        h1.result(timeout=2.0)
    assert not eng.is_healthy() and h0.done


def test_a_seat_fault_recovers_with_a_supervisor(net):
    want = _want(net, ("slots", False))
    sup = EngineSupervisor()
    eng, hs = _run(net, supervisor=sup, n_slots=1,
                   seat_chaos=chaos.RaiseOnBatch(None, n=1))
    assert _outs(hs) == want
    assert eng.is_healthy() and sup.last_cause == "admission_fault"


def test_a_cancelled_seating_request_is_not_readmitted(net):
    def cancel_then_fault(r):
        r.handle.cancel()
        return True
    sup = EngineSupervisor()
    eng = GenerationEngine(
        net, V, slots=1, device="cpu", supervisor=sup,
        seat_chaos=chaos.RequestFaultInjector(match=cancel_then_fault))
    h = eng.submit(PROMPTS[0], steps=4, top_k=1)
    eng.run_until_idle()
    with pytest.raises(RequestCancelled):
        h.result(timeout=2.0)
    assert eng.is_healthy()
    assert sup.rebuilds == 1 and sup.recovered_requests == 0


def test_a_prefill_fault_fails_its_victim_only(net):
    want = _want(net, ("slots", False))
    inj = chaos.RequestFaultInjector(match=lambda r: r.prompt == PROMPTS[1])
    eng, hs = _run(net, prefill_chaos=inj)
    with pytest.raises(chaos.InjectedFault):
        hs[1].result(timeout=0)
    assert hs[0].result(timeout=0) == want[0]
    assert hs[2].result(timeout=0) == want[2]
    assert eng.is_healthy()


def test_a_page_seizure_leaves_the_actives_exact(net):
    """The seizure takes only free pages: the actives finish as the
    unperturbed run's, a newcomer waits at the head of the queue until
    the incident ends."""
    want = _want(net, ("paged", False), **ARENAS["paged"])
    eng = GenerationEngine(net, V, slots=2, device="cpu",
                           **ARENAS["paged"])
    inj = chaos.PageExhaustionInjector(eng.page_pool, n=1)
    eng._decode_chaos = inj
    hs = [eng.submit(p, steps=5, top_k=1, rng=np.random.default_rng(i))
          for i, p in enumerate(PROMPTS[:3])]
    for _ in range(3):
        eng.step()
    assert inj.faults_fired == 1 and eng.page_pool.free_count() == 0
    assert hs[2].generated == []           # head-blocked: no pages
    inj.release()
    eng.run_until_idle()
    assert _outs(hs) == want


# ---------------------------------------------------------------------
# overload control and drain
# ---------------------------------------------------------------------
def test_early_rejection_by_an_injected_eta(net):
    ov = OverloadConfig(queue_eta=lambda e, r, now: 10.0)
    eng = GenerationEngine(net, V, slots=1, device="cpu", overload=ov)
    with pytest.raises(ServingOverloaded):
        eng.submit([1, 2], steps=2, top_k=1, timeout=1.0)
    h = eng.submit([1, 2], steps=2, top_k=1, timeout=60.0)
    h2 = eng.submit([3, 4], steps=2, top_k=1)
    eng.run_until_idle()
    assert h.result(timeout=0) and h2.result(timeout=0)
    assert eng.health()["overload"]["early_rejected_total"] == 1
    # the default estimator never rejects before the rate calibrates
    eng = GenerationEngine(net, V, slots=1, device="cpu",
                           overload=OverloadConfig(min_samples=2))
    h = eng.submit([1, 2], steps=2, top_k=1, timeout=30.0)
    eng.run_until_idle()
    assert h.result(timeout=0)


def test_a_sustained_breach_sheds_the_lowest_priority_first(net):
    ov = OverloadConfig(ttft_slo_s=0.001, min_samples=2, breach_window=4,
                        shed_to_depth=2)
    eng = GenerationEngine(net, V, slots=1, device="cpu", overload=ov,
                           queue_limit=16)
    for _ in range(4):
        eng._overload.observe_ttft(1.0, time.monotonic())
    hi = eng.submit([1, 2], steps=4, top_k=1, priority=5)
    mid = eng.submit([3, 4], steps=4, top_k=1, priority=1)
    lo1 = eng.submit([5, 6], steps=4, top_k=1, priority=0)
    lo2 = eng.submit([7, 8], steps=4, top_k=1, priority=0)
    eng.step()
    for h in (lo1, lo2):
        with pytest.raises(ServingOverloaded):
            h.result(timeout=2.0)
    eng.run_until_idle()
    assert hi.result(timeout=0) and mid.result(timeout=0)
    assert eng._overload.shed_total == 2
    # a shed clears the evidence: the next round needs new samples
    ov = OverloadConfig(ttft_slo_s=0.001, min_samples=2, breach_window=4,
                        shed_to_depth=0)
    eng = GenerationEngine(net, V, slots=1, device="cpu", overload=ov,
                           queue_limit=16)
    for _ in range(4):
        eng._overload.observe_ttft(1.0, time.monotonic())
    eng.submit([1, 2], steps=2, top_k=1)
    assert len(eng._overload.shed(eng)) == 1
    eng.submit([3, 4], steps=2, top_k=1)
    assert eng._overload.shed(eng) == []


def _spec_engine(net, fracs=(0.5, 0.3, 0.1)):
    return GenerationEngine(
        net, V, slots=2, device="cpu",
        overload=OverloadConfig(brownout_enter_fracs=fracs),
        paging=PagedKVConfig(page_size=PS), speculation=_spec())


def test_the_brownout_ladder_enters_holds_and_releases(net):
    eng = _spec_engine(net)
    pool = eng.page_pool
    h = eng.submit([1, 2, 3], steps=10, top_k=1)
    eng.step()
    assert eng._brownout == 0
    pool.seize(pool.free_count() - int(0.35 * pool.usable))
    eng.step()
    assert eng._brownout == 1              # reduced gamma
    pool.seize(pool.free_count() - int(0.05 * pool.usable))
    eng.step()
    assert eng._brownout == 3              # spec off + no prefix inserts
    pool.restore()
    eng.step()
    assert eng._brownout == 0
    eng.run_until_idle()
    assert h.result(timeout=0)
    # hysteresis: inside the clear margin the rung holds
    ctl = eng._overload
    pool.seize(pool.free_count() - int(0.45 * pool.usable))
    assert ctl.brownout_level(eng) == 1
    pool.restore()
    pool.seize(pool.free_count() - int(0.55 * pool.usable))
    assert ctl.brownout_level(eng) == 1
    pool.restore()
    assert ctl.brownout_level(eng) == 0
    with pytest.raises(ValueError, match="brownout_clear_margin"):
        OverloadConfig(brownout_clear_margin=-0.1)


def test_brownout_stops_prefix_inserts_and_the_rebuild_resets_it(net):
    prompts = [SHARED + [5], SHARED + [7, 8]]
    cfg = dict(prompts=prompts, paging=PagedKVConfig(page_size=PS))
    want = _want(net, "brownout_prefix", **cfg)
    eng = GenerationEngine(net, V, slots=2, device="cpu",
                           supervisor=EngineSupervisor(),
                           overload=OverloadConfig(),
                           paging=PagedKVConfig(page_size=PS))
    hs = [eng.submit(p, steps=5, top_k=1, rng=np.random.default_rng(i))
          for i, p in enumerate(prompts)]
    eng.step()
    pool = eng.page_pool
    pool.seize(pool.free_count())          # total pressure: rung 3
    eng.step()
    assert eng._brownout == 3
    eng._decode_chaos = chaos.FaultBurstInjector(k=1)
    eng.run_until_idle()                   # fault -> rebuild
    assert eng._brownout == 0              # fresh pool: recomputed
    assert len(eng.prefix_cache) > 0       # re-seeded, not skipped
    assert _outs(hs) == want


@pytest.mark.parametrize("rung", [1, 3])
def test_greedy_streams_are_unchanged_under_brownout(net, rung):
    """The verify keeps its width 1 + gamma at every rung: a reduced
    gamma (rung 1) or none (rung 3) pads the same widened forward."""
    want = _want(net, ("spec", False), **ARENAS["spec"])
    fracs = (0.99, 0.98, 0.97) if rung == 3 else (0.99, 0.0, 0.0)
    eng = _spec_engine(net, fracs=fracs)
    widths = []
    # every forward's width, primes and dispatches alike: the host part
    # of rnn_time_step that both run (the dispatch runs its device part
    # as the decode graph's body)
    real = eng.net._stream_begin

    def record(t):
        widths.append(t)
        return real(t)
    eng.net._stream_begin = record
    try:
        hs = [eng.submit(p, steps=5, top_k=1, rng=np.random.default_rng(i))
              for i, p in enumerate(PROMPTS[:3])]
        eng.run_until_idle()
    finally:
        del eng.net._stream_begin
    assert eng._brownout == rung
    assert _outs(hs) == want
    assert widths.count(3) == eng.dispatches   # every decode at 1 + gamma


def test_drain_finishes_the_actives_and_fails_the_queued(net):
    reg = MetricsRegistry()
    eng = GenerationEngine(net, V, slots=1, device="cpu", registry=reg,
                           name="engine:drain")
    key = SERVING_DRAINING + "{model=engine:drain}"
    assert reg.snapshot_compact()[key] == 0.0
    act = eng.submit(PROMPTS[0], steps=6, top_k=1)
    queued = eng.submit(PROMPTS[1], steps=6, top_k=1)
    eng.step()
    assert eng.drain(timeout=60.0)
    assert act.done and act.error is None and len(act.generated) == 6
    with pytest.raises(EngineShutdown):
        queued.result(timeout=0)
    with pytest.raises(EngineShutdown):
        eng.submit([1], steps=1)
    assert not eng.is_ready() and eng.health()["draining"] is True
    assert eng.active_slots() == 0
    assert reg.snapshot_compact()[key] == 1.0
    # a timeout reports False while an active is still seated
    eng = GenerationEngine(net, V, slots=1, device="cpu")
    eng.submit([1, 2], steps=20, top_k=1)
    eng.step()
    assert eng.drain(timeout=0.0) is False
    assert eng.active_slots() == 1


def test_drain_under_the_background_loop(net):
    eng = GenerationEngine(net, V, slots=2, device="cpu").start()
    try:
        hs = [eng.submit(p, steps=5, top_k=1,
                         rng=np.random.default_rng(i))
              for i, p in enumerate(PROMPTS[:2])]
        t0 = time.monotonic()
        while eng.active_slots() < 2 and not all(h.done for h in hs):
            assert time.monotonic() - t0 < 60, "never admitted"
            time.sleep(0.005)
        assert eng.drain(timeout=60.0)
        for h in hs:
            assert h.result(timeout=0)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------
# the admission queue's shedding and closing primitives
# ---------------------------------------------------------------------
def test_the_queue_sheds_lowest_youngest_first_and_counts_ahead():
    q = AdmissionQueue(limit=16)
    rs = [GenerationRequest([i], 1, priority=p)
          for i, p in enumerate([2, 0, 0, 1, 0])]
    for r in rs:
        q.submit(r)
    assert q.depth_ahead(2) == 1 and q.depth_ahead(1) == 2
    assert q.depth_ahead(0) == 5
    assert q.peek_all() == [rs[0], rs[3], rs[1], rs[2], rs[4]]
    snap = q.snapshot()
    assert snap.depth == 5 and snap.per_priority == {2: 1, 0: 3, 1: 1}
    # lowest class (0) youngest first, then the next class up
    assert q.shed_lowest(keep=2) == [rs[4], rs[2], rs[1]]
    assert q.depth() == 2 and q.shed_lowest(keep=5) == []
    q.close()
    q.requeue(rs[4])                  # survivors ride a closed queue
    assert q.peek_all() == [rs[4]]


def test_close_wakes_every_blocked_submitter():
    q = AdmissionQueue(limit=1, policy="block")
    q.submit(GenerationRequest([1], 1))
    results = []

    def blocked(i):
        try:
            q.submit(GenerationRequest([i], 1))
            results.append("in")
        except EngineShutdown:
            results.append("shutdown")
    ts = [threading.Thread(target=blocked, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.1)
    assert len(q.close()) == 1
    for t in ts:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in ts)
    assert results == ["shutdown"] * 4
