"""The port's request ledger, traces, registry and health, and its LSTM
slot arena (deeplearning4j_tpu_torch/serving/request.py, health.py and
the engine) against the JAX package on the CPU, f32, with the same
seeded weights. The JAX engine reads its pools through its XLA path
(``decode_impl="xla"``).

- The ledger's wire form: ``RequestLedgerEntry.payload()`` of the same
  traffic mid-stream is the JAX payload, key for key and value for
  value (the rng state included; the trace's timestamps aside, its
  event names equal); a JAX payload, through JSON, admitted into the
  port's engine (``admit_from_ledger``) continues the greedy and the
  sampled streams the JAX engine gives.
- The same traffic with a supervisor and one decode fault: each
  request's trace has the JAX trace's events in order; the registry has
  the JAX engine's ``dl4jtpu_serving_*`` series and label sets, and the
  counters read the same (requests, tokens, errors, rebuilds by cause,
  recovered requests, prefix hits); ``health()["kv_traffic"]``'s bytes
  equal the JAX engine's KV model on its ``direct-pallas`` term (the
  kernel's read, the port's one path) on the same row positions, over
  the net's own pool and the int8 pool.
- The LSTM arena: greedy streams equal the JAX engine's and the port's
  ``sample_stream``; every decode step runs each GravesLSTM's recurrence
  once at batch S (on the card: row 17's kernel); a rebuild re-primes
  h / c and the streams go on exactly; the refusals that stay (a page
  pool, speculation) raise in both packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.monitoring.metrics import (
    MetricsRegistry as JaxRegistry)
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.resilience import chaos as jax_chaos
from deeplearning4j_tpu.serving import (
    EngineSupervisor as JaxSupervisor, GenerationEngine as JaxEngine,
    PagedKVConfig as JaxPaged, RequestLedgerEntry as JaxEntry,
    SpeculationConfig as JaxSpec)
from deeplearning4j_tpu.util.decoding import (
    prompt_lookup_proposer as jax_proposer)
from deeplearning4j_tpu.zoo import (
    TextGenerationLSTM as JaxLSTM, TextGenerationTransformer as JaxTFM)
from deeplearning4j_tpu_torch.monitoring.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.nn.layers import lstm_kernel
from deeplearning4j_tpu_torch.resilience import chaos
from deeplearning4j_tpu_torch.serving import (
    EngineSupervisor, GenerationEngine, PagedKVConfig, RequestLedgerEntry,
    SpeculationConfig)
from deeplearning4j_tpu_torch.util.decoding import prompt_lookup_proposer
from deeplearning4j_tpu_torch.zoo import (
    TextGenerationLSTM, TextGenerationTransformer)
from torch_threads import one_thread  # noqa: F401 (autouse)

V, E, HEADS, LAYERS, MAXLEN, PS = 16, 16, 2, 2, 32, 4
SYS = [1, 2, 3, 4, 5, 6, 7, 8]             # two full shared blocks
PROMPTS = [SYS + [9, 10], [3, 4, 5], SYS + [12], [7, 6, 5, 4, 3]]
SAMPLED = [dict(top_k=1), dict(temperature=0.8),
           dict(top_k=5, temperature=1.2), dict(top_p=0.9)]
STEPS = 6


@pytest.fixture(scope="module")
def nets():
    kw = dict(vocab_size=V, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
              max_length=MAXLEN, positional="rope")
    jnet = JaxTFM(**kw).init()
    rng = np.random.default_rng(7)
    np_params = {v: {k: np.asarray(a, np.float32) if k.startswith("W")
                     else rng.normal(float(k == "gamma"), 0.2, a.shape)
                     .astype(np.float32) for k, a in p.items()}
                 for v, p in jnet.params.items()}
    jnet.params = {v: {k: jnp.asarray(a) for k, a in p.items()}
                   for v, p in np_params.items()}
    tnet = TextGenerationTransformer(**kw).init(device="cpu") \
        .load_numpy_params(np_params)
    saved = jax_layers.paged_decode_impl()
    yield jnet, tnet
    jax_layers.set_paged_decode_impl(*saved)


def _jax_engine(jnet, kv="bf16", **kw):
    return JaxEngine(jnet, V, slots=2, paging=JaxPaged(
        page_size=PS, kv_dtype=kv, decode_impl="xla"), **kw)


def _port_engine(tnet, kv="bf16", **kw):
    return GenerationEngine(tnet, V, slots=2, device="cpu",
                            paging=PagedKVConfig(page_size=PS, kv_dtype=kv),
                            **kw)


def _submit(eng, sampled):
    return [eng.submit(p, steps=STEPS, rng=np.random.default_rng(i),
                       **(SAMPLED[i] if sampled else dict(top_k=1)))
            for i, p in enumerate(PROMPTS)]


def _events(trace):
    return [r["event"] for r in trace.events()]


# ---------------------------------------------------------------------
# the ledger's wire form
# ---------------------------------------------------------------------
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_the_ledger_continues_across_the_packages(nets, sampled):
    """Mid-stream, the port's payloads equal the JAX engine's; then the
    JAX payloads, through JSON, continue in the port's engine as they do
    in the JAX engine."""
    jnet, tnet = nets
    jeng, teng = _jax_engine(jnet), _port_engine(tnet)
    jh, th = _submit(jeng, sampled), _submit(teng, sampled)
    for _ in range(3):
        jeng.step()
        teng.step()
    jp = [e.payload() for e in jeng.export_ledger(include_queued=True)]
    tp = [e.payload() for e in teng.export_ledger(include_queued=True)]
    assert [p["phase"] for p in jp] == ["active", "active", "queued",
                                        "queued"]
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k != "trace"} == \
            {k: v for k, v in b.items() if k != "trace"}
        assert [r["event"] for r in a["trace"]["records"]] == \
            [r["event"] for r in b["trace"]["records"]]
    jeng.run_until_idle()
    teng.run_until_idle()           # (an engine owns its net's stream)
    want = [h.result(timeout=0) for h in jh]
    assert [h.result(timeout=0) for h in th] == want
    wire = json.loads(json.dumps(jp))
    entries = [RequestLedgerEntry.from_payload(p) for p in wire]
    fresh = _port_engine(tnet)
    assert fresh.admit_from_ledger(entries) == len(entries)
    fresh.run_until_idle()
    assert [e.request.handle.result(timeout=0) for e in entries] == want
    # and a port payload reads back in the JAX package
    back = JaxEntry.from_payload(json.loads(json.dumps(tp[0])))
    assert back.payload()["rng_state"] == tp[0]["rng_state"]


# ---------------------------------------------------------------------
# traces, the registry and the KV model, under one rebuild
# ---------------------------------------------------------------------
SERIES = ("dl4jtpu_serving_requests_total", "dl4jtpu_serving_tokens_total",
          "dl4jtpu_serving_errors_total",
          "dl4jtpu_serving_engine_rebuilds_total",
          "dl4jtpu_serving_recovered_requests_total",
          "dl4jtpu_serving_prefix_cache_hits_total",
          "dl4jtpu_serving_prefix_cache_misses_total",
          "dl4jtpu_serving_prefix_cache_reused_tokens_total",
          "dl4jtpu_serving_kv_bytes_moved_total")


def _series(snap):
    return {k: v for k, v in snap.items()
            if k.startswith("dl4jtpu_serving_")}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_traces_registry_and_kv_bytes_match_the_jax_engine(nets, kv):
    jnet, tnet = nets
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jeng = _jax_engine(jnet, kv, registry=jreg, name="engine:t",
                       supervisor=JaxSupervisor(),
                       decode_chaos=jax_chaos.FaultBurstInjector(n=3, k=1))
    # the JAX KV model's term for the kernel read (the port's one path)
    jeng._live_impl = lambda: "pallas"
    teng = _port_engine(tnet, kv, registry=treg, name="engine:t",
                        supervisor=EngineSupervisor(),
                        decode_chaos=chaos.FaultBurstInjector(n=3, k=1))
    jh, th = _submit(jeng, False), _submit(teng, False)
    jeng.run_until_idle()
    teng.run_until_idle()
    assert [h.result(timeout=0) for h in th] == \
        [h.result(timeout=0) for h in jh]
    for a, b in zip(th, jh):
        assert _events(a.trace()) == _events(b.trace())
    assert "rebuild" in _events(th[0].trace())
    js, ts = _series(jreg.snapshot_compact()), \
        _series(treg.snapshot_compact())
    assert sorted(ts) == sorted(js)
    for k in ts:
        if k.split("{")[0] in SERIES:
            assert ts[k] == js[k], k
    assert ts["dl4jtpu_serving_engine_rebuilds_total"
              "{cause=decode_fault,model=engine:t}"] == 1
    jt, tt = jeng.health()["kv_traffic"], teng.health()["kv_traffic"]
    assert tt["decode_path"] == "direct-plain"
    assert jt["decode_path"] == "direct-pallas"
    assert tt["bytes_moved_total"] == jt["bytes_moved_total"] > 0
    assert tt["kv_dtype"] == jt["kv_dtype"] == kv


# ---------------------------------------------------------------------
# the LSTM slot arena
# ---------------------------------------------------------------------
LV, LH, LLAYERS = 10, 12, 2
LPROMPTS = [[1, 2, 3, 4], [5, 6], [7, 8, 9]]


@pytest.fixture(scope="module")
def lstms():
    jnet = JaxLSTM(vocab_size=LV, hidden=LH, layers=LLAYERS,
                   max_length=40).init()
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jnet.params)
    rng = np.random.default_rng(0)
    for k in map(str, range(LLAYERS)):
        params[k]["b"] = params[k]["b"] + (0.2 * rng.standard_normal(
            params[k]["b"].shape)).astype(np.float32)
    jnet.params = jax.tree_util.tree_map(jnp.asarray, params)
    model = TextGenerationLSTM(vocab_size=LV, hidden=LH, layers=LLAYERS,
                               max_length=40)
    tnet = model.init(device="cpu")
    tnet.load_numpy_params(params)
    return jnet, tnet, model


def _lstm_trace(eng, steps=5):
    hs = [eng.submit(p, steps=steps, top_k=1, rng=np.random.default_rng(i))
          for i, p in enumerate(LPROMPTS)]
    eng.run_until_idle()
    return [h.result(timeout=0) for h in hs]


def test_the_engine_serves_the_lstm(lstms, monkeypatch):
    jnet, tnet, model = lstms
    want = _lstm_trace(JaxEngine(jnet, LV, slots=2))
    batches = []
    real = lstm_kernel.lstm_forward_plain

    def record(zx, *a, **kw):
        batches.append(tuple(zx.shape[:2]))
        return real(zx, *a, **kw)
    monkeypatch.setattr(lstm_kernel, "lstm_forward_plain", record)
    eng = GenerationEngine(tnet, LV, slots=2, device="cpu",
                           prime_padded=False)
    assert _lstm_trace(eng) == want
    # a decode step: one recurrence a layer, one position at batch S
    assert batches.count((1, 2)) == LLAYERS * eng.dispatches
    monkeypatch.setattr(lstm_kernel, "lstm_forward_plain", real)
    for i, p in enumerate(LPROMPTS):
        assert model.sample_stream(tnet, p, 5, top_k=1,
                                   rng=np.random.default_rng(i)) == want[i]
    # the rebuild re-primes h / c from ids[:-1]
    sup = EngineSupervisor()
    eng = GenerationEngine(tnet, LV, slots=2, device="cpu", supervisor=sup,
                           decode_chaos=chaos.FaultBurstInjector(n=2, k=1))
    assert _lstm_trace(eng) == want
    assert sup.rebuilds == 1


def test_the_lstm_refusals_that_stay(lstms):
    jnet, tnet, _ = lstms
    for make, paged, spec in (
            (lambda **kw: JaxEngine(jnet, LV, slots=2, **kw), JaxPaged,
             lambda: JaxSpec(jax_proposer(2))),
            (lambda **kw: GenerationEngine(tnet, LV, slots=2, device="cpu",
                                           **kw), PagedKVConfig,
             lambda: SpeculationConfig(prompt_lookup_proposer(2)))):
        for kv in ("bf16", "int8"):
            with pytest.raises(ValueError, match="attention KV"):
                make(paging=paged(page_size=PS, kv_dtype=kv))
        with pytest.raises(ValueError, match="cannot be rewound"):
            make(speculation=spec())
