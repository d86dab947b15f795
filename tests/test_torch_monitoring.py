"""The port's telemetry against the JAX package's (deeplearning4j_tpu_torch/
monitoring/, optimize/, resilience/retry.py), on the CPU.

- The same registry operations (counters, gauges with a callback,
  histograms, labels that need escaping, NaN and infinities) render the
  same Prometheus text, byte for byte, and the same snapshots; the
  registry's type, label and bucket checks raise as JAX's do.
- The event ring: capacity, the dropped counter, ``tail`` filters and the
  rendered series as JAX's.
- Spans: the histogram and the error counter as JAX's for the same
  nesting; ``current_path``; disabled spans record nothing.
- ``ensure_started`` declares the span, event, capture, prefetch,
  sentinel and autotune series; a capture counts under the JAX
  compile-counter names; the runtime gauges leave CUDA uninitialised.
- ``retry_call`` retries, gives up and counts as JAX's does with the same
  policy, rng and an injected sleep.
- The listeners: each of the zoo's over the same score stream as JAX's
  (what they collect and log), ``close_listeners`` surviving a failing
  close, ``EvaluativeListener`` constructed (ported: its behavior is in
  tests/test_torch_earlystopping.py); the profiler
  listener writes its trace; the flight recorder's artifact reads back;
  the crossover store counts its decisions in the registry.
"""

import json
import logging
import math
import random

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.monitoring import events as jevents
from deeplearning4j_tpu.monitoring import exporters as jexporters
from deeplearning4j_tpu.monitoring import metrics as jmetrics
from deeplearning4j_tpu.monitoring import tracing as jtracing
from deeplearning4j_tpu.optimize import listeners as jlisteners
from deeplearning4j_tpu.resilience import retry as jretry
from deeplearning4j_tpu_torch import monitoring
from deeplearning4j_tpu_torch.monitoring import events as tevents
from deeplearning4j_tpu_torch.monitoring import exporters as texporters
from deeplearning4j_tpu_torch.monitoring import flightrecorder
from deeplearning4j_tpu_torch.monitoring import metrics as tmetrics
from deeplearning4j_tpu_torch.monitoring import runtime
from deeplearning4j_tpu_torch.monitoring import tracing as ttracing
from deeplearning4j_tpu_torch.optimize import listeners as tlisteners
from deeplearning4j_tpu_torch.optimize.profiler import (
    ProfilerListener, TimingListener)
from deeplearning4j_tpu_torch.resilience import retry as tretry
from deeplearning4j_tpu_torch.tuning.crossover import KernelCrossoverStore


def _registry_ops(m):
    """One script of registry operations, run against either package's
    metrics module; returns the registry."""
    r = m.MetricsRegistry()
    c = r.counter("req_total", "Requests served", ("route", "code"))
    c.inc(route="/a", code=200)
    c.inc(2.5, route='/b"q\\x\ny', code=500)
    c.labels(route="/c", code=404)
    r.counter("plain_total", "no labels").inc(3)
    g = r.gauge("temp", "A gauge", ("dev",))
    g.set(1.25, dev="cuda:0")
    g.set(float("nan"), dev="cuda:1")
    g.set(float("inf"), dev="cuda:2")
    g.set(-float("inf"), dev="cuda:3")
    g.inc(0.5, dev="cuda:0")
    r.gauge("cb", "callback gauge").set_function(lambda: 7)
    r.gauge("broken", "raising callback").set_function(lambda: 1 / 0)
    h = r.histogram("lat_seconds", "Latency", ("op",))
    for v in (0.0001, 0.003, 0.2, 4.0, 100.0):
        h.observe(v, op="x")
    h.labels(op="y")
    r.histogram("custom", "own buckets", buckets=(1, 0.5, 2)).observe(0.7)
    return r


def test_the_same_operations_render_the_same_prometheus_text():
    j, t = _registry_ops(jmetrics), _registry_ops(tmetrics)
    got = texporters.render_prometheus(t, refresh_runtime=False)
    want = jexporters.render_prometheus(j, refresh_runtime=False)
    assert got == want
    assert 'route="/b\\"q\\\\x\\ny"' in got and "NaN" in got and "+Inf" in got
    # (NaN != NaN: compared as their JSON text)
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())
    assert json.dumps(t.snapshot_compact()) == \
        json.dumps(j.snapshot_compact())
    assert texporters.CONTENT_TYPE == jexporters.CONTENT_TYPE


@pytest.mark.parametrize("m", [jmetrics, tmetrics], ids=["jax", "port"])
def test_the_registry_refuses_what_jax_refuses(m):
    r = m.MetricsRegistry()
    r.counter("a_total", "", ("x",))
    with pytest.raises(ValueError, match="already registered as counter"):
        r.gauge("a_total")
    with pytest.raises(ValueError, match="already registered with labels"):
        r.counter("a_total", "", ("y",))
    with pytest.raises(ValueError, match="counters only go up"):
        r.counter("a_total", "", ("x",)).inc(-1, x=1)
    with pytest.raises(ValueError, match="labels"):
        r.counter("a_total", "", ("x",)).inc(z=1)
    r.histogram("h", buckets=(1, 2))
    with pytest.raises(ValueError, match="buckets"):
        r.histogram("h", buckets=(1, 3))
    g = r.gauge("g")
    g.set_function(lambda: 1)
    with pytest.raises(ValueError, match="read-only"):
        g.inc()


def _event_ops(ev, m):
    r = m.MetricsRegistry()
    log = ev.EventLog(capacity=3, registry=r)
    log.declare_series(r)
    for i in range(5):
        log.emit("fleet" if i % 2 else "serving", f"e{i}", i=i, odd=i % 2)
    return log, r


def test_the_event_ring_as_jax():
    (jl_, jr), (tl_, tr) = _event_ops(jevents, jmetrics), \
        _event_ops(tevents, tmetrics)
    assert [e.name for e in tl_.tail()] == [e.name for e in jl_.tail()] \
        == ["e2", "e3", "e4"]
    assert [e.name for e in tl_.tail(category="fleet")] == ["e3"]
    assert [e.name for e in tl_.tail(match={"odd": 0})] == ["e2", "e4"]
    assert tl_.tail(0) == [] and len(tl_.tail(2)) == 2
    assert (tl_.dropped_total, tl_.total_emitted, tl_.depth()) == \
        (jl_.dropped_total, jl_.total_emitted, jl_.depth()) == (2, 5, 3)
    assert texporters.render_prometheus(tr, refresh_runtime=False) == \
        jexporters.render_prometheus(jr, refresh_runtime=False)
    prev = tevents.set_events_enabled(False)
    try:
        assert tl_.emit("serving", "off") is None
    finally:
        tevents.set_events_enabled(prev)
    assert {k for k in tl_.tail()[0].as_dict()} == \
        {"seq", "mono", "wall", "category", "name", "attrs"}


def _span_ops(tr, m):
    r = m.MetricsRegistry()
    paths = []
    with tr.span("outer", r):
        with tr.span("inner", r):
            paths.append(tr.current_path())
        with tr.span("inner", r):
            pass
    with pytest.raises(KeyError):
        with tr.span("bad", r):
            raise KeyError("x")
    tr.record_span("etl", 0.2, r)
    tr.declare_default_spans(r)
    h = r.get(tr.SPAN_HISTOGRAM)
    counts = {s: h.count(span=s) for s in ("outer", "inner", "bad", "etl",
                                           "step")}
    errors = r.get(tr.SPAN_ERRORS).value(span="bad")
    return paths, counts, errors, r


def test_spans_record_as_jax_spans_do():
    jp, jc, je, jr = _span_ops(jtracing, jmetrics)
    tp, tc, te, tr = _span_ops(ttracing, tmetrics)
    assert tp == jp == ["outer/inner"]
    assert tc == jc == {"outer": 1, "inner": 2, "bad": 1, "etl": 1,
                        "step": 0}
    assert te == je == 1.0
    assert ttracing.DEFAULT_SPANS == jtracing.DEFAULT_SPANS
    assert tr.get(ttracing.SPAN_HISTOGRAM).buckets == \
        jr.get(jtracing.SPAN_HISTOGRAM).buckets
    ttracing.set_enabled(False)
    try:
        r = tmetrics.MetricsRegistry()
        with ttracing.span("quiet", r):
            pass
        assert r.get(ttracing.SPAN_HISTOGRAM) is None
    finally:
        ttracing.set_enabled(True)


def test_ensure_started_declares_the_ports_series():
    monitoring.ensure_started()
    text = texporters.render_prometheus(refresh_runtime=False)
    for name in ("dl4jtpu_span_seconds", "dl4jtpu_events_depth",
                 "dl4jtpu_events_dropped_total",
                 "dl4jtpu_jit_compiles_total", "dl4jtpu_jit_compile_seconds",
                 "dl4jtpu_prefetch_queue_depth",
                 "dl4jtpu_prefetch_h2d_bytes_total",
                 "dl4jtpu_prefetch_batches_total",
                 "dl4jtpu_bad_steps_total", "dl4jtpu_skipped_updates_total",
                 "dl4jtpu_consecutive_bad_steps",
                 "dl4jtpu_autotune_decisions_total",
                 "dl4jtpu_autotune_calibrations_total"):
        assert f"# TYPE {name} " in text, name
    for span in jtracing.DEFAULT_SPANS:
        assert f'dl4jtpu_span_seconds_count{{span="{span}"}}' in text


def test_a_capture_counts_under_the_compile_series():
    r = tmetrics.MetricsRegistry()
    runtime.record_capture("ComputationGraph.step_graph_k4", 1.5, r)
    runtime.record_capture("ComputationGraph.step_graph_k4", 0.5, r)
    c = r.get(runtime.COMPILE_COUNTER)
    assert c.labelnames == ("fn",) and c.kind == "counter"
    assert c.value(fn="ComputationGraph.step_graph_k4") == 2
    assert r.get(runtime.COMPILE_SECONDS).sum() == 2.0
    from deeplearning4j_tpu.monitoring import runtime as jruntime
    assert (runtime.COMPILE_COUNTER, runtime.COMPILE_SECONDS) == \
        (jruntime.COMPILE_COUNTER, jruntime.COMPILE_SECONDS)


def test_runtime_gauges_never_initialise_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda *a: calls.append(a) or {})
    r = tmetrics.MetricsRegistry()
    runtime.refresh(r)
    assert not calls and r.get("dl4jtpu_device_bytes_in_use") is None
    assert r.get("dl4jtpu_host_rss_mb").value() > 0
    snap = texporters.metrics_snapshot()
    assert isinstance(snap, dict) and "dl4jtpu_host_rss_mb" in snap


class _Flaky:
    """Fails with OSError ``fails`` times, then returns its call count."""

    def __init__(self, fails):
        self.fails, self.calls = fails, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise OSError(f"flaky {self.calls}")
        return self.calls


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_call_as_jax(fails):
    out = {}
    for name, mod, m in (("jax", jretry, jmetrics), ("port", tretry,
                                                     tmetrics)):
        r = m.MetricsRegistry()
        slept = []
        fn = _Flaky(fails)
        policy = mod.RetryPolicy(max_attempts=4, base_delay=0.01,
                                 jitter=0.5)
        try:
            res = mod.retry_call(fn, policy=policy, op="pull",
                                 sleep=slept.append,
                                 rng=random.Random(3), registry=r)
        except OSError as e:
            res = repr(e)
        out[name] = (res, fn.calls, slept,
                     texporters.render_prometheus(r, refresh_runtime=False)
                     if name == "port" else
                     jexporters.render_prometheus(r, refresh_runtime=False))
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError, match="max_attempts"):
        tretry.RetryPolicy(max_attempts=0)
    budget = tretry.RestartBudget(max_restarts=1, window_s=10,
                                  clock=lambda: 0.0)
    assert budget.try_acquire() and not budget.try_acquire()


def _listener_zoo(mod, lines):
    return [mod.ScoreIterationListener(2, printer=lines.append),
            mod.CollectScoresIterationListener(frequency=2),
            mod.ComposableIterationListener(
                mod.CollectScoresIterationListener()),
            mod.TimeIterationListener(total_iterations=6),
            mod.SleepyTrainingListener(),
            mod.PerformanceListener(frequency=2, report=lambda s: None)]


def test_the_listener_zoo_as_jax_over_one_score_stream():
    scores = [2.5, 2.25, 2.0, float("nan"), 1.5, 1.25]
    jlines, tlines = [], []
    jz = _listener_zoo(jlisteners, jlines)
    tz = _listener_zoo(tlisteners, tlines)
    for i, s in enumerate(scores):
        for l in jz:
            l.iteration_done(None, i, s)
        for l in tz:
            # the port hands listeners device scalars
            l.iteration_done(None, i, torch.tensor(s))
    assert tlines == jlines
    np.testing.assert_array_equal(tz[1].scores, jz[1].scores)
    np.testing.assert_array_equal(tz[2].listeners[0].scores,
                                  jz[2].listeners[0].scores)
    assert [type(l).__name__ for l in tz] == [type(l).__name__ for l in jz]


def test_param_listener_reads_the_trees_as_jax(tmp_path):
    params = [{"0": {"W": np.full((2, 2), v, np.float32)}}
              for v in (1.0, 1.5, 0.5)]

    class Net:
        pass
    outs = {}
    for name, mod, conv in (("jax", jlisteners, np.asarray),
                            ("port", tlisteners, torch.tensor)):
        path = tmp_path / f"{name}.tsv"
        lst = mod.ParamAndGradientIterationListener(output_file=str(path),
                                                    log_stats=False)
        net = Net()
        for i, p in enumerate(params):
            net.params = {k: {n: conv(a) for n, a in v.items()}
                          for k, v in p.items()}
            lst.iteration_done(net, i, 0.5 + i)
        outs[name] = path.read_text()
    assert outs["port"] == outs["jax"]


def test_close_listeners_and_the_refused_listener(caplog):
    class Bad(tlisteners.TrainingListener):
        def close(self):
            raise RuntimeError("boom")
    closed = []

    class Good(tlisteners.TrainingListener):
        def close(self):
            closed.append(True)
    with caplog.at_level(logging.WARNING):
        tlisteners.close_listeners([Bad(), Good()])
    assert closed == [True] and "close() failed" in caplog.text
    # EvaluativeListener is ported (tests/test_torch_earlystopping.py)
    lst = tlisteners.EvaluativeListener(iter(()), frequency=3)
    assert lst.evaluations == [] and lst.frequency == 3


def test_the_profiler_listener_writes_its_trace(tmp_path):
    lst = ProfilerListener(str(tmp_path / "prof"), start_iteration=1,
                           num_iterations=2)
    timing = TimingListener()
    for i in range(5):
        torch.ones(8, 8) @ torch.ones(8, 8)
        lst.iteration_done(None, i, 0.0)
        timing.iteration_done(None, i, 0.0)
    lst.close()
    lst.close()                      # idempotent
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "traceEvents" in trace
    assert timing.summary()["iterations"] == 4


def test_the_flight_recorder_dumps_and_reads_back(tmp_path):
    flightrecorder.reset_for_tests()
    flightrecorder.set_flight_dir(str(tmp_path))
    try:
        tevents.emit("resilience", "divergence", step=3)
        path = flightrecorder.maybe_dump(
            "divergence", error=ValueError("nan"), health={"ok": False},
            extra={"x": object()})
        assert path and path.startswith(str(tmp_path))
        rec = flightrecorder.read_record(path)
        assert rec["header"]["trigger"] == "divergence"
        assert rec["header"]["error"] == "ValueError('nan')"
        assert any(e["name"] == "divergence" for e in rec["events"])
        # rate-limited per trigger
        assert flightrecorder.maybe_dump("divergence") is None
    finally:
        flightrecorder.set_flight_dir(None)
        flightrecorder.reset_for_tests()


def test_the_crossover_store_counts_in_the_registry(tmp_path):
    c = tmetrics.global_registry().counter(
        "dl4jtpu_autotune_decisions_total", "kernel-crossover autotune events",
        ("domain", "choice"))
    before = c.value(domain="train_stem", choice="default")
    s = KernelCrossoverStore(path=str(tmp_path / "store.json"))
    s.choose("train_stem|cin=3,cout=64,h=32,w=32|f32", device="cpu")
    assert c.value(domain="train_stem", choice="default") == before + 1
    assert s.decisions[("train_stem", "default")] == 1
    assert math.isfinite(before)
