"""Registry exporters: Prometheus text exposition and a JSONL file sink.

Counterpart of ``deeplearning4j_tpu/monitoring/exporters.py``, kept as
the port's own copy: for the same registry operations the text
exposition is the JAX package's byte for byte.

`render_prometheus()` produces text-exposition-format 0.0.4 (the format
every Prometheus/VictoriaMetrics/Grafana-agent scraper speaks); the
UIServer serves it at GET /metrics. `JsonlSink` appends one JSON object
per call — the same shape bench.py embeds in its one-line records, so a
long run can stream periodic snapshots next to its result line.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    Histogram, MetricsRegistry, compact_key, global_registry)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def render_prometheus(registry: Optional[MetricsRegistry] = None,
                      refresh_runtime: bool = True) -> str:
    """Render the registry in Prometheus text exposition format."""
    r = registry or global_registry()
    if refresh_runtime:
        # bring RSS/device gauges current at scrape time — bounded, so a
        # scrape never blocks on a wedged driver; a late-finishing
        # refresh just lands in the next scrape (never initialises CUDA —
        # runtime._cuda_initialized)
        refresh_runtime_bounded(registry=r)
    lines = []
    for m in r.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        with m._lock:
            # copy child state under the lock: a concurrent observe()
            # must not tear bucket counts vs _sum/_count mid-render
            children = [
                (dict(zip(m.labelnames, key)),
                 dict(m._children[key], counts=list(m._children[key]["counts"]))
                 if isinstance(m, Histogram) else list(m._children[key]))
                for key in sorted(m._children)]
        if isinstance(m, Histogram):
            for labels, child in children:
                cum = 0
                for i, b in enumerate(m.buckets):
                    cum += child["counts"][i]
                    le = 'le="%s"' % _fmt_value(b)
                    lines.append(f"{m.name}_bucket"
                                 f"{_fmt_labels(labels, le)} {cum}")
                cum += child["counts"][-1]
                le = 'le="+Inf"'
                lines.append(f"{m.name}_bucket"
                             f"{_fmt_labels(labels, le)} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(child['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)}"
                             f" {child['n']}")
        else:
            for labels, child in children:
                v = child[0]
                if callable(v):
                    try:
                        v = float(v())
                    except Exception:  # noqa: BLE001 — scrape must not 500
                        continue
                lines.append(f"{m.name}{_fmt_labels(labels)}"
                             f" {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


class JsonlSink:
    """Append registry snapshots to a JSONL file, one object per line."""

    def __init__(self, path: str,
                 registry: Optional[MetricsRegistry] = None,
                 compact: bool = True):
        self.path = path
        self.registry = registry or global_registry()
        self.compact = compact

    def write_snapshot(self, extra: Optional[Dict[str, Any]] = None) -> None:
        snap = (self.registry.snapshot_compact() if self.compact
                else self.registry.snapshot())
        rec = {"timestamp": time.time(), "metrics": snap}
        if extra:
            rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def refresh_runtime_bounded(timeout: float = 5.0,
                            registry: Optional[MetricsRegistry] = None
                            ) -> None:
    """Refresh runtime gauges on a daemon thread, waiting at most
    ``timeout``: a driver call that hangs instead of raising must cost
    a caller on a result-line path at most the timeout, never the
    record.
    The registry is thread-safe, so a late-finishing refresh just
    updates gauges after the caller's snapshot was taken."""
    try:
        from deeplearning4j_tpu_torch.monitoring import runtime

        def _refresh():
            try:
                runtime.refresh(registry)
            except Exception:  # noqa: BLE001 — gauges are best-effort
                pass

        t = threading.Thread(target=_refresh, daemon=True,
                             name="metrics-runtime-refresh")
        t.start()
        t.join(timeout)
    except Exception:  # noqa: BLE001 — gauges are best-effort
        pass


def metrics_snapshot(refresh_timeout: float = 5.0) -> Dict[str, Any]:
    """Compact global-registry snapshot for embedding in bench records.
    Refreshes runtime gauges first (bounded, guarded: no backend init)
    and never raises — the snapshot must survive the paths where no
    card came up."""
    try:
        refresh_runtime_bounded(refresh_timeout)
        return global_registry().snapshot_compact()
    except Exception:  # noqa: BLE001 — a bench record beats a traceback
        return {}


def snapshot_delta_compact(prev: Optional[Dict[str, Any]],
                           cur: Dict[str, Any]) -> Dict[str, Any]:
    """Compact rendering of ``cur`` minus ``prev`` (both full
    ``MetricsRegistry.snapshot()`` dicts): counters and histograms become
    the increment since ``prev`` (zero-increment series are dropped as
    noise), gauges keep their point-in-time value. bench_all stamps one
    of these per record so the Nth bench's "metrics" field carries only
    that bench's own spans and compile counts, not the cumulative totals
    of every bench the process ran before it."""
    prev_samples: Dict[str, Dict[str, Any]] = {}
    for name, m in (prev or {}).items():
        for s in m["samples"]:
            prev_samples[compact_key(name, s["labels"])] = s

    out: Dict[str, Any] = {}
    for name, m in cur.items():
        for s in m["samples"]:
            key = compact_key(name, s["labels"])
            p = prev_samples.get(key)
            if m["type"] == "histogram":
                n = s["count"] - (p["count"] if p else 0)
                if n > 0:
                    total = s["sum"] - (p["sum"] if p else 0.0)
                    out[key] = {"count": n, "sum": round(total, 6),
                                "mean": round(total / n, 6)}
            elif m["type"] == "counter":
                d = s["value"] - (p["value"] if p else 0.0)
                if d:
                    out[key] = d
            else:
                out[key] = s["value"]
    return out
