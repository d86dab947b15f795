"""Process-wide metrics registry: Counter / Gauge / Histogram primitives.

Counterpart of ``deeplearning4j_tpu/monitoring/metrics.py``, kept as the
port's own copy: the same series names, labels, bucket edges and
snapshot shapes, so a scrape of either package reads the same schema. A
thread-safe registry of labeled metrics that the fit loops, the prefetch
stage, the sentinel and the crossover store publish into, and that
``exporters.py`` renders as Prometheus text exposition or JSONL.

Pure Python: it imports neither torch nor numpy, so a failure path that
never reached the card can still snapshot it. Device gauges live in
``runtime.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# seconds-oriented (spans, compile times); Prometheus-client's defaults
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


class Metric:
    """Base labeled metric. One instance per metric NAME; per-label-value
    children are created lazily on first touch (prometheus-client model).
    All mutation happens under the owning registry's lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def _child(self, labels: Dict[str, Any]):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._new_child()
        return child

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **labels) -> "_Handle":
        """Get (creating if needed) the child for a label combination —
        creating it declares the series so it renders even with no data."""
        with self._lock:
            self._child(labels)
        return _Handle(self, labels)

    def label_values(self) -> List[Tuple[str, ...]]:
        with self._lock:
            return sorted(self._children)


class _Handle:
    """Bound (metric, labels) pair returned by .labels(**kw)."""

    __slots__ = ("_metric", "_labels")

    def __init__(self, metric: Metric, labels: Dict[str, Any]):
        self._metric = metric
        self._labels = labels

    def __getattr__(self, item):
        fn = getattr(self._metric, item)

        def bound(*args, **kw):
            return fn(*args, **self._labels, **kw)
        return bound


class Counter(Metric):
    """Monotonically increasing counter."""

    kind = "counter"

    def _new_child(self) -> List[float]:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        with self._lock:
            self._child(labels)[0] += amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._child(labels)[0]

    def total(self) -> float:
        """Sum over every label combination."""
        with self._lock:
            return sum(c[0] for c in self._children.values())


class Gauge(Metric):
    """Point-in-time value; also supports scrape-time callbacks."""

    kind = "gauge"

    def _new_child(self) -> List[Any]:
        return [0.0]

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            child = self._child(labels)
            if callable(child[0]):
                raise ValueError(f"{self.name}: callback gauge is read-only")
            child[0] += amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        """Evaluate `fn` at collection time (e.g. RSS, queue depth)."""
        with self._lock:
            self._child(labels)[0] = fn

    def value(self, **labels) -> float:
        with self._lock:
            v = self._child(labels)[0]
        return float(v()) if callable(v) else float(v)


class Histogram(Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets: Tuple[float, ...] = tuple(bs)

    def _new_child(self):
        # [per-bucket counts..., +Inf count], sum, count
        return {"counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "n": 0}

    def observe(self, value: float, **labels) -> None:
        self.observe_many((value,), **labels)

    def observe_many(self, values, **labels) -> None:
        """``observe`` each of ``values`` under one lock acquisition (a
        hot loop's batch: one enter a step, not one a token)."""
        if not values:
            return
        with self._lock:
            child = self._child(labels)
            counts, nb = child["counts"], len(self.buckets)
            for value in values:
                value = float(value)
                i = nb
                for j, b in enumerate(self.buckets):
                    if value <= b:
                        i = j
                        break
                counts[i] += 1
                child["sum"] += value
                child["n"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._child(labels)["n"]

    def sum(self, **labels) -> float:
        with self._lock:
            return self._child(labels)["sum"]


class MetricsRegistry:
    """Thread-safe get-or-create registry of named metrics.

    `counter`/`gauge`/`histogram` are idempotent accessors: the first call
    creates the metric, later calls return it (and type/label mismatches
    raise instead of silently aliasing two meanings onto one name)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labelnames,
                                              self._lock, **kw)
                return m
            if not isinstance(m, cls):
                raise ValueError(f"{name} already registered as {m.kind}")
            if m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"{name} already registered with labels {m.labelnames}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        h = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        if h.buckets != tuple(sorted(float(b) for b in buckets)):
            raise ValueError(
                f"{name} already registered with buckets {h.buckets}")
        return h

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def collect(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------------------
    # snapshots
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Full structured dump: {name: {type, help, samples: [...]}}."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                samples = []
                for key in sorted(m._children):
                    labels = dict(zip(m.labelnames, key))
                    child = m._children[key]
                    if m.kind == "histogram":
                        samples.append({"labels": labels,
                                        "count": child["n"],
                                        "sum": child["sum"]})
                    else:
                        v = child[0]
                        if callable(v):
                            try:
                                v = float(v())
                            except Exception:  # noqa: BLE001 — scrape-safe
                                continue
                        samples.append({"labels": labels, "value": v})
                out[name] = {"type": m.kind, "help": m.help,
                             "samples": samples}
        return out

    def snapshot_compact(self) -> Dict[str, Any]:
        """Flat one-JSON-object summary for bench records: counters/gauges
        as `name{k=v}` -> value, histograms -> {count, sum, mean}."""
        out: Dict[str, Any] = {}
        for name, m in self.snapshot().items():
            for s in m["samples"]:
                key = compact_key(name, s["labels"])
                if m["type"] == "histogram":
                    n = s["count"]
                    if n:  # empty series add noise, not information, here
                        out[key] = {"count": n, "sum": round(s["sum"], 6),
                                    "mean": round(s["sum"] / n, 6)}
                else:
                    out[key] = s["value"]
        return out


def compact_key(name: str, labels: Dict[str, Any]) -> str:
    """`name{k=v,...}` key used by the compact snapshot formats."""
    if not labels:
        return name
    return name + "{" + ",".join(
        f"{k}={labels[k]}" for k in sorted(labels)) + "}"


_global = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    """The default process-wide registry (exported at /metrics)."""
    return _global
