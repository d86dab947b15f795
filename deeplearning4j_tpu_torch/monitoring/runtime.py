"""Device/runtime gauges and the step-capture counter.

Counterpart of ``deeplearning4j_tpu/monitoring/runtime.py``, under its
series names. Three signal families, all landing in the shared
registry:

- per-device memory from ``torch.cuda.memory_stats`` (the caching
  allocator's bytes in use and their high-water mark) and
  ``torch.cuda.mem_get_info`` (the card's capacity), as
  ``dl4jtpu_device_bytes_in_use`` / ``_peak_bytes_in_use`` /
  ``_bytes_limit{device="cuda:N"}``;
- host RSS (``dl4jtpu_host_rss_mb``) from the port's own
  :func:`_current_rss_mb`;
- the captures of a training step as a CUDA graph, counted PER STEP
  NAME under ``dl4jtpu_jit_compiles_total{fn=...}`` with their seconds
  in ``dl4jtpu_jit_compile_seconds``. A capture is the port's compile of
  a step (the JAX package counts ``jax.jit`` cache misses under the same
  names), so a scrape of either package shows one schema, and a step
  that recaptures on every dispatch (shape churn, a stale key) shows up
  as a climbing counter instead of a silent slowdown.

Nothing here initialises CUDA: the device gauges are read only when
this process has already initialised it (a scrape must never be the
thing that first touches the card), the same guard as the JAX module's
"no backend initialization ever".
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

COMPILE_COUNTER = "dl4jtpu_jit_compiles_total"
COMPILE_SECONDS = "dl4jtpu_jit_compile_seconds"

__all__ = ["COMPILE_COUNTER", "COMPILE_SECONDS", "install_recompile_watcher",
           "record_capture", "refresh", "update_device_gauges",
           "update_host_gauges"]


def _current_rss_mb() -> Optional[float]:
    """Current (not peak) resident set size from /proc/self/status VmRSS."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0  # kB -> MB
    except OSError:
        pass
    return None


def _cuda_initialized() -> bool:
    """True only if this process has ALREADY initialised CUDA — never
    triggers the initialisation."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.cuda.is_initialized())
    except Exception:  # noqa: BLE001 — a broken driver: skip the gauges
        return False


def update_host_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    rss = _current_rss_mb()
    if rss is not None:
        r = registry or global_registry()
        r.gauge("dl4jtpu_host_rss_mb",
                "Host resident set size (MB)").set(rss)


def update_device_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    if not _cuda_initialized():
        return
    import torch
    r = registry or global_registry()
    in_use = r.gauge("dl4jtpu_device_bytes_in_use",
                     "Device memory currently allocated", ("device",))
    peak = r.gauge("dl4jtpu_device_peak_bytes_in_use",
                   "Device memory high-water mark", ("device",))
    limit = r.gauge("dl4jtpu_device_bytes_limit",
                    "Device memory capacity", ("device",))
    for i in range(torch.cuda.device_count()):
        try:
            ms = torch.cuda.memory_stats(i)
        except Exception:  # noqa: BLE001 — the driver died under us
            continue
        # a device this process never allocated on has no context, and
        # mem_get_info would make one: skip it
        if not ms or not ms.get("allocated_bytes.all.peak"):
            continue
        name = f"cuda:{i}"
        in_use.set(float(ms.get("allocated_bytes.all.current", 0)),
                   device=name)
        peak.set(float(ms["allocated_bytes.all.peak"]), device=name)
        try:
            limit.set(float(torch.cuda.mem_get_info(i)[1]), device=name)
        except Exception:  # noqa: BLE001 — capacity is best-effort
            pass


def refresh(registry: Optional[MetricsRegistry] = None) -> None:
    """Bring point-in-time gauges current (called on every scrape)."""
    update_host_gauges(registry)
    update_device_gauges(registry)


def _capture_series(registry: Optional[MetricsRegistry] = None):
    r = registry or global_registry()
    return (r.counter(
        COMPILE_COUNTER,
        "Training-step CUDA-graph captures (the port's compiles) per "
        "step name", ("fn",)),
        r.histogram(COMPILE_SECONDS,
                    "Seconds of training-step CUDA-graph captures"))


def record_capture(fn: str, seconds: float,
                   registry: Optional[MetricsRegistry] = None) -> None:
    """Count one CUDA-graph capture of the step named ``fn`` and its
    wall seconds (the capture and its instantiation)."""
    counter, hist = _capture_series(registry)
    counter.inc(fn=fn)
    hist.observe(seconds)


_installed = False
_lock = threading.Lock()


def install_recompile_watcher(
        registry: Optional[MetricsRegistry] = None) -> None:
    """Declare the capture series (idempotent; the first call wins), so
    a scrape before the first capture already shows them. The name is
    the JAX package's, whose watcher taps jax's compile log: here the
    fit loop calls :func:`record_capture` itself."""
    global _installed
    with _lock:
        if not _installed:
            _capture_series(registry)
            _installed = True
