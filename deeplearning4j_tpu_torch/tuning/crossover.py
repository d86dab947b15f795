"""Per-shape kernel-crossover store: measured kernel-vs-fallback timings,
persisted in a JSON file.

Counterpart of ``deeplearning4j_tpu/tuning/crossover.py``. Which side
wins, a hand-written kernel or its equal-semantics fallback (the
unfused PyTorch graph), is a property of the shape and the hardware, so
the store keeps measurements:

- an **entry** is one paired measurement, ``kernel_ms`` against
  ``fallback_ms`` for a fingerprinted (domain, shape, dtype) point,
  stamped with the platform and device kind it was measured on and the
  implementation revision of the kernel it timed;
- ``choose(key, device=)`` is the resolution read: "auto" asks it which
  side to run on ``device``. A missing, mismatched (another platform or
  device kind) or stale-revision entry yields the caller's default, so
  calibration only refines an uncalibrated run, never changes it;
- ``record``/``calibrate`` merge measurements in (a running mean over
  samples) and ``save`` persists atomically.

The keys are the JAX package's strings (:func:`fingerprint` and the four
domain helpers). The platform and device kind come from the device the
caller names, ``("cuda", torch.cuda.get_device_name(device))`` or
``("cpu", "cpu")``, never from a process-wide probe. The store's file is
the port's own, ``KERNEL_CROSSOVER_TORCH.json`` in the working directory
or else at the repository root (git-ignored; the JAX package's
``KERNEL_CROSSOVER.json`` is never read or written here).

The serving int8 verdict is persisted on request only
(``chip_smoke.py --calibrate``, as the JAX package's ``BENCH_CALIBRATE``
run): :func:`record_quant_verdict` records an engine's measured int8
and bf16 ms a token under its ``_quant_key`` into the default store and
saves it, so a fresh process's ``kv_dtype="auto"`` reads it.

Telemetry, the JAX package's series: ``dl4jtpu_autotune_decisions_total
{domain,choice}`` counts every ``choose`` (choice kernel, fallback or
default) and ``dl4jtpu_autotune_calibrations_total{domain,choice}``
every recorded measurement (choice the measured winner) in the global
metrics registry; the store also keeps its own counts
(``decisions``, ``calibrations``: ``{(domain, choice): count}``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.device import resolve_device

__all__ = ["CROSSOVER_NAME", "IMPL_REVS", "KernelCrossoverStore",
           "bottleneck_fingerprint", "decode_fingerprint", "default_path", "default_store",
           "device_platform", "fingerprint", "quant_fingerprint",
           "record_quant_verdict", "reset_default_store", "stem_fingerprint",
           "winner"]

log = logging.getLogger(__name__)

CROSSOVER_NAME = "KERNEL_CROSSOVER_TORCH.json"
CROSSOVER_VERSION = 1

#: implementation revision per kernel domain: entries recorded against
#: another revision are pruned on load (a rewritten kernel, or a
#: measurement of another fallback, re-earns its calibration). The two
#: training domains are at 2 or more: their fallback is timed as the xla
#: plan's own layers since, where revision 1 timed
#: ``reference_bottleneck`` / ``reference_stem`` (``tuning/calibrate.py``);
#: train_bottleneck is at 3 since its bf16 backward kernels run on the
#: tensor cores (revision 2 timed them on the f32 CUDA cores), and at 4
#: since its bf16 forward kernels do (revision 3 timed them on the CUDA
#: cores); train_stem is at 3 since its bf16 weight gradient runs in one
#: pass on the tensor cores (revision 2 timed a dy pass and a CUDA-core
#: GEMM), at 4 since its bf16 input gradient does (revision 3 timed it
#: on the f32 CUDA cores), at 5 since its pool backward reads y once
#: in tiles (revision 4 timed a pass that read it about 20 times), and at
#: 6 since its bf16 conv runs on the tensor cores (revision 5 timed it on
#: the f32 CUDA cores); paged_decode_quant is at 2 since both of its legs
#: were rewritten: the int8 kernel as a split over warps, and the bf16
#: kernel its fallback leg times, the same split (revision 1 timed one
#: warp's dependent page rounds in each)
IMPL_REVS: Dict[str, int] = {
    "train_bottleneck": 4,    # nn/layers/bottleneck.py fused chain
    "train_stem": 6,          # nn/layers/stem.py space-to-depth stem
    "paged_decode": 1,        # serving/paged_kernel.py
    "paged_decode_quant": 2,  # the int8 KV pool (serving/quant.py)
}


AUTOTUNE_DECISIONS = "dl4jtpu_autotune_decisions_total"
AUTOTUNE_CALIBRATIONS = "dl4jtpu_autotune_calibrations_total"


def _autotune_counter(metric: str):
    from deeplearning4j_tpu_torch.monitoring.metrics import global_registry
    return global_registry().counter(
        metric, "kernel-crossover autotune events", ("domain", "choice"))


def declare_autotune_series() -> None:
    """Declare both autotune series (``monitoring.ensure_started``)."""
    for metric in (AUTOTUNE_DECISIONS, AUTOTUNE_CALIBRATIONS):
        _autotune_counter(metric)


def _count(counts: Counter, metric: str, domain: str, choice: str) -> None:
    """Count an event on the store and in the registry."""
    counts[(domain, choice)] += 1
    _autotune_counter(metric).inc(domain=domain, choice=choice)


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_path() -> str:
    """The working directory's store if it has one, else the repository
    root's (where a new one is written)."""
    for cand in (os.path.join(os.getcwd(), CROSSOVER_NAME),
                 os.path.join(_repo_root(), CROSSOVER_NAME)):
        if os.path.exists(cand):
            return cand
    return os.path.join(_repo_root(), CROSSOVER_NAME)


def fingerprint(domain: str, dtype: Any = None, **dims: Any) -> str:
    """Stable entry key ``domain|k=v,...|dtype``: dims sorted by name,
    the dtype spelled short; the batch is not part of the key (the JAX
    package's strings)."""
    dt = "any" if dtype is None else str(dtype)
    dt = {"bfloat16": "bf16", "float32": "f32", "float64": "f64"}.get(dt, dt)
    body = ",".join(f"{k}={dims[k]}" for k in sorted(dims))
    return f"{domain}|{body}|{dt}"


def bottleneck_fingerprint(h: int, w: int, c_in: int, c_mid: int,
                           c_out: int, stride: int, has_skip: bool,
                           dtype: Any) -> str:
    return fingerprint("train_bottleneck", dtype, h=int(h), w=int(w),
                       cin=int(c_in), cmid=int(c_mid), cout=int(c_out),
                       stride=int(stride), skip=int(bool(has_skip)))


def stem_fingerprint(h: int, w: int, c_in: int, c_out: int,
                     dtype: Any) -> str:
    return fingerprint("train_stem", dtype, h=int(h), w=int(w),
                       cin=int(c_in), cout=int(c_out))


def decode_fingerprint(page_size: int, head_dim: int, n_kv_heads: int,
                       cache_length: int, dtype: Any) -> str:
    return fingerprint("paged_decode", dtype, ps=int(page_size),
                       d=int(head_dim), hkv=int(n_kv_heads),
                       L=int(cache_length))


def quant_fingerprint(page_size: int, head_dim: int, n_kv_heads: int,
                      cache_length: int, dtype: Any) -> str:
    """The int8-against-bf16 KV-pool key: kernel_ms is the int8 leg's
    time, fallback_ms the bf16 leg's."""
    return fingerprint("paged_decode_quant", dtype, ps=int(page_size),
                       d=int(head_dim), hkv=int(n_kv_heads),
                       L=int(cache_length))


def winner(entry: dict) -> str:
    """The verdict: 'kernel' iff the measured kernel time beats the
    fallback's."""
    return ("kernel" if entry.get("kernel_ms", float("inf"))
            < entry.get("fallback_ms", 0.0) else "fallback")


def device_platform(device=None) -> Tuple[str, str]:
    """(platform, device kind) of ``device`` (default ``"cuda"``):
    ``("cuda", the card's name)`` or ``("cpu", "cpu")``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


class KernelCrossoverStore:
    """Load, consult, record and save measured kernel-vs-fallback
    timings. Thread-safe."""

    def __init__(self, path: Optional[str] = None,
                 entries: Optional[Dict[str, dict]] = None):
        self.path = path or default_path()
        self._entries: Dict[str, dict] = dict(entries or {})
        self._lock = threading.Lock()
        self._warned: set = set()
        #: {(domain, choice): count} of ``choose`` (choice kernel,
        #: fallback or default) and of recorded measurements (the winner)
        self.decisions: Counter = Counter()
        self.calibrations: Counter = Counter()

    # -- persistence ---------------------------------------------------
    @classmethod
    def load(cls, path: Optional[str] = None) -> "KernelCrossoverStore":
        """The store at ``path`` (default :func:`default_path`); a
        missing or unreadable file reads as uncalibrated, and entries of
        a stale revision are pruned."""
        path = path or default_path()
        entries: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    entries = dict(json.load(f).get("entries", {}))
            except (OSError, ValueError, AttributeError) as e:
                log.warning("kernel-crossover store %s unreadable (%s): "
                            "running uncalibrated", path, e)
                entries = {}
        store = cls(path=path, entries=entries)
        stale = store.prune_stale()
        if stale:
            log.info("kernel-crossover store: pruned %d stale entries: %s",
                     len(stale), ", ".join(sorted(stale)[:5]))
        return store

    def save(self, path: Optional[str] = None) -> str:
        """Write the store atomically (a temporary file, then a rename)."""
        path = path or self.path
        with self._lock:
            payload = {"version": CROSSOVER_VERSION,
                       "tool": "kernel-crossover",
                       "entries": dict(sorted(self._entries.items()))}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    # -- accounting ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._entries.items()}

    def prune_stale(self) -> list:
        """Drop the entries whose ``impl_rev`` is not their domain's
        current revision; returns their keys."""
        dropped = []
        with self._lock:
            for key in list(self._entries):
                domain = key.split("|", 1)[0]
                rev = self._entries[key].get("impl_rev")
                if rev != IMPL_REVS.get(domain, rev):
                    dropped.append(key)
                    del self._entries[key]
        return dropped

    # -- consult -------------------------------------------------------
    def lookup(self, key: str, device=None) -> Optional[dict]:
        """The entry for ``key`` iff it was measured on ``device``'s
        platform and device kind; a mismatched entry is ignored with a
        warning (once per key)."""
        with self._lock:
            e = self._entries.get(key)
        if e is None:
            return None
        plat, kind = device_platform(device)
        if e.get("platform") != plat or \
                e.get("device_kind") not in (kind, "any"):
            if key not in self._warned:
                self._warned.add(key)
                log.warning(
                    "kernel-crossover entry %s was calibrated on %s/%s "
                    "but this run is %s/%s: ignoring it (recalibrate on "
                    "this hardware)", key, e.get("platform"),
                    e.get("device_kind"), plat, kind)
            return None
        return dict(e)

    def choose(self, key: str, default: Optional[str] = None, *,
               device=None) -> Optional[str]:
        """'kernel' or 'fallback' from a usable entry on ``device``, else
        ``default``; counts the decision."""
        domain = key.split("|", 1)[0]
        e = self.lookup(key, device)
        if e is None or not e.get("kernel_ms") or not e.get("fallback_ms"):
            _count(self.decisions, AUTOTUNE_DECISIONS, domain, "default")
            return default
        choice = winner(e)
        _count(self.decisions, AUTOTUNE_DECISIONS, domain, choice)
        return choice

    # -- record --------------------------------------------------------
    def record(self, key: str, kernel_ms: float, fallback_ms: float, *,
               device=None, platform: Optional[str] = None,
               device_kind: Optional[str] = None,
               source: str = "record") -> dict:
        """Merge one paired measurement taken on ``device`` (or the given
        platform and device kind): a running mean over the samples of an
        entry of the same platform, kind and revision, else a fresh
        entry. Returns the merged entry."""
        kernel_ms, fallback_ms = float(kernel_ms), float(fallback_ms)
        if not (kernel_ms > 0 and fallback_ms > 0):
            raise ValueError(
                f"timings must be positive, got kernel={kernel_ms} "
                f"fallback={fallback_ms} for {key}")
        domain = key.split("|", 1)[0]
        if platform is None or device_kind is None:
            plat, kind = device_platform(device)
            platform, device_kind = platform or plat, device_kind or kind
        with self._lock:
            e = self._entries.get(key)
            if (e is None or e.get("platform") != platform
                    or e.get("device_kind") != device_kind
                    or e.get("impl_rev") != IMPL_REVS.get(domain)):
                e = {"kernel_ms": kernel_ms, "fallback_ms": fallback_ms,
                     "platform": platform, "device_kind": device_kind,
                     "impl_rev": IMPL_REVS.get(domain), "samples": 1,
                     "source": source}
            else:
                n = int(e.get("samples", 1))
                e = dict(e)
                e["kernel_ms"] = round(
                    (e["kernel_ms"] * n + kernel_ms) / (n + 1), 6)
                e["fallback_ms"] = round(
                    (e["fallback_ms"] * n + fallback_ms) / (n + 1), 6)
                e["samples"] = n + 1
                e["source"] = source
            self._entries[key] = e
        _count(self.calibrations, AUTOTUNE_CALIBRATIONS, domain, winner(e))
        return dict(e)

    # -- measurement harness ------------------------------------------
    def calibrate(self, key: str, kernel_fn: Callable[[], Any],
                  fallback_fn: Callable[[], Any], *, device=None,
                  warmup: int = 2, iters: int = 5,
                  persist: bool = False) -> dict:
        """Time the two thunks back to back on ``device`` and record the
        result; ``persist=True`` saves the store after recording."""
        k_ms = _time_thunk(kernel_fn, warmup, iters, device)
        f_ms = _time_thunk(fallback_fn, warmup, iters, device)
        entry = self.record(key, k_ms, f_ms, device=device,
                            source="calibrate")
        if persist:
            self.save()
        return entry


def _time_thunk(fn: Callable[[], Any], warmup: int, iters: int,
                device=None) -> float:
    """Mean ms per call of ``fn`` after ``warmup`` calls, the device
    synchronized before the clock starts and before it stops (tests
    monkeypatch this to decouple the harness from wall time)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(max(0, warmup)):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(max(1, iters)):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1000.0 / max(1, iters)


_default_store: Optional[KernelCrossoverStore] = None
_default_lock = threading.Lock()


def default_store() -> KernelCrossoverStore:
    """The process's store, loaded from :func:`default_path` on first
    use."""
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = KernelCrossoverStore.load()
        return _default_store


def reset_default_store(store: Optional[KernelCrossoverStore] = None
                        ) -> None:
    """Swap (or clear) the process's store: tests and calibration runs
    point resolution at a store of their own."""
    global _default_store
    with _default_lock:
        _default_store = store


def record_quant_verdict(quant_key: str, int8_tokens_per_s: float,
                         bf16_tokens_per_s: float, *, device,
                         store: Optional[KernelCrossoverStore] = None
                         ) -> dict:
    """Record a serving run's int8 verdict, ``kernel_ms`` the int8 pool's
    ms a token and ``fallback_ms`` the bf16 pool's, stamped with
    ``device``, into ``store`` (default: :func:`default_store`, at
    :func:`default_path`) and save it. Returns the merged entry."""
    store = store if store is not None else default_store()
    entry = store.record(quant_key, 1e3 / float(int8_tokens_per_s),
                         1e3 / float(bf16_tokens_per_s), device=device,
                         source="calibrate")
    store.save()
    return entry
