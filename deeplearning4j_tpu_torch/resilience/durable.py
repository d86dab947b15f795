"""Durable state: crash-consistent writes, checkpoint directories, an
asynchronous writer, preemption at dispatch boundaries and a file commit
protocol for multi-process checkpoints.

Counterpart of ``deeplearning4j_tpu/resilience/durable.py``, kept as the
port's own copy (the port imports nothing of the JAX package). The
checkpoint stack (``util/checkpoint.py``, ``util/recovery.py``) is built
on it, and the model serializer and the flight recorder write through
its atomic file primitives. Its guarantees are the JAX module's:

1. **Atomicity**: a file or a checkpoint directory is written under a
   temporary name, fsynced and renamed into place (then the parent
   fsynced), so a kill at any point leaves the old state or the new
   one, never a mix. A step directory only ever exists whole.
2. **Integrity**: each directory holds ``data.npz`` (the state tree's
   leaves under the JAX package's keys) and ``MANIFEST.json`` with the
   format version and a crc32 a leaf (over dtype, shape and bytes), so a
   reader proves the bytes before it loads them and falls back to an
   older intact step instead of loading a torn one. The format is the
   JAX package's: each package reads the other's directories.
3. **Asynchrony**: :class:`AsyncCheckpointWriter` serializes and writes
   on one background thread in submission order, with backpressure; the
   fit loop waits only for the snapshot (:func:`snapshot_tree`: every
   device tensor copied into pinned host memory, then one
   synchronisation a save). A failed write surfaces on ``health()``,
   ``last_error`` and the failure counter.
4. **Distributed commit**: each worker writes its shard directory and
   rank 0 publishes an atomic ``COMMIT.json`` only after every shard is
   present and verified; resume picks the highest fully committed step.

:class:`PreemptionGuard` and :func:`dispatch_boundary` turn SIGTERM into
an orderly exit: the fit loop finishes its dispatch (on the card a whole
K-step graph replay), saves a consistent snapshot (parameters, updater
and layer state, counters, the training generator, the data cursor)
and raises :class:`PreemptionExit`.

The telemetry is the JAX package's series:
``dl4jtpu_checkpoint_save_seconds`` (histogram by mode),
``dl4jtpu_checkpoint_bytes_total``, ``dl4jtpu_checkpoint_inflight``,
``dl4jtpu_checkpoint_failures_total``,
``dl4jtpu_checkpoint_corrupt_skipped_total`` and
``dl4jtpu_checkpoint_commit_timeouts_total``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import shutil
import signal
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitoring.events import emit as emit_event
from deeplearning4j_tpu_torch.monitoring.metrics import (
    MetricsRegistry, global_registry)

log = logging.getLogger(__name__)

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
DATA_NAME = "data.npz"
COMMIT_NAME = "COMMIT.json"
_TMP_PREFIX = ".tmp-"

CKPT_SAVE_SECONDS = "dl4jtpu_checkpoint_save_seconds"
CKPT_BYTES = "dl4jtpu_checkpoint_bytes_total"
CKPT_INFLIGHT = "dl4jtpu_checkpoint_inflight"
CKPT_FAILURES = "dl4jtpu_checkpoint_failures_total"
CKPT_CORRUPT_SKIPPED = "dl4jtpu_checkpoint_corrupt_skipped_total"
CKPT_COMMIT_TIMEOUTS = "dl4jtpu_checkpoint_commit_timeouts_total"

__all__ = [
    "AsyncCheckpointWriter", "CKPT_BYTES", "CKPT_COMMIT_TIMEOUTS",
    "CKPT_CORRUPT_SKIPPED", "CKPT_FAILURES", "CKPT_INFLIGHT",
    "CKPT_SAVE_SECONDS", "CheckpointError", "CommitTimeoutError",
    "CorruptCheckpointError", "FORMAT_VERSION", "PreemptionExit",
    "PreemptionGuard", "atomic_replace_path", "atomic_write_bytes",
    "atomic_write_json", "atomic_write_text", "capture_cursor_pass",
    "commit_marker_path", "consume_restored_cursor",
    "declare_checkpoint_series", "dispatch_boundary",
    "latest_committed_step", "list_committed_steps", "publish_commit",
    "read_commit", "read_manifest", "read_state_dir", "shard_dir_name",
    "snapshot_tree", "sweep_tmp_dirs", "verify_state_dir", "wait_commit",
    "write_checkpoint_dir", "write_shard",
]


class CheckpointError(RuntimeError):
    """A checkpoint could not be written (an IO failure, a timed-out
    distributed barrier, ...)."""


class CorruptCheckpointError(CheckpointError):
    """A checkpoint's bytes failed verification (a missing manifest, a
    version mismatch, a checksum mismatch, a torn file)."""


class CommitTimeoutError(CheckpointError):
    """The distributed commit barrier timed out: shards never arrived
    (rank 0: ``missing_ranks`` known) or the COMMIT marker never
    appeared (other ranks). Carries the step and the missing ranks;
    counted in ``dl4jtpu_checkpoint_commit_timeouts_total``."""

    def __init__(self, message: str, step: int,
                 missing_ranks: Optional[Sequence[int]] = None,
                 timeout: Optional[float] = None):
        super().__init__(message)
        self.step = int(step)
        self.missing_ranks = None if missing_ranks is None \
            else sorted(int(r) for r in missing_ranks)
        self.timeout = timeout


def declare_checkpoint_series(registry: Optional[MetricsRegistry] = None):
    """Get or create the checkpoint series, so a scrape before the first
    save shows them. Returns (save_seconds, bytes_total, inflight,
    failures, corrupt_skipped, commit_timeouts)."""
    r = registry or global_registry()
    return (
        r.histogram(CKPT_SAVE_SECONDS,
                    "Wall time of one checkpoint serialize+write",
                    ("mode",)),
        r.counter(CKPT_BYTES, "Bytes committed to checkpoint storage"),
        r.gauge(CKPT_INFLIGHT,
                "Async checkpoint saves queued or in progress"),
        r.counter(CKPT_FAILURES, "Checkpoint saves that raised"),
        r.counter(CKPT_CORRUPT_SKIPPED,
                  "Corrupt/torn checkpoints skipped at restore time"),
        r.counter(CKPT_COMMIT_TIMEOUTS,
                  "Distributed commit barriers that timed out"),
    )


# ---------------------------------------------------------------------------
# the crash seam (tests): called with a label at each milestone of a
# checkpoint directory's write, the JAX writer's labels
# ---------------------------------------------------------------------------
_crash_hook: Optional[Callable[[str], None]] = None


def _maybe_crash(point: str) -> None:
    if _crash_hook is not None:
        _crash_hook(point)


# ---------------------------------------------------------------------------
# atomic files
# ---------------------------------------------------------------------------
def _fsync_dir(path: str) -> None:
    """fsync a directory so that a just-renamed entry survives power
    loss; best effort (not every file system opens directories)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _tmp_name(path: str) -> str:
    """A temporary sibling of ``path``, unique to this process and
    thread."""
    return os.path.join(os.path.dirname(path),
                        f"{_TMP_PREFIX}{os.path.basename(path)}."
                        f"{os.getpid()}.{threading.get_ident()}")


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to a temporary sibling, fsync it, rename it onto
    ``path`` and fsync the directory: a reader sees the old content or
    the new, never part of it."""
    path = os.path.abspath(path)
    tmp = _tmp_name(path)
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path))


def atomic_write_text(path: str, text: str) -> None:
    atomic_write_bytes(path, text.encode("utf-8"))


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, (json.dumps(obj, sort_keys=True) + "\n")
                       .encode("utf-8"))


@contextlib.contextmanager
def atomic_replace_path(path: str):
    """For writers that need a real path (``zipfile``, ``np.save``):
    yields a temporary path in the same directory; on a clean exit the
    file there is fsynced and renamed onto ``path`` (then the directory
    fsynced), on an error it is removed. A crash leaves the old file or
    the whole new one, never a mix."""
    path = os.path.abspath(path)
    tmp = _tmp_name(path)
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path))


# ---------------------------------------------------------------------------
# trees of arrays (nested dicts; leaves are arrays or scalars)
# ---------------------------------------------------------------------------
def _flatten_tree(tree: Any, prefix: str = "") -> Tuple[Any, Dict[str, Any]]:
    """(skeleton, leaves): the skeleton mirrors the dict nesting with
    each leaf replaced by ``{"__leaf__": key}`` (``{"__none__": true}``
    for None), JSON-serializable; ``leaves`` maps key -> array. Keys are
    the dict path joined by "/", dicts walked in sorted order."""
    if isinstance(tree, dict):
        skel, leaves = {}, {}
        for k in sorted(tree):
            s, sub = _flatten_tree(tree[k], f"{prefix}{k}/")
            skel[k] = s
            leaves.update(sub)
        return skel, leaves
    if tree is None:
        return {"__none__": True}, {}
    key = prefix.rstrip("/")
    return {"__leaf__": key}, {key: tree}


def _unflatten_tree(skel: Any, leaves: Dict[str, np.ndarray]) -> Any:
    if isinstance(skel, dict):
        if skel.get("__none__"):
            return None
        if "__leaf__" in skel:
            return leaves[skel["__leaf__"]]
        return {k: _unflatten_tree(v, leaves) for k, v in skel.items()}
    raise CorruptCheckpointError(f"malformed tree skeleton node: {skel!r}")


def _leaf_checksum(arr: np.ndarray) -> str:
    """crc32 over dtype, shape and the raw bytes (C order)."""
    a = np.ascontiguousarray(arr)
    h = zlib.crc32(str(a.dtype).encode())
    h = zlib.crc32(str(a.shape).encode(), h)
    h = zlib.crc32(a.tobytes(), h)
    return f"{h:08x}"


def snapshot_tree(tree: Any) -> Any:
    """The tree as host numpy arrays: the only part of a save the fit
    loop waits for. Each CUDA tensor is copied into pinned host memory
    without blocking, on its device's current stream (so after the
    dispatch that wrote it), then one synchronisation covers them all.
    bf16 leaves are stored as f32 (exactly: numpy has no bf16)."""
    pending = []

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if x is None:
            return None
        if torch.is_tensor(x):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                x = x.float()
            if x.device.type == "cuda":
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                pending.append(x.device)
                return h
            return x.clone()
        return x

    out = host(tree)
    for device in dict.fromkeys(pending):
        torch.cuda.current_stream(device).synchronize()

    def numpy(x):
        if isinstance(x, dict):
            return {k: numpy(v) for k, v in x.items()}
        if x is None:
            return None
        return x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return numpy(out)


# ---------------------------------------------------------------------------
# the checkpoint directory
# ---------------------------------------------------------------------------
def _npz_key(key: str) -> str:
    # a reversible escape of the path separator (the manifest's skeleton
    # holds the real keys)
    return key.replace("/", "|")


def write_checkpoint_dir(final_dir: str, tree: Any,
                         extras: Optional[Dict[str, Any]] = None,
                         registry: Optional[MetricsRegistry] = None) -> int:
    """Write one checkpoint directory (``data.npz`` and ``MANIFEST.json``
    with a checksum a leaf) under a temporary sibling and rename it into
    place, so ``final_dir`` only exists whole. Returns the bytes
    written.

    An existing ``final_dir`` (a same-step save; the step-less "latest"
    directory) is moved aside first, the new one renamed in, then the
    aside copy removed: a kill between the two renames leaves both on
    disk (the aside one as ``<name>.replaced.<pid>.<tid>``, which
    listings skip and sweeps keep), and an in-process failure moves it
    back."""
    final_dir = os.path.abspath(final_dir)
    parent = os.path.dirname(final_dir)
    os.makedirs(parent, exist_ok=True)
    tmp_dir = _tmp_name(final_dir)
    skel, leaves = _flatten_tree(snapshot_tree(tree))
    aside = None
    try:
        os.makedirs(tmp_dir)
        data_path = os.path.join(tmp_dir, DATA_NAME)
        # straight into the file: a save's peak host memory is the
        # snapshot itself
        with open(data_path, "wb") as f:
            np.savez(f, **{_npz_key(k): np.asarray(v)
                           for k, v in leaves.items()})
            f.flush()
            os.fsync(f.fileno())
        data_bytes = os.path.getsize(data_path)
        _maybe_crash("data-written")
        manifest = {
            "format_version": FORMAT_VERSION,
            "tree": skel,
            "leaves": {k: {"checksum": _leaf_checksum(np.asarray(v)),
                           "dtype": str(np.asarray(v).dtype),
                           "shape": list(np.asarray(v).shape)}
                       for k, v in leaves.items()},
            "extras": extras or {},
        }
        mbytes = (json.dumps(manifest, sort_keys=True) + "\n").encode()
        with open(os.path.join(tmp_dir, MANIFEST_NAME), "wb") as f:
            f.write(mbytes)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp_dir)
        _maybe_crash("pre-rename")
        if os.path.exists(final_dir):
            # not tmp-prefixed: a sweep never reclaims the survivor
            aside = os.path.join(parent,
                                 f"{os.path.basename(final_dir)}.replaced."
                                 f"{os.getpid()}.{threading.get_ident()}")
            os.rename(final_dir, aside)
            _maybe_crash("mid-replace")
            os.replace(tmp_dir, final_dir)
            shutil.rmtree(aside, ignore_errors=True)
            aside = None
        else:
            os.replace(tmp_dir, final_dir)
        _fsync_dir(parent)
        _maybe_crash("post-rename")
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        if aside is not None and os.path.exists(aside) and \
                not os.path.exists(final_dir):
            try:
                os.rename(aside, final_dir)
            except OSError:
                pass
        raise
    n = data_bytes + len(mbytes)
    declare_checkpoint_series(registry)[1].inc(n)
    return n


def read_manifest(step_dir: str) -> Dict[str, Any]:
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"unreadable manifest at {mpath}: {e}") from e
    v = m.get("format_version")
    if v != FORMAT_VERSION:
        raise CorruptCheckpointError(
            f"{mpath}: format version {v!r} != supported {FORMAT_VERSION}")
    return m


def _read_leaves(step_dir: str, manifest: Dict[str, Any],
                 verify: bool = True) -> Dict[str, np.ndarray]:
    dpath = os.path.join(step_dir, DATA_NAME)
    try:
        with np.load(dpath, allow_pickle=False) as z:
            raw = {k: z[_npz_key(k)] for k in manifest["leaves"]}
    except Exception as e:  # noqa: BLE001 — torn bytes raise anything
        raise CorruptCheckpointError(f"torn/unreadable {dpath}: {e}") from e
    if verify:
        for k, meta in manifest["leaves"].items():
            got = _leaf_checksum(raw[k])
            if got != meta["checksum"]:
                raise CorruptCheckpointError(
                    f"{dpath}: checksum mismatch on leaf {k!r} "
                    f"({got} != recorded {meta['checksum']})")
    return raw


def read_state_dir(step_dir: str, verify: bool = True
                   ) -> Tuple[Any, Dict[str, Any]]:
    """(tree of numpy arrays, manifest) of a checkpoint directory, every
    leaf's checksum verified by default; raises
    :class:`CorruptCheckpointError` on any failure (the caller decides
    whether to fall back)."""
    manifest = read_manifest(step_dir)
    leaves = _read_leaves(step_dir, manifest, verify=verify)
    return _unflatten_tree(manifest["tree"], leaves), manifest


def verify_state_dir(step_dir: str) -> bool:
    """Whether the directory is a checkpoint whose bytes all pass their
    checksums."""
    try:
        _read_leaves(step_dir, read_manifest(step_dir), verify=True)
        return True
    except CorruptCheckpointError:
        return False


def sweep_tmp_dirs(path: str) -> int:
    """Remove crashed writers' temporary files and directories under a
    checkpoint root (safe at any time: nothing committed lives under a
    temporary name); returns how many."""
    if not os.path.isdir(path):
        return 0
    n = 0
    for name in os.listdir(path):
        if name.startswith(_TMP_PREFIX):
            full = os.path.join(path, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                try:
                    os.unlink(full)
                except OSError:
                    continue
            n += 1
    return n


# ---------------------------------------------------------------------------
# the asynchronous writer
# ---------------------------------------------------------------------------
class AsyncCheckpointWriter:
    """One background thread that runs write jobs in submission order.
    The fit loop hands over a host snapshot and goes on; ``submit``
    blocks while ``max_pending`` jobs are queued (backpressure: a slow
    disk slows the saves instead of piling up snapshots).

    A failed job does not stop training: its exception lands on
    ``last_error``, counts in ``dl4jtpu_checkpoint_failures_total`` and
    marks ``health()`` unhealthy until a later save succeeds; every
    earlier checkpoint stays as it was (writes go to temporary names).
    """

    def __init__(self, max_pending: int = 2,
                 registry: Optional[MetricsRegistry] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self._registry = registry
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._outstanding = 0   # submitted, not yet finished
        self._idle = threading.Event()
        self._idle.set()
        self.last_error: Optional[BaseException] = None
        self.failures = 0
        self.completed = 0
        (self._save_hist, _, self._inflight, self._fail_counter,
         *_rest) = declare_checkpoint_series(registry)

    def _ensure_thread(self) -> None:
        with self._lock:
            t = self._thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._run, daemon=True,
                                     name="checkpoint-writer")
                self._thread = t
                t.start()

    def _run(self) -> None:
        while True:
            fn, label, is_save = self._q.get()
            t0 = time.perf_counter()
            try:
                fn()
                with self._lock:
                    self.completed += 1
                    if is_save:
                        # only a save clears the unhealthy mark
                        self.last_error = None
                if is_save:
                    self._save_hist.observe(time.perf_counter() - t0,
                                            mode="async")
            except BaseException as e:  # noqa: BLE001 — surfaced, never lost
                with self._lock:
                    self.failures += 1
                    self.last_error = e
                self._fail_counter.inc()
                log.warning("async checkpoint save %s failed: %r", label, e)
            finally:
                self._inflight.dec()
                with self._lock:
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._idle.set()

    def submit(self, fn: Callable[[], None], label: str = "save",
               is_save: bool = True) -> None:
        """Queue a write job (run in submission order); blocks while the
        queue is full. Housekeeping jobs (``is_save=False``: pruning)
        neither clear the unhealthy mark nor count as saves."""
        self._ensure_thread()
        with self._lock:
            self._outstanding += 1
            self._idle.clear()
        self._inflight.inc()
        try:
            self._q.put((fn, label, is_save))
        except BaseException:
            self._inflight.dec()
            with self._lock:
                self._outstanding -= 1
                if self._outstanding == 0:
                    self._idle.set()
            raise

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted job has finished; False on a
        timeout."""
        t = self._thread
        if t is None or not t.is_alive():
            return True
        return self._idle.wait(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the queue. The worker thread stays parked on it (a
        daemon, idle for free) so the writer serves the next fit with
        the same single worker: two workers on one queue would break the
        save-then-prune order that keeps a predecessor until its
        successor is committed."""
        self.flush(timeout)

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "healthy": self.last_error is None,
                "pending": self._q.qsize(),
                "completed": self.completed,
                "failures": self.failures,
                "last_error": None if self.last_error is None
                else repr(self.last_error),
            }


# ---------------------------------------------------------------------------
# preemption and the fit loop's dispatch boundary
# ---------------------------------------------------------------------------
class PreemptionExit(SystemExit):
    """Raised at the first dispatch boundary after a preemption signal,
    once the emergency checkpoint is durable. A ``SystemExit``: the fit
    loop's ``finally`` closes the listeners, and left unhandled it ends
    the process with ``code``."""

    def __init__(self, step: int, checkpoint_dir: str, code: int = 0):
        super().__init__(code)
        self.step = step
        self.checkpoint_dir = checkpoint_dir


class PreemptionGuard:
    """SIGTERM -> finish the dispatch -> emergency save -> exit.

    The handler only sets a flag; the fit loop polls it at each dispatch
    boundary (:func:`dispatch_boundary`), where the trees, the counters,
    the training generator and the data cursor agree, and saves there
    synchronously, so the run resumes bit for bit::

        guard = PreemptionGuard(net, ckpt_dir)     # installs SIGTERM
        try:
            net.fit(it, epochs=10)
        except PreemptionExit:
            ...                                     # saved; exit soon

    ``trigger()`` arms it from code. ``writer`` (and every listener's
    writer) is flushed before the emergency save, so queued saves land
    first."""

    def __init__(self, net, checkpoint_dir: str,
                 signals: Tuple[int, ...] = (signal.SIGTERM,),
                 writer: Optional[AsyncCheckpointWriter] = None,
                 exit_code: int = 0, install: bool = True):
        self.net = net
        self.checkpoint_dir = checkpoint_dir
        self.signals = tuple(signals)
        self.writer = writer
        self.exit_code = exit_code
        self.triggered = False
        self.saved_step: Optional[int] = None
        self._prev: Dict[int, Any] = {}
        self._installed = False
        net._preemption_guard = self
        if install:
            self.install()

    def _handler(self, signum, frame):  # noqa: ARG002 — signal signature
        self.triggered = True

    def install(self) -> "PreemptionGuard":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:
            # not the main thread: trigger() is the way to arm it
            log.warning("PreemptionGuard: not on main thread, signal "
                        "handler not installed (use trigger())")
        return self

    def uninstall(self) -> None:
        if self._installed:
            for s, prev in self._prev.items():
                try:
                    signal.signal(s, prev)
                except (ValueError, OSError):
                    pass
            self._installed = False
        if getattr(self.net, "_preemption_guard", None) is self:
            self.net._preemption_guard = None

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def trigger(self) -> None:
        """Arm the guard as if the signal had arrived."""
        self.triggered = True

    def handle(self, net) -> None:
        """At a dispatch boundary: nothing unless armed; else save
        (synchronously, durable before it returns) and raise
        :class:`PreemptionExit`."""
        if not self.triggered:
            return
        if self.writer is not None:
            self.writer.flush()
        from deeplearning4j_tpu_torch.util.checkpoint import (
            save_checkpoint, verify_checkpoint)
        for lst in getattr(net, "listeners", ()):
            w = getattr(lst, "writer", None)
            if isinstance(w, AsyncCheckpointWriter):
                w.flush()
        step = int(net.iteration_count)
        if not verify_checkpoint(self.checkpoint_dir, step):
            # a cadence save at this boundary may have committed the
            # step already: re-saving it would open the replace window
            save_checkpoint(net, self.checkpoint_dir, step=step)
        self.saved_step = step
        emit_event("resilience", "preemption", step=step,
                   checkpoint_dir=self.checkpoint_dir)
        log.warning("preemption: emergency checkpoint at step %d (%s); "
                    "exiting", step, self.checkpoint_dir)
        raise PreemptionExit(step, self.checkpoint_dir, self.exit_code)


def dispatch_boundary(net) -> None:
    """The fit loop's consistency point after each dispatch (a group, a
    batch, a tBPTT batch), once its parameters, counters and listeners
    are done: listeners' ``on_dispatch_boundary`` hooks run (a
    checkpoint's cadence saves: inside a group ``iteration_done`` fires
    per logical step against the group's final trees, so a save there
    would mix two steps), then a pending preemption is honoured."""
    for lst in getattr(net, "listeners", ()):
        hook = getattr(lst, "on_dispatch_boundary", None)
        if hook is not None:
            hook(net)
    guard = getattr(net, "_preemption_guard", None)
    if guard is not None:
        guard.handle(net)


def consume_restored_cursor(net, it) -> int:
    """Apply a restored checkpoint's data cursor to the fit's iterator
    (once, when the fit starts): the iterator resumes at the batch after
    the last dispatched one, in the same pass (so shuffled passes line
    up), and the net's dispatch counters are re-armed. Returns the
    restored position in the pass (0: at a pass boundary).

    An iterator without ``restore_state`` replays the interrupted pass
    from its start (an approximate continuation), with a warning."""
    cur = getattr(net, "_restored_pipeline_state", None)
    net._restored_pipeline_state = None
    net._canon_in_epoch = None
    net._dispatched_in_epoch = 0
    if not cur:
        return 0
    pos = int(cur.get("pos", 0) or 0)
    epoch = int(cur.get("epoch", 0) or 0)
    restore = getattr(it, "restore_state", None)
    if restore is None:
        if pos:
            log.warning(
                "restored checkpoint carries a mid-epoch data cursor "
                "(epoch %d, batch %d) but %s has no restore_state(): "
                "resuming with the interrupted epoch replayed "
                "(approximate continuation, not bit-exact)",
                epoch, pos, type(it).__name__)
        return 0
    try:
        restore({"epoch": epoch, "pos": pos})
    except NotImplementedError as e:
        if pos:
            log.warning("data-pipeline cursor restore unsupported (%s); "
                        "approximate continuation", e)
        return 0
    net._dispatched_in_epoch = pos
    canon = cur.get("canon")
    net._canon_in_epoch = None if canon is None else int(canon)
    return pos


def capture_cursor_pass(net, it) -> None:
    """Pin the index of the pass the fit is about to run: the
    iterator's own (its counter seeds the shuffle) where it has a
    cursor, else the epoch count; held for the whole pass, so a save at
    any boundary (the trailing flush's too, after the iterator already
    moved to the next pass) stamps a pass consistent with the
    dispatched count."""
    pass_idx = net.epoch_count
    state_fn = getattr(it, "state", None)
    if state_fn is not None:
        try:
            pass_idx = int(state_fn()["epoch"])
        except Exception:  # noqa: BLE001 — the cursor read is best effort
            pass
    net._cursor_pass = int(pass_idx)


# ---------------------------------------------------------------------------
# the distributed commit protocol (over files)
# ---------------------------------------------------------------------------
def shard_dir_name(rank: int) -> str:
    return f"shard_{int(rank)}"


def commit_marker_path(step_dir: str) -> str:
    return os.path.join(step_dir, COMMIT_NAME)


def write_shard(step_dir: str, rank: int, tree: Any,
                extras: Optional[Dict[str, Any]] = None) -> str:
    """Write this worker's shard of a distributed checkpoint (atomic,
    checksummed); the shard directory's existence is the worker's
    arrival at the commit barrier."""
    sdir = os.path.join(os.path.abspath(step_dir), shard_dir_name(rank))
    write_checkpoint_dir(sdir, tree, extras=extras)
    return sdir


def publish_commit(step_dir: str, step: int, world: int,
                   timeout: float = 60.0, poll: float = 0.05) -> None:
    """Rank 0's half of the barrier: wait for every shard to be present
    and intact, then write the COMMIT marker atomically. A worker that
    died before its shard makes this time out with
    :class:`CommitTimeoutError` (the step and the missing ranks), and
    the step stays uncommitted (resume ignores it)."""
    step_dir = os.path.abspath(step_dir)
    deadline = time.monotonic() + timeout
    missing = list(range(world))
    while missing:
        missing = [r for r in missing
                   if not os.path.exists(os.path.join(
                       step_dir, shard_dir_name(r), MANIFEST_NAME))]
        if not missing:
            break
        if time.monotonic() > deadline:
            declare_checkpoint_series()[5].inc()
            raise CommitTimeoutError(
                f"distributed checkpoint step {step}: shards {missing} "
                f"never arrived within {timeout}s — step NOT committed",
                step=step, missing_ranks=missing, timeout=timeout)
        time.sleep(poll)
    bad = [r for r in range(world)
           if not verify_state_dir(os.path.join(step_dir,
                                                shard_dir_name(r)))]
    if bad:
        raise CheckpointError(
            f"distributed checkpoint step {step}: shards {bad} failed "
            f"integrity verification — step NOT committed")
    atomic_write_json(commit_marker_path(step_dir), {
        "format_version": FORMAT_VERSION, "step": int(step),
        "world": int(world), "shards": [shard_dir_name(r)
                                        for r in range(world)],
    })
    emit_event("resilience", "checkpoint_commit", step=int(step),
               world=int(world))


def wait_commit(step_dir: str, timeout: float = 60.0,
                poll: float = 0.05,
                world: Optional[int] = None) -> Dict[str, Any]:
    """The other ranks' half of the barrier: block until rank 0 has
    published the COMMIT marker; a timeout raises
    :class:`CommitTimeoutError` (with ``world``, naming the ranks whose
    shards are absent)."""
    step_dir = os.path.abspath(step_dir)
    deadline = time.monotonic() + timeout
    while True:
        c = read_commit(step_dir)
        if c is not None:
            return c
        if time.monotonic() > deadline:
            tail = os.path.basename(step_dir).rsplit("_", 1)[-1]
            step = int(tail) if tail.isdigit() else -1
            missing = None
            if world is not None:
                missing = [r for r in range(int(world))
                           if not os.path.exists(os.path.join(
                               step_dir, shard_dir_name(r),
                               MANIFEST_NAME))]
            declare_checkpoint_series()[5].inc()
            raise CommitTimeoutError(
                f"no COMMIT marker appeared under {step_dir} within "
                f"{timeout}s" + (f" (shards absent: {missing})"
                                 if missing else ""),
                step=step, missing_ranks=missing, timeout=timeout)
        time.sleep(poll)


def read_commit(step_dir: str) -> Optional[Dict[str, Any]]:
    try:
        with open(commit_marker_path(step_dir), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def list_committed_steps(path: str) -> List[int]:
    """Steps under a distributed checkpoint root whose COMMIT marker is
    present and readable, ascending; an uncommitted step is invisible."""
    if not os.path.isdir(path):
        return []
    steps = []
    for name in os.listdir(path):
        if not name.startswith("step_"):
            continue
        try:
            s = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if read_commit(os.path.join(path, name)) is not None:
            steps.append(s)
    return sorted(steps)


def latest_committed_step(path: str) -> Optional[int]:
    steps = list_committed_steps(path)
    return steps[-1] if steps else None
