"""Crash-consistent checkpoints of a training run, and the listener that
takes them.

Counterpart of ``deeplearning4j_tpu/util/checkpoint.py``, on the
durable layer (``resilience/durable.py``) and in the JAX package's
on-disk format, so either package reads what the other wrote:

- a checkpoint is a step directory ``step_<n>`` (or ``latest``) of
  ``data.npz`` and ``MANIFEST.json`` (the format version, a crc32 a
  leaf), assembled under a temporary name and renamed into place;
  beside it ``step_<n>.resilience.json`` (the sentinel's health tag and
  the score) and the root's ``config.json`` (the model class and the
  configuration's JSON);
- the tree is the JAX package's: ``params``, ``state``,
  ``updater_state`` (each under the JAX leaf keys), ``counters``
  (``iteration``, ``epoch``) and ``rng``; the manifest's extras carry
  the data cursor (``pipeline``), the ``learning_rate``, the
  ``sentinel`` counts, the listeners' durable state (``listeners``) and
  the health tag (``resilience``).

The one exception is the ``rng`` leaf. The JAX package's is its
``uint32[2]`` training key; the port's training stream is a
``torch.Generator`` (on the card a Philox seed and offset, on the CPU
the Mersenne Twister's state), so the port writes the generator's
``get_state()`` bytes there and records in the extras that this package
wrote them (``framework``, ``rng``). Restoring a checkpoint the JAX
package wrote (or one from the other device type), the port keeps its
own seeded stream and logs a warning. The JAX package, in turn, takes
the leaf as its key and cannot draw from it (ROADMAP.md §C).

``restore_checkpoint`` verifies every leaf before it applies one and,
for the newest checkpoint, falls back to the next intact one.
``CheckpointListener`` saves at dispatch boundaries (the fit loop's
``dispatch_boundary``: inside a K-step group ``iteration_done`` fires
per logical step against the group's final trees), and with
``async_save=True`` the fit waits only for the snapshot (the trees of a
step graph are its static trees, updated in place by each replay, and
the snapshot copies them before the next replay is queued).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.monitoring.events import emit as emit_event
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.resilience.durable import (
    MANIFEST_NAME, AsyncCheckpointWriter, CommitTimeoutError,
    CorruptCheckpointError, atomic_write_json, declare_checkpoint_series,
    list_committed_steps, publish_commit, read_commit, read_manifest,
    read_state_dir, shard_dir_name, snapshot_tree, verify_state_dir,
    wait_commit, write_checkpoint_dir, write_shard)

log = logging.getLogger(__name__)

__all__ = [
    "CheckpointListener", "CommitTimeoutError", "FRAMEWORK",
    "checkpoint_status", "delete_checkpoint", "list_checkpoints",
    "list_good_checkpoints", "load_checkpoint", "restore_checkpoint",
    "restore_distributed_checkpoint", "save_checkpoint",
    "save_distributed_checkpoint", "verify_checkpoint",
]

#: the package a checkpoint's ``framework`` extra names when the port
#: wrote it (the model serializer's ``meta.json`` names it so too)
FRAMEWORK = "deeplearning4j_tpu_torch"


def _net_state_tree(net) -> Dict[str, Any]:
    g = getattr(net, "_train_gen", None)
    return {
        "params": net.params,
        "state": net.state,
        "updater_state": net.updater_state,
        "counters": {
            "iteration": np.int64(net.iteration_count),
            "epoch": np.int64(net.epoch_count),
        },
        # the training generator: without it a resumed run would draw
        # other dropout masks than a straight one
        "rng": np.zeros(2, np.uint32) if g is None
        else g.get_state().numpy().copy(),
    }


def _sentinel_status(net) -> Dict[str, Any]:
    """A checkpoint's health tag: the sentinel's accounting settled (a
    save reads the device anyway), whether the saved state is good (no
    live run of bad steps) and the score at the save, which a rollback
    after a finite blow-up needs."""
    from deeplearning4j_tpu_torch.resilience.sentinel import (
        flush_accounting)
    acct = flush_accounting(net)
    try:
        score = float(net.score_value)
        score = None if score != score else score
    except (TypeError, ValueError):
        score = None
    if acct is None:
        return {"good": True, "bad_steps": 0, "consecutive_bad": 0,
                "score": score}
    return {"good": acct.consecutive_bad == 0,
            "bad_steps": acct.bad_steps,
            "consecutive_bad": acct.consecutive_bad,
            "score": score}


def _manifest_extras(net, status: Dict[str, Any]) -> Dict[str, Any]:
    """What an exact resume needs beyond the tree: the data cursor (the
    pass the fit loop pinned, the batches it dispatched in it, the
    pass's padded row count), the learning rate (a backed-off rate
    survives the process), the sentinel's counts, the listeners' durable
    state, and which package wrote the ``rng`` leaf."""
    extras: Dict[str, Any] = {"model_class": type(net).__name__,
                              "resilience": status}
    cursor_pass = getattr(net, "_cursor_pass", None)
    epoch = int(net.epoch_count) if cursor_pass is None else int(cursor_pass)
    canon = getattr(net, "_canon_in_epoch", None)
    extras["pipeline"] = {
        "epoch": epoch,
        "pos": int(getattr(net, "_dispatched_in_epoch", 0) or 0),
        "canon": None if canon is None else int(canon),
    }
    lr = getattr(getattr(getattr(net, "conf", None), "updater", None),
                 "learning_rate", None)
    if lr is not None:
        extras["learning_rate"] = float(lr)
    acct = getattr(net, "_sentinel_accounting", None)
    if acct is not None:
        extras["sentinel"] = {
            "total_steps": int(acct.total_steps),
            "bad_steps": int(acct.bad_steps),
            "skipped_updates": int(acct.skipped_updates),
            "consecutive_bad": int(acct.consecutive_bad),
        }
    listeners = {}
    for lst in getattr(net, "listeners", ()):
        state_fn = getattr(lst, "durable_state", None)
        if state_fn is not None:
            # the first listener of a class wins
            listeners.setdefault(type(lst).__name__, state_fn())
    if listeners:
        extras["listeners"] = listeners
    g = getattr(net, "_train_gen", None)
    extras["framework"] = FRAMEWORK
    extras["rng"] = {"encoding": "torch.Generator.get_state",
                     "device": None if g is None else g.device.type}
    return extras


def _step_dirname(step: Optional[int]) -> str:
    return "latest" if step is None else f"step_{int(step)}"


def save_checkpoint(net, path: str, step: Optional[int] = None,
                    writer: Optional[AsyncCheckpointWriter] = None) -> str:
    """Write a crash-consistent checkpoint of the network's training
    state; returns its directory. The snapshot (device to host, one
    synchronisation) happens here; with ``writer`` the serialization,
    the write and the rename run on the writer's thread, in submission
    order. Each step directory gets its health tag beside it, so a
    rollback (``util/recovery.py``) can pick the last good one."""
    import time
    path = os.path.abspath(path)
    step_dir = os.path.join(path, _step_dirname(step))
    t0 = time.perf_counter()
    host_tree = snapshot_tree(_net_state_tree(net))
    status = _sentinel_status(net)
    extras = _manifest_extras(net, status)
    meta = {"model_class": type(net).__name__, "config": net.conf.to_json()}

    def write():
        write_checkpoint_dir(step_dir, host_tree, extras=extras)
        if step is not None:
            # beside the step directory, so status reads skip the
            # manifest (which holds it too)
            atomic_write_json(_tag_path(path, step), status)
        atomic_write_json(os.path.join(path, "config.json"), meta)
        emit_event("resilience", "checkpoint_save", step=step,
                   mode="async" if writer is not None else "sync")

    if writer is not None:
        writer.submit(write, label=os.path.basename(step_dir))
    else:
        write()
        declare_checkpoint_series()[0].observe(time.perf_counter() - t0,
                                               mode="sync")
    return step_dir


def _apply_tree(net, restored: Dict[str, Any],
                extras: Dict[str, Any]) -> None:
    """The restored trees into ``net`` through its numpy loaders (keys,
    names and shapes checked; f32 leaves, int32 step counts), the
    counters, and the training generator where this package wrote it
    for this device type."""
    from deeplearning4j_tpu_torch.nn.network_base import _strip_stream
    net.load_numpy_params(restored["params"])
    net.state = _strip_stream(net.state)
    net.load_numpy_state(_strip_stream(restored["state"]))
    net.load_numpy_updater_state(restored["updater_state"])
    net.iteration_count = int(restored["counters"]["iteration"])
    net.epoch_count = int(restored["counters"]["epoch"])
    g = getattr(net, "_train_gen", None)
    rng = restored.get("rng")
    if g is None or rng is None:
        return
    meta = extras.get("rng") or {}
    state = g.get_state()
    if extras.get("framework") == FRAMEWORK and \
            meta.get("device") == g.device.type and \
            rng.dtype == np.uint8 and rng.size == state.numel():
        g.set_state(torch.from_numpy(np.array(rng, np.uint8)))
    else:
        log.warning(
            "the checkpoint's rng leaf (%s, %s) is not this package's "
            "%s training stream: keeping the network's own seeded stream",
            extras.get("framework", "deeplearning4j_tpu"),
            meta.get("device", f"{rng.dtype}{list(rng.shape)}"),
            g.device.type)


def _apply_extras(net, extras: Dict[str, Any]) -> None:
    """The rest of an exact resume: the score, the learning rate (a new
    rate drops the step graph, which baked the old one in), the
    sentinel's counts, the listeners' durable state and the data cursor
    the next fit consumes."""
    status = extras.get("resilience") or {}
    score = status.get("score")
    if score is not None:
        net.score_value = float(score)
    lr = extras.get("learning_rate")
    upd = getattr(getattr(net, "conf", None), "updater", None)
    if lr is not None and upd is not None and \
            getattr(upd, "learning_rate", None) is not None and \
            float(upd.learning_rate) != float(lr):
        upd.learning_rate = float(lr)
        net._drop_step_graph()
    sent = extras.get("sentinel")
    if sent is not None:
        from deeplearning4j_tpu_torch.resilience.sentinel import (
            accounting_for)
        acct = accounting_for(net)
        acct.reset_window()
        acct.total_steps = int(sent.get("total_steps", 0))
        acct.bad_steps = int(sent.get("bad_steps", 0))
        acct.skipped_updates = int(sent.get("skipped_updates", 0))
        acct.consecutive_bad = int(sent.get("consecutive_bad", 0))
    saved = extras.get("listeners") or {}
    for lst in getattr(net, "listeners", ()):
        restore_fn = getattr(lst, "restore_durable_state", None)
        if restore_fn is not None and type(lst).__name__ in saved:
            restore_fn(saved[type(lst).__name__])
    net._restored_pipeline_state = extras.get("pipeline")


def _corrupt_skip_counter():
    return declare_checkpoint_series()[4]


def _restore_from(net, candidates: List[str], explicit: bool, path: str):
    """Restore the first candidate directory whose bytes verify; with an
    explicit step a corrupt one raises, else it is skipped (a warning
    and the counter) for the next."""
    last_err: Optional[CorruptCheckpointError] = None
    for i, step_dir in enumerate(candidates):
        try:
            restored, manifest = read_state_dir(step_dir, verify=True)
        except CorruptCheckpointError as e:
            last_err = e
            if explicit:
                raise
            log.warning("checkpoint %s failed integrity verification "
                        "(%s); falling back to the next-newest intact "
                        "checkpoint", step_dir, e)
            _corrupt_skip_counter().inc()
            continue
        if i > 0:
            log.warning("restored fallback checkpoint %s", step_dir)
        extras = manifest.get("extras") or {}
        _apply_tree(net, restored, extras)
        _apply_extras(net, extras)
        return step_dir
    raise CorruptCheckpointError(
        f"every checkpoint under {path} failed integrity verification "
        f"(last error: {last_err})")


def restore_checkpoint(net, path: str, step: Optional[int] = None,
                       verify: bool = True):
    """Restore a checkpoint into an initialized network, in place, every
    leaf verified first. An explicit ``step`` that is corrupt raises
    :class:`CorruptCheckpointError` (absent: ``FileNotFoundError``);
    with ``step=None`` the newest is taken, falling back to the next
    intact one."""
    path = os.path.abspath(path)
    if step is not None:
        step_dir = os.path.join(path, _step_dirname(step))
        if not os.path.isdir(step_dir):
            raise FileNotFoundError(
                f"no checkpoint step {step} under {path}")
        candidates = [step_dir]
    else:
        candidates = []
        latest = os.path.join(path, "latest")
        if os.path.isdir(latest):
            candidates.append(latest)
        candidates += [os.path.join(path, _step_dirname(s))
                       for s in reversed(list_checkpoints(path))]
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {path}")
    _restore_from(net, candidates, step is not None, path)
    return net


def verify_checkpoint(path: str, step: Optional[int] = None) -> bool:
    """Whether the step's bytes pass the manifest and checksums."""
    return verify_state_dir(os.path.join(os.path.abspath(path),
                                         _step_dirname(step)))


def load_checkpoint(path: str, step: Optional[int] = None, device=None):
    """A network built from the checkpoint's stored configuration on
    ``device`` (default ``"cuda"``), then restored."""
    from deeplearning4j_tpu_torch.nn.conf.network import (
        ComputationGraphConfiguration, MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    path = os.path.abspath(path)
    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    if meta["model_class"] == "MultiLayerNetwork":
        net = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(meta["config"]))
    else:
        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(meta["config"]))
    net.init(device=device)
    return restore_checkpoint(net, path, step)


def list_checkpoints(path: str) -> List[int]:
    """The steps of the checkpoints under ``path`` (step directories
    with a manifest), ascending; the bytes are verified at restore. Step
    directories without a manifest are named in a warning."""
    if not os.path.isdir(path):
        return []
    steps, legacy = [], []
    for name in os.listdir(path):
        if not name.startswith("step_") or name.endswith(".json"):
            continue
        try:
            s = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(path, name, MANIFEST_NAME)):
            steps.append(s)
        else:
            legacy.append(s)
    if legacy:
        log.warning("ignoring %d checkpoint dir(s) without a manifest "
                    "under %s (steps %s — pre-durable-format?); they "
                    "cannot be integrity-verified or restored by this "
                    "version, migrate or delete them",
                    len(legacy), path, sorted(legacy))
    return sorted(steps)


def _tag_path(path: str, step: int) -> str:
    """Where a step's health tag lives."""
    return os.path.join(os.path.abspath(path),
                        f"step_{step}.resilience.json")


def delete_checkpoint(path: str, step: int) -> None:
    """Remove a step directory and its health tag together (a stale tag
    would read as the status of a later save of that step)."""
    shutil.rmtree(os.path.join(os.path.abspath(path), f"step_{step}"),
                  ignore_errors=True)
    try:
        os.unlink(_tag_path(path, step))
    except OSError:
        pass


def checkpoint_status(path: str, step: int) -> Dict[str, Any]:
    """The health tag beside a step directory; else the manifest's copy
    (a crash between the directory's rename and the tag's write); else
    good."""
    try:
        with open(_tag_path(path, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        pass
    try:
        m = read_manifest(os.path.join(os.path.abspath(path),
                                       _step_dirname(step)))
        status = (m.get("extras") or {}).get("resilience")
        if status:
            return status
    except CorruptCheckpointError:
        pass
    return {"good": True}


def list_good_checkpoints(path: str) -> List[int]:
    """The steps whose saved state the sentinel tagged good, ascending."""
    return [s for s in list_checkpoints(path)
            if checkpoint_status(path, s).get("good", True)]


# ---------------------------------------------------------------------------
# multi-process checkpoints over the file commit protocol
# ---------------------------------------------------------------------------
def _dist_rank_world(rank: Optional[int], world: Optional[int]):
    """The caller's rank and world, else ``torch.distributed``'s when it
    is initialized, else (0, 1)."""
    if rank is None or world is None:
        dist = torch.distributed
        on = dist.is_available() and dist.is_initialized()
        if rank is None:
            rank = dist.get_rank() if on else 0
        if world is None:
            world = dist.get_world_size() if on else 1
    return int(rank), int(world)


def save_distributed_checkpoint(net, path: str, step: int,
                                rank: Optional[int] = None,
                                world: Optional[int] = None,
                                timeout: float = 60.0,
                                wait: bool = True,
                                publish: bool = True) -> str:
    """Each worker writes its shard under ``step_<n>/shard_<rank>``;
    rank 0 then waits for every shard, verifies them and publishes the
    COMMIT marker, and the others (``wait=True``) block until it
    appears: a returned save is durable everywhere. A worker that dies
    before its shard leaves the step uncommitted (rank 0 times out and
    writes no marker). ``publish=False`` (rank 0) leaves the marker to
    the caller (``resilience.durable.publish_commit``)."""
    rank, world = _dist_rank_world(rank, world)
    path = os.path.abspath(path)
    step_dir = os.path.join(path, f"step_{int(step)}")
    host_tree = snapshot_tree(_net_state_tree(net))
    extras = _manifest_extras(net, _sentinel_status(net))
    extras["rank"] = rank
    extras["world"] = world
    sdir = write_shard(step_dir, rank, host_tree, extras=extras)
    if rank == 0:
        atomic_write_json(os.path.join(path, "config.json"),
                          {"model_class": type(net).__name__,
                           "config": net.conf.to_json()})
        if publish:
            publish_commit(step_dir, step=int(step), world=world,
                           timeout=timeout)
    elif wait:
        wait_commit(step_dir, timeout=timeout, world=world)
    return sdir


def restore_distributed_checkpoint(net, path: str,
                                   rank: Optional[int] = None,
                                   world: Optional[int] = None,
                                   step: Optional[int] = None):
    """Restore this worker's shard of the highest committed step (or of
    ``step``); an uncommitted step is invisible and a corrupt committed
    shard falls back to the next committed step. Returns the step, or
    None when nothing is committed."""
    rank, world = _dist_rank_world(rank, world)
    path = os.path.abspath(path)
    if step is not None:
        steps = [int(step)]
        if read_commit(os.path.join(path, f"step_{int(step)}")) is None:
            raise CorruptCheckpointError(
                f"step {step} under {path} has no COMMIT marker")
    else:
        steps = list(reversed(list_committed_steps(path)))
        if not steps:
            return None
    for s in steps:
        sdir = os.path.join(path, f"step_{s}", shard_dir_name(rank))
        try:
            _restore_from(net, [sdir], True, path)
        except CorruptCheckpointError as e:
            if step is not None:
                raise
            log.warning("committed step %d shard %d failed verification "
                        "(%s); falling back", s, rank, e)
            _corrupt_skip_counter().inc()
            continue
        return s
    raise CorruptCheckpointError(
        f"every committed step under {path} failed shard verification "
        f"for rank {rank}")


# ---------------------------------------------------------------------------
# the periodic checkpoint listener
# ---------------------------------------------------------------------------
class CheckpointListener(TrainingListener):
    """Checkpoints during ``fit``: every ``save_every_n_iterations``
    iterations and / or every epoch, keeping the newest ``keep_last``.

    Iteration saves happen at dispatch boundaries
    (``on_dispatch_boundary``): with a cadence of N and K-step groups a
    save lands at the first boundary where ``iteration_count`` crossed
    the next multiple of N. ``async_save=True`` moves the write and the
    pruning onto a background writer (the fit waits for the snapshot
    only); a failed write shows on ``health()`` and never removes its
    predecessor (pruning runs after the new step is committed)."""

    def __init__(self, path: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_epoch: bool = False, keep_last: int = 3,
                 async_save: bool = False, max_pending: int = 2):
        if not save_every_n_iterations and not save_every_epoch:
            raise ValueError("set save_every_n_iterations and/or "
                             "save_every_epoch")
        self.path = path
        self.every_n = save_every_n_iterations
        self.every_epoch = save_every_epoch
        self.keep_last = max(1, keep_last)
        self.writer = AsyncCheckpointWriter(max_pending=max_pending) \
            if async_save else None
        self._last_saved_step: Optional[int] = None

    def on_dispatch_boundary(self, model):
        if not self.every_n:
            return
        step = model.iteration_count
        if step <= 0 or step == self._last_saved_step:
            return
        last = self._last_saved_step or 0
        if step // self.every_n > last // self.every_n:
            self._save(model, step)

    def on_epoch_end(self, model, epoch: int):
        if self.every_epoch and \
                model.iteration_count != self._last_saved_step:
            self._save(model, model.iteration_count)

    def _save(self, model, step: int):
        save_checkpoint(model, self.path, step=step, writer=self.writer)
        self._last_saved_step = step
        if self.writer is not None:
            # after the save, in the writer's order: a failed save never
            # evicts the predecessor it was to replace
            self.writer.submit(self._prune, label=f"prune@{step}",
                               is_save=False)
        else:
            self._prune()
        log.info("checkpoint saved at step %d (%s)", step, self.path)

    def _prune(self):
        for old in list_checkpoints(self.path)[:-self.keep_last]:
            delete_checkpoint(self.path, old)

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until the queued saves are durable (True when drained)."""
        return True if self.writer is None else self.writer.flush(timeout)

    def health(self) -> Dict[str, Any]:
        """The writer's health (a synchronous listener's save raises in
        the fit itself)."""
        if self.writer is None:
            return {"healthy": True, "pending": 0, "failures": 0,
                    "last_error": None}
        return self.writer.health()

    def close(self):
        """Drain the queued saves at the end of every fit (the writer
        serves the next fit, a restart's too)."""
        if self.writer is not None:
            self.writer.close()
