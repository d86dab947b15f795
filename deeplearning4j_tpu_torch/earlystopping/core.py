"""Early stopping.

Counterpart of ``deeplearning4j_tpu/earlystopping/core.py`` (itself the
equivalent of deeplearning4j-nn/.../earlystopping/*:
EarlyStoppingConfiguration, trainer/BaseEarlyStoppingTrainer.java:76-196
(epoch loop :100, saveBestModel :196), saver/ (LocalFile/InMemory),
scorecalc/ (DataSetLossCalculator), termination/ (MaxEpochs,
ScoreImprovementEpochs, MaxTime, MaxScore, InvalidScore)).

The termination conditions, the score calculators and the trainer's
epoch loop are the JAX package's. Two things differ because the port's
tensors are mutable:

- :func:`copy_model` clones every parameter, updater-state and layer
  state tensor on the network's device (the JAX package's host snapshot
  of immutable arrays shares nothing either). The port updates
  parameters in place (a ``steps_per_dispatch=K`` CUDA graph's replay,
  the optimizer's static trees), so a shallow copy would share them.
  The copy also drops the step graph and the cached compute-dtype and
  kernel-layout weights, and gets its own training generator at the
  source's state.
- :class:`LocalFileModelSaver` writes through the port's
  ``util/model_serializer.py`` and restores onto ``device`` (default
  ``"cuda"``, as every entry point).

The trainer calls ``model._fit_batch(ds)`` for each batch, as the JAX
trainer does: a truncated-BPTT network then trains each batch as one
sequence in both packages, since the tBPTT split lives in ``fit``'s loop
(ROADMAP.md §C). ``EarlyStoppingParallelTrainer`` waits for the parallel
package (ROADMAP.md A9).
"""

from __future__ import annotations

import copy
import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch


# ---------------------------------------------------------------------------
# termination conditions (ref: earlystopping/termination/*)
# ---------------------------------------------------------------------------


class EpochTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self):
        pass

    def terminate(self, iteration: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without improvement (ref:
    ScoreImprovementEpochTerminationCondition.java)."""

    def __init__(self, max_epochs_without_improvement: int, min_improvement: float = 0.0):
        self.max_no_improve = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.best = None
        self.since = 0

    def initialize(self):
        self.best = None
        self.since = 0

    def terminate(self, epoch, score):
        if self.best is None or self.best - score > self.min_improvement:
            self.best = score
            self.since = 0
            return False
        self.since += 1
        return self.since > self.max_no_improve


class MaxTimeTerminationCondition(IterationTerminationCondition,
                                  EpochTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self.start = None

    def initialize(self):
        self.start = time.time()

    def terminate(self, _i, _s):
        return (time.time() - self.start) > self.max_seconds


class MaxScoreTerminationCondition(IterationTerminationCondition,
                                   EpochTerminationCondition):
    """Abort if score exceeds a bound (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, _i, score):
        return score > self.max_score


class InvalidScoreTerminationCondition(IterationTerminationCondition,
                                       EpochTerminationCondition):
    def terminate(self, _i, score):
        return not np.isfinite(score)


# ---------------------------------------------------------------------------
# model savers (ref: earlystopping/saver/*)
# ---------------------------------------------------------------------------


class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self.latest = None

    def save_best(self, model, score):
        self.best = (copy_model(model), score)

    def save_latest(self, model, score):
        self.latest = (copy_model(model), score)

    def get_best(self):
        return self.best[0] if self.best else None

    def get_latest(self):
        return self.latest[0] if self.latest else None


class LocalFileModelSaver:
    """Persist best/latest checkpoints to a directory
    (ref: LocalFileModelSaver.java); ``get_best`` / ``get_latest``
    restore onto ``device``."""

    def __init__(self, directory: str, device=None):
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)

    def _path(self, name):
        return os.path.join(self.directory, name)

    def save_best(self, model, score):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(model, self._path("bestModel.zip"))

    def save_latest(self, model, score):
        from deeplearning4j_tpu_torch.util.model_serializer import write_model
        write_model(model, self._path("latestModel.zip"))

    def get_best(self):
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        p = self._path("bestModel.zip")
        return restore_model(p, device=self.device) if os.path.exists(p) \
            else None

    def get_latest(self):
        from deeplearning4j_tpu_torch.util.model_serializer import restore_model
        p = self._path("latestModel.zip")
        return restore_model(p, device=self.device) if os.path.exists(p) \
            else None


def copy_model(model):
    """A copy of a network that shares no mutable tensor with it: every
    parameter, updater-state and layer-state tensor cloned on the
    network's device, no step graph, no cached compute-dtype or
    kernel-layout weights, its own listeners list and dispatch counts,
    and a training generator of its own at the source's state. The
    source may train on (in place, through its step graph) without
    changing what the copy computes."""
    from deeplearning4j_tpu_torch.nn.updater import tree_map

    def clone(t):
        return t.detach().clone() if torch.is_tensor(t) else t

    m2 = copy.copy(model)
    with torch.no_grad():
        m2.params = tree_map(clone, model.params)
        m2.updater_state = tree_map(clone, model.updater_state)
        m2.state = tree_map(clone, model.state)
    m2._step_graph = None
    m2._compute = None
    if hasattr(model, "_layouts"):
        m2._layouts = {}
    m2.listeners = list(model.listeners)
    m2.fit_dispatch = Counter(model.fit_dispatch)
    g = model._train_gen
    if g is not None:
        m2._train_gen = torch.Generator(device=g.device)
        m2._train_gen.set_state(g.get_state())
    return m2


# ---------------------------------------------------------------------------
# score calculators (ref: earlystopping/scorecalc/*)
# ---------------------------------------------------------------------------


class DataSetLossCalculator:
    """Average loss over a validation iterator (ref: DataSetLossCalculator.java)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total, n = 0.0, 0
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / n if (self.average and n) else total


class ClassificationScoreCalculator:
    """1 - accuracy so that lower is better (ref: ClassificationScoreCalculator)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model) -> float:
        e = model.evaluate(self.iterator)
        return 1.0 - e.accuracy()


# ---------------------------------------------------------------------------
# configuration + trainer (ref: EarlyStoppingConfiguration / BaseEarlyStoppingTrainer)
# ---------------------------------------------------------------------------


@dataclass
class EarlyStoppingConfiguration:
    epoch_termination_conditions: List[EpochTerminationCondition] = field(
        default_factory=list)
    iteration_termination_conditions: List[IterationTerminationCondition] = field(
        default_factory=list)
    score_calculator: Any = None
    model_saver: Any = field(default_factory=InMemoryModelSaver)
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1


@dataclass
class EarlyStoppingResult:
    termination_reason: str
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: Any


class EarlyStoppingTrainer:
    """Epoch loop with termination checks (ref: BaseEarlyStoppingTrainer.fit
    :100)."""

    def __init__(self, config: EarlyStoppingConfiguration, model, train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def _fit_epoch(self):
        """Train one epoch with per-iteration termination checks. Returns
        (aborted, condition_name) — subclasses override just this
        (EarlyStoppingParallelTrainer trains across the mesh)."""
        for ds in self.train_iterator:
            self.model._fit_batch(ds) if hasattr(self.model, "_fit_batch") \
                else self.model.fit(ds)
            s = self.model.score_value
            for c in self.config.iteration_termination_conditions:
                if c.terminate(self.model.iteration_count, s):
                    return True, type(c).__name__
        return False, None

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()
        best_score, best_epoch = None, -1
        scores = {}
        epoch = 0
        reason, details = "MaxEpochs", ""
        while True:
            aborted, details_ = self._fit_epoch()
            if aborted:
                reason = "IterationTerminationCondition"
                details = details_
                break
            # score on validation
            if cfg.score_calculator is not None and \
                    epoch % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.model)
            else:
                score = self.model.score_value
            scores[epoch] = score
            if best_score is None or score < best_score:
                best_score, best_epoch = score, epoch
                cfg.model_saver.save_best(self.model, score)
            if cfg.save_last_model:
                cfg.model_saver.save_latest(self.model, score)
            term = False
            for c in cfg.epoch_termination_conditions:
                if c.terminate(epoch, score):
                    reason = "EpochTerminationCondition"
                    details = type(c).__name__
                    term = True
                    break
            if term:
                break
            epoch += 1
        return EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None else float("nan"),
            score_vs_epoch=scores,
            best_model=cfg.model_saver.get_best(),
        )
