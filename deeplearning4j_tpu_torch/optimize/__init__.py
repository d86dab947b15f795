"""Optimization-adjacent utilities: the training listeners
(``listeners.py``) and the profiler listeners (``profiler.py``).
Counterpart of ``deeplearning4j_tpu/optimize/``; its solvers and
post-training quantization are not ported yet (ROADMAP.md)."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    CollectScoresIterationListener, ComposableIterationListener,
    EvaluativeListener, ParamAndGradientIterationListener,
    PerformanceListener, ScoreIterationListener, SleepyTrainingListener,
    TimeIterationListener, TrainingListener, close_listeners)
