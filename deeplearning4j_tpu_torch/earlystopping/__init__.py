"""Early stopping: termination conditions, model savers, score
calculators and the trainer's epoch loop.

Counterpart of ``deeplearning4j_tpu/earlystopping/``, with the same
exports (``core.py`` says what differs for mutable tensors).
"""

from deeplearning4j_tpu_torch.earlystopping.core import (  # noqa: F401
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    EarlyStoppingTrainer,
    # termination conditions
    MaxEpochsTerminationCondition,
    MaxTimeTerminationCondition,
    MaxScoreTerminationCondition,
    ScoreImprovementEpochTerminationCondition,
    InvalidScoreTerminationCondition,
    # savers
    InMemoryModelSaver,
    LocalFileModelSaver,
    # score calculators
    DataSetLossCalculator,
    ClassificationScoreCalculator,
)
