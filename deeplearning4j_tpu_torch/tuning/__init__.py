"""Execution-plan resolution (the part the ported CNN path uses)."""

from deeplearning4j_tpu_torch.tuning.plan import (  # noqa: F401
    EXECUTION_PLANS, apply_execution_plan)
