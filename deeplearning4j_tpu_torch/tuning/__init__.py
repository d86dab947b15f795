"""Execution plans and the measured kernel-crossover store: ``plan``
resolves ``execution_plan="auto" | "fused" | "xla"`` and
``PagedKVConfig(kv_dtype="auto")``, ``crossover`` keeps the
kernel-vs-fallback timings they read, ``calibrate`` measures the
training kernels'."""

from deeplearning4j_tpu_torch.tuning.calibrate import (  # noqa: F401
    calibrate_training_kernels)
from deeplearning4j_tpu_torch.tuning.crossover import (  # noqa: F401
    CROSSOVER_NAME, IMPL_REVS, KernelCrossoverStore, bottleneck_fingerprint,
    decode_fingerprint, default_store, fingerprint, quant_fingerprint,
    reset_default_store, stem_fingerprint, winner)
from deeplearning4j_tpu_torch.tuning.plan import (  # noqa: F401
    EXECUTION_PLANS, apply_execution_plan, quant_key_for_engine,
    resolve_kv_dtype)

__all__ = [
    "CROSSOVER_NAME", "EXECUTION_PLANS", "IMPL_REVS", "KernelCrossoverStore",
    "apply_execution_plan", "bottleneck_fingerprint",
    "calibrate_training_kernels", "decode_fingerprint", "default_store",
    "fingerprint", "quant_fingerprint", "quant_key_for_engine",
    "reset_default_store", "resolve_kv_dtype", "stem_fingerprint", "winner",
]
