"""Serving: continuous-batching generation behind admission control.

A ``GenerationEngine`` owns a fixed S-slot streaming-state arena, admits
requests into free slots mid-flight, advances every active slot with
one decode forward per step, retires each request individually and
streams tokens back through ``GenerationStream`` handles. With
``PagedKVConfig`` the KV storage is a refcounted page pool with a
prefix cache, and decode reads it through the page table with the
hand-written CUDA paged-attention kernel; with
``PagedKVConfig(kv_dtype="int8")`` the pool is int8 under per-page
power-of-two scales (``serving/quant.py``), primed through the pool and
read by the hand-written int8 paged-decode kernel. With
``SpeculationConfig`` each step verifies host-drafted tokens in one
widened forward (the paged kernels at query width 1 + gamma) and
commits every accepted one.
"""

from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    GenerationEngine, SpeculationConfig)
from deeplearning4j_tpu_torch.serving.errors import (  # noqa: F401
    EngineShutdown, InferenceTimeout, RequestCancelled, ServingQueueFull)
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    PagedKVConfig, PageExhausted, PagePool)
from deeplearning4j_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PrefixCache)
from deeplearning4j_tpu_torch.serving.request import (  # noqa: F401
    GenerationRequest, GenerationStream)
from deeplearning4j_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmissionQueue)

__all__ = ["AdmissionQueue", "EngineShutdown", "GenerationEngine",
           "GenerationRequest", "GenerationStream", "InferenceTimeout",
           "PagedKVConfig", "PageExhausted", "PagePool", "PrefixCache",
           "RequestCancelled", "ServingQueueFull", "SpeculationConfig"]
