"""Serving: continuous-batching generation behind admission control.

A ``GenerationEngine`` owns a fixed S-slot streaming-state arena (an
attention KV cache or an LSTM's h / c), admits requests into free slots
mid-flight, advances every active slot with one decode forward per
step, retires each request individually and streams tokens back through
``GenerationStream`` handles. With ``PagedKVConfig`` the KV storage is a
refcounted page pool with a prefix cache, and decode reads it through
the page table with the hand-written CUDA paged-attention kernel; with
``PagedKVConfig(kv_dtype="int8")`` the pool is int8 under per-page
power-of-two scales (``serving/quant.py``), primed through the pool and
read by the hand-written int8 paged-decode kernel. With
``SpeculationConfig`` each step verifies host-drafted tokens in one
widened forward (the paged kernels at query width 1 + gamma) and
commits every accepted one.

The survivability layer keeps it up under faults and load:
``EngineSupervisor`` (request-preserving arena rebuilds from the
host-side ledger, budgeted restarts, escalation to fail-all),
``OverloadConfig`` / ``OverloadController`` (SLO-breach shedding,
deadline-based early rejection, the page-pressure brownout ladder) and
``GenerationEngine.drain()``. ``RequestLedgerEntry`` is the supervisor's
rebuild payload in the JAX package's wire form; ``RequestTrace`` records
each request's lifecycle. The fleet (``serving/fleet``) comes later
(ROADMAP.md A10).
"""

from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    GenerationEngine, SpeculationConfig)
from deeplearning4j_tpu_torch.serving.errors import (  # noqa: F401
    EngineShutdown, InferenceTimeout, RequestCancelled, ServingOverloaded,
    ServingQueueFull)
from deeplearning4j_tpu_torch.serving.overload import (  # noqa: F401
    OverloadConfig, OverloadController)
from deeplearning4j_tpu_torch.serving.paging import (  # noqa: F401
    PagedKVConfig, PageExhausted, PagePool)
from deeplearning4j_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PrefixCache)
from deeplearning4j_tpu_torch.serving.request import (  # noqa: F401
    GenerationRequest, GenerationStream, LEDGER_VERSION,
    RequestLedgerEntry, RequestTrace, ttft_attribution)
from deeplearning4j_tpu_torch.serving.scheduler import (  # noqa: F401
    AdmissionQueue, QueueSnapshot)
from deeplearning4j_tpu_torch.serving.supervisor import (  # noqa: F401
    EngineSupervisor)

__all__ = ["AdmissionQueue", "EngineShutdown", "EngineSupervisor",
           "GenerationEngine", "GenerationRequest", "GenerationStream",
           "InferenceTimeout", "LEDGER_VERSION", "OverloadConfig",
           "OverloadController", "PagedKVConfig", "PageExhausted",
           "PagePool", "PrefixCache", "QueueSnapshot", "RequestCancelled",
           "RequestLedgerEntry", "RequestTrace", "ServingOverloaded",
           "ServingQueueFull", "SpeculationConfig", "ttft_attribution"]
