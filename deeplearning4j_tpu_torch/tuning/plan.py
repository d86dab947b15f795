"""Execution-plan resolution.

Counterpart of ``deeplearning4j_tpu/tuning/plan.py``
``apply_execution_plan``, for the plans this port can resolve:

- ``"xla"``: the unfused graph (every vertex on its own: PyTorch's
  convolutions and pooling);
- ``"fused"``: every eligible bottleneck chain runs the bottleneck
  kernels (``nn/layers/bottleneck.py``). The space-to-depth stem stays
  off, as the JAX package leaves it on an uncalibrated crossover store
  (only a measured verdict engages it there); ``set_fusion("bottleneck",
  stem=True)`` engages it by hand.

Both serve ``ComputationGraph.output`` and ``fit`` (which resolves its
``execution_plan=`` here once per call): a fused block trains through
the bottleneck's backward kernels.

``"auto"`` resolves per shape from the measured kernel-crossover store
(``tuning/crossover.py``, ``tuning/calibrate.py``), which is not ported
yet (ROADMAP.md A4). ``set_fusion`` applies the plan with change
detection, so resolving the same plan again changes nothing.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["EXECUTION_PLANS", "apply_execution_plan"]

EXECUTION_PLANS = ("auto", "fused", "xla")


def apply_execution_plan(net, plan: Optional[str]) -> Optional[dict]:
    """Resolve ``plan`` onto ``net``. Returns the resolution record
    ``{plan, level, blocks, stem}``, or None when plan is None (the
    net's current plan stays)."""
    if plan is None:
        return None
    if plan not in EXECUTION_PLANS:
        raise ValueError(f"execution_plan must be one of {EXECUTION_PLANS}, "
                         f"got {plan!r}")
    if plan == "auto":
        raise NotImplementedError(
            "execution_plan='auto' (per-shape resolution from the measured "
            "kernel-crossover store) is not ported yet (ROADMAP.md A4)")
    if plan == "xla":
        net.set_fusion(False)
        return {"plan": plan, "level": False, "blocks": 0, "stem": False}
    bcands, _ = net.fusion_candidates()
    if not bcands:
        net.set_fusion(False)
        return {"plan": plan, "level": False, "blocks": 0, "stem": False}
    net.set_fusion("bottleneck", stem=False)
    return {"plan": plan, "level": "bottleneck", "blocks": len(bcands),
            "stem": False}
