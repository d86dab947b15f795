"""Execution-plan resolution.

Counterpart of ``deeplearning4j_tpu/tuning/plan.py``
``apply_execution_plan``:

- ``"xla"``: the unfused graph (every vertex on its own: PyTorch's
  convolutions and pooling);
- ``"fused"``: every eligible bottleneck chain runs the bottleneck
  kernels (``nn/layers/bottleneck.py``); the space-to-depth stem
  (``nn/layers/stem.py``) engages too iff the kernel-crossover store
  (``tuning/crossover.py``) holds a measured verdict, on the net's
  device, that it wins;
- ``"auto"``: per shape from the store: each candidate block, and the
  stem, runs its kernels only where a usable entry says the kernel wins.
  Uncalibrated (or mismatched) entries resolve to the fallback, so
  "auto" on an uncalibrated store is the "xla" plan.
  ``tuning/calibrate.py`` fills the store.

Both serve ``ComputationGraph.output`` and ``fit`` (which resolves its
``execution_plan=`` here once per call): a fused block or stem trains
through its backward kernels. ``set_fusion`` applies the plan with
change detection, so resolving the same plan again changes nothing.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.tuning.crossover import (
    KernelCrossoverStore, bottleneck_fingerprint, default_store,
    stem_fingerprint)

__all__ = ["EXECUTION_PLANS", "apply_execution_plan"]

EXECUTION_PLANS = ("auto", "fused", "xla")


def _net_dtype(net) -> str:
    return getattr(net.conf, "dtype", None) or "float32"


def _block_key(group: dict, dtype: str) -> str:
    return bottleneck_fingerprint(
        group["h"], group["w"], group["cin"], group["cmid"], group["cout"],
        group.get("stride", 1), "conv_skip" in group, dtype)


def _stem_key(group: dict, dtype: str) -> str:
    return stem_fingerprint(group["h"], group["w"], group["cin"],
                            group["cout"], dtype)


def apply_execution_plan(net, plan: Optional[str], *,
                         store: Optional[KernelCrossoverStore] = None
                         ) -> Optional[dict]:
    """Resolve ``plan`` onto ``net`` against ``store`` (default
    :func:`~deeplearning4j_tpu_torch.tuning.crossover.default_store`),
    its entries read for ``net.device``. Returns the resolution record
    ``{plan, level, blocks, stem, keys}`` (``keys``: each consulted
    candidate's ``{key, choice}``), or None when plan is None (the net's
    current plan stays)."""
    if plan is None:
        return None
    if plan not in EXECUTION_PLANS:
        raise ValueError(f"execution_plan must be one of {EXECUTION_PLANS}, "
                         f"got {plan!r}")
    if plan == "xla":
        net.set_fusion(False)
        return {"plan": plan, "level": False, "blocks": 0, "stem": False,
                "keys": {}}
    store = default_store() if store is None else store
    dtype = _net_dtype(net)
    bcands, scands = net.fusion_candidates()
    keys = {}
    if plan == "fused":
        chosen, only = set(bcands), None
    else:
        chosen = set()
        for name, grp in bcands.items():
            key = _block_key(grp, dtype)
            choice = store.choose(key, default="fallback",
                                  device=net.device)
            keys[name] = {"key": key, "choice": choice}
            if choice == "kernel":
                chosen.add(name)
        only = frozenset(chosen)
    # the stem is store-gated under both plans, as in the JAX package
    stem_on = False
    for name, grp in scands.items():
        key = _stem_key(grp, dtype)
        choice = store.choose(key, default="fallback", device=net.device)
        keys[name] = {"key": key, "choice": choice}
        stem_on = stem_on or choice == "kernel"
    if not chosen and not stem_on:
        net.set_fusion(False)
        return {"plan": plan, "level": False, "blocks": 0, "stem": False,
                "keys": keys}
    net.set_fusion("bottleneck", stem=stem_on, only=only)
    return {"plan": plan, "level": "bottleneck", "blocks": len(chosen),
            "stem": stem_on, "keys": keys}
