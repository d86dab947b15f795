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

:func:`modeled_train_step_traffic` is the JAX package's per-step traffic
model over the fusable chains (plain Python over ``fusion_candidates``).

The serving twin, :func:`resolve_kv_dtype`, resolves
``PagedKVConfig(kv_dtype="auto")`` from the store's
``paged_decode_quant`` entry (:func:`quant_key_for_engine`). The decode
impl's resolver (``resolve_decode_impl``) is not ported: the port has
one read path on the card (ROADMAP.md A7).
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.tuning.crossover import (
    KernelCrossoverStore, bottleneck_fingerprint, default_store,
    quant_fingerprint, stem_fingerprint)

__all__ = ["EXECUTION_PLANS", "apply_execution_plan",
           "modeled_train_step_traffic", "quant_key_for_engine",
           "resolve_kv_dtype"]

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
    if not hasattr(net, "set_fusion"):
        # a sequential network: the plan validates, but its layers have
        # no fused chains (those are graph features), so every plan runs
        # the layers as they are
        return {"plan": plan, "level": False, "blocks": 0, "stem": False,
                "keys": {}}
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


def resolve_kv_dtype(eligible: bool, key: str, *,
                     store: Optional[KernelCrossoverStore] = None,
                     device=None) -> str:
    """``kv_dtype="auto"`` for the int8 KV page pool. ``eligible`` is the
    engine's static gate (a pure-attention streaming state): int8 can
    serve the net; only a measurement on ``device``'s kind of card says
    it should. Uncalibrated, mismatched (another platform or device
    kind) or stale entries stay bf16: quantization trades accuracy, so
    it is opted into by a measured win ("kernel" = the int8 leg
    faster)."""
    if not eligible:
        return "bf16"
    store = default_store() if store is None else store
    return ("int8" if store.choose(key, default="fallback", device=device)
            == "kernel" else "bf16")


def quant_key_for_engine(page_size: int, head_dim: int, n_kv_heads: int,
                         cache_length: int, dtype) -> str:
    return quant_fingerprint(page_size, head_dim, n_kv_heads, cache_length,
                             dtype)


# ---------------------------------------------------------------------
# the per-step traffic model (the JAX package's accounting)
# ---------------------------------------------------------------------
#: tensor traversals per stage output per train step: the xla plan
#: writes a conv output, reads it for the BN statistics, reads and
#: writes it to normalize, reads it in the next conv, and reads the
#: statistics' and elementwise tensors again in the backward (~14 per
#: bottleneck, ~4.7 per stage tensor); the fused plan 1 write and 1 read
#: forward, 3 reads and 1 write backward per stage (~8 per bottleneck)
_XLA_TRAVERSALS = 14 / 3.0
_FUSED_TRAVERSALS = 8 / 3.0
#: the stem's 112x112x64 activation: the xla plan's conv write, stats
#: read, normalize read and write, pool read forward and ~3 backward
#: reads; the fused stem's conv write and one output-stage read forward,
#: the recompute read and dy write and read backward
_XLA_STEM_TRAVERSALS = 8.0
_FUSED_STEM_TRAVERSALS = 4.0


def modeled_train_step_traffic(net, batch_size: int) -> dict:
    """A per-step model of the bytes moved across the BN and elementwise
    tensors of the net's fusable chains, under the xla plan and under the
    fused plan: a consistent accounting of the traffic a plan removes,
    not a simulator. ``{xla_bytes, fused_bytes, blocks, stems}``."""
    bpe = 2 if _net_dtype(net) in ("bfloat16", "bf16") else 4
    bcands, scands = net.fusion_candidates()
    xla = fused = 0.0
    for grp in bcands.values():
        s = grp.get("stride", 1)
        ho, wo = grp["h"] // s, grp["w"] // s
        stage = batch_size * ho * wo * bpe
        tensors = stage * (grp["cmid"] * 2 + grp["cout"]
                           * (2 if "conv_skip" in grp else 1))
        xla += tensors * _XLA_TRAVERSALS
        fused += tensors * _FUSED_TRAVERSALS
    for grp in scands.values():
        ho, wo = (grp["h"] - 1) // 2 + 1, (grp["w"] - 1) // 2 + 1
        y = batch_size * ho * wo * grp["cout"] * bpe
        xla += y * _XLA_STEM_TRAVERSALS
        fused += y * _FUSED_STEM_TRAVERSALS
    return {"xla_bytes": int(xla), "fused_bytes": int(fused),
            "blocks": len(bcands), "stems": len(scands)}
