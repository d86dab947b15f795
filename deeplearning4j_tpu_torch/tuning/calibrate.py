"""The calibration harness: fill the kernel-crossover store from
measurements on the card.

Counterpart of ``deeplearning4j_tpu/tuning/calibrate.py``.
``calibrate_training_kernels(net)`` walks the net's fusion candidates
(every distinct bottleneck-block shape and the stem), builds seeded
tensors at each shape on the net's device in its compute dtype, and
times the fused kernels' training step against the unfused reference of
the same semantics: forward and backward through autograd, the gradients
with respect to the input and the weights, the device synchronized
(``crossover._time_thunk``). Each paired measurement is recorded into
the store, stamped with the net's device, and every later
``execution_plan="auto"`` (or the stem's verdict under ``"fused"``) on
that kind of card reads it. On the CPU the kernels' plain versions run:
the entries are stamped ``cpu`` and never decide a run on the card.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.tuning.crossover import (
    KernelCrossoverStore, default_store)
from deeplearning4j_tpu_torch.tuning.plan import (
    _block_key, _net_dtype, _stem_key)

__all__ = ["calibrate_training_kernels"]

log = logging.getLogger(__name__)


def calibrate_training_kernels(
        net, *, batch_size: int = 8,
        store: Optional[KernelCrossoverStore] = None, warmup: int = 1,
        iters: int = 3, persist: bool = False,
        include_stem: bool = True) -> dict:
    """Measure kernel against fallback for every distinct fusable shape
    of ``net`` at ``batch_size`` and record the results into ``store``
    (default: the process's store); ``persist`` saves it. Returns
    ``{key: entry}``."""
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
        BnParams, fused_bottleneck, reference_bottleneck)
    from deeplearning4j_tpu_torch.nn.layers.stem import (
        fused_stem, reference_stem)

    store = default_store() if store is None else store
    dtype = _net_dtype(net)
    tdt = torch.bfloat16 if dtype in ("bfloat16", "bf16") else torch.float32
    dev = net.device
    bcands, scands = net.fusion_candidates()
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev, tdt).requires_grad_()

    def bn_of(c):
        return BnParams(gamma=torch.ones(c, dtype=tdt, device=dev),
                        beta=torch.zeros(c, dtype=tdt, device=dev),
                        running_mean=torch.zeros(c, device=dev),
                        running_var=torch.ones(c, device=dev))

    def step(fn, leaves, **kw):
        """A thunk: the forward of ``fn`` and the gradients of the summed
        output with respect to ``leaves``."""
        def thunk():
            out, _ = fn(**kw)
            return torch.autograd.grad(out.float().sum(), leaves)
        return thunk

    results = {}
    seen = set()
    for grp in bcands.values():
        key = _block_key(grp, dtype)
        if key in seen:
            continue
        seen.add(key)
        cin, cmid, cout = grp["cin"], grp["cmid"], grp["cout"]
        has_skip = "conv_skip" in grp
        x = arr(batch_size, grp["h"], grp["w"], cin)
        wa = arr(cin, cmid, scale=0.1)
        wb = arr(9, cmid, cmid, scale=0.05)
        wc = arr(cmid, cout, scale=0.1)
        ws = arr(cin, cout, scale=0.1) if has_skip else None
        bns = (bn_of(cmid), bn_of(cmid), bn_of(cout))
        leaves = [t for t in (x, wa, wb, wc, ws) if t is not None]
        kw = dict(x=x, wa=wa, bn_a=bns[0], wb=wb, bn_b=bns[1], wc=wc,
                  bn_c=bns[2], w_skip=ws,
                  bn_skip=bn_of(cout) if has_skip else None,
                  stride=grp.get("stride", 1), train=True)
        results[key] = store.calibrate(
            key, step(fused_bottleneck, leaves, **kw),
            step(reference_bottleneck, leaves, **kw), device=dev,
            warmup=warmup, iters=iters)
        log.info("calibrated %s: kernel %.3fms vs fallback %.3fms", key,
                 results[key]["kernel_ms"], results[key]["fallback_ms"])
    if include_stem:
        for grp in scands.values():
            key = _stem_key(grp, dtype)
            if key in seen:
                continue
            seen.add(key)
            x = arr(batch_size, grp["h"], grp["w"], grp["cin"])
            w7 = arr(grp["cout"], grp["cin"], 7, 7, scale=0.1)
            kw = dict(x=x, w=w7, bn=bn_of(grp["cout"]), train=True)
            results[key] = store.calibrate(
                key, step(fused_stem, [x, w7], **kw),
                step(reference_stem, [x, w7], **kw), device=dev,
                warmup=warmup, iters=iters)
            log.info("calibrated %s: kernel %.3fms vs fallback %.3fms", key,
                     results[key]["kernel_ms"], results[key]["fallback_ms"])
    if persist and results:
        try:
            store.save()
        except OSError as e:
            # the measurements stay in the returned and in-memory store
            log.warning("kernel-crossover store not persisted to %s (%s); "
                        "pass a writable KernelCrossoverStore(path=...)",
                        store.path, e)
    return results
