"""The calibration harness: fill the kernel-crossover store from
measurements on the card.

Counterpart of ``deeplearning4j_tpu/tuning/calibrate.py``.
``calibrate_training_kernels(net)`` walks the net's fusion candidates
(every distinct bottleneck-block shape and the stem), builds seeded
tensors at each shape on the net's device in its compute dtype, and
times the fused kernels' training step against the step of the plan
the kernels would replace: forward and backward through autograd, the
gradients with respect to the input and the weights, the device
synchronized (``crossover._time_thunk``). Each paired measurement is
recorded into the store, stamped with the net's device, and every later
``execution_plan="auto"`` (or the stem's verdict under ``"fused"``) on
that kind of card reads it. On the CPU the kernels' plain versions run:
the entries are stamped ``cpu`` and never decide a run on the card.

The fallback is timed as the xla plan's own layers compute the block
(:func:`xla_plan_bottleneck`, :func:`xla_plan_stem`: the
``ConvolutionLayer`` convolutions in the net's dtype on NHWC tensors,
which PyTorch runs channels-last through cuDNN, ``BatchNormalization`` in
training mode, the relu and the residual add). The JAX package times
``jax.jit(jax.grad(reference_bottleneck))``, which XLA compiles into the
same code its xla plan runs; the port's ``reference_bottleneck`` is an
eager chain of f32 einsums and stands for no plan, so timing it made
"auto" fuse blocks that lose to the xla plan (ROADMAP.md C1).
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

__all__ = ["calibrate_training_kernels", "oihw_weights",
           "xla_plan_bottleneck", "xla_plan_stem"]

log = logging.getLogger(__name__)


def _conv_bn(x, w, bn, *, stride, pad, relu, train):
    """One conv -> BN (-> relu) chain of the ResNet50 graph on the xla
    plan, through its own layers (NHWC, no bias). Returns ``(y, (new
    running mean, new running var))``."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        ActivationLayer, BatchNormalization, ConvolutionLayer)
    conv = ConvolutionLayer(n_out=w.shape[0], kernel=tuple(w.shape[2:]),
                            stride=(stride, stride), padding=(pad, pad),
                            has_bias=False, data_format="NHWC")
    y, _ = conv.apply({"W": w}, x, {})
    y, st = BatchNormalization(data_format="NHWC").apply(
        {"gamma": bn.gamma, "beta": bn.beta},
        y, {"mean": bn.running_mean, "var": bn.running_var}, train=train)
    if relu:
        y, _ = ActivationLayer(activation="relu").apply({}, y, {})
    return y, (st["mean"], st["var"])


def xla_plan_bottleneck(x, wa, bn_a, wb, bn_b, wc, bn_c, *, train,
                        w_skip=None, bn_skip=None, stride=1):
    """A bottleneck block as the xla plan's layers compute it: x NHWC,
    the conv weights OIHW as the graph keeps them (``wa`` ``[cmid, cin,
    1, 1]``, ``wb`` ``[cmid, cmid, 3, 3]``, ``wc`` ``[cout, cmid, 1,
    1]``, ``w_skip`` ``[cout, cin, 1, 1]``), the stride on conv_a and the
    shortcut. The same semantics as ``reference_bottleneck``; returns
    ``(out, new running stats)`` in its order."""
    kw = dict(train=train)
    y, ra = _conv_bn(x, wa, bn_a, stride=stride, pad=0, relu=True, **kw)
    y, rb = _conv_bn(y, wb, bn_b, stride=1, pad=1, relu=True, **kw)
    y, rc = _conv_bn(y, wc, bn_c, stride=1, pad=0, relu=False, **kw)
    stats = (*ra, *rb, *rc)
    if w_skip is not None:
        shortcut, rs = _conv_bn(x, w_skip, bn_skip, stride=stride, pad=0,
                                relu=False, **kw)
        stats = stats + rs
    else:
        shortcut = x
    return torch.relu(y + shortcut), stats


def xla_plan_stem(x, w, bn, *, train):
    """The ResNet50 stem as the xla plan's layers compute it: zero
    padding 3, the 7x7/2 conv (w OIHW), BN, relu, the 3x3/2 pad-1 max
    pool, on NHWC x. Returns ``(out, (new running mean, var))``."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        SubsamplingLayer, ZeroPaddingLayer)
    xp, _ = ZeroPaddingLayer(padding=(3, 3, 3, 3),
                             data_format="NHWC").apply({}, x, {})
    y, stats = _conv_bn(xp, w, bn, stride=2, pad=0, relu=True, train=train)
    out, _ = SubsamplingLayer(pooling_type="max", kernel=(3, 3),
                              stride=(2, 2), padding=(1, 1),
                              data_format="NHWC").apply({}, y, {})
    return out, stats


def oihw_weights(wa, wb, wc, w_skip=None):
    """The fused block's weights (``wa`` ``[cin, cmid]``, ``wb`` ``[9,
    cmid, cmid]`` tap-major, ``wc``, ``w_skip``) in the graph's OIHW
    layout, contiguous: the xla plan's parameters of the same block."""
    def one(w):
        return w.t()[:, :, None, None].contiguous()
    c_in, c_out = wb.shape[1:]
    wb4 = wb.reshape(3, 3, c_in, c_out).permute(3, 2, 0, 1).contiguous()
    return (one(wa), wb4, one(wc),
            one(w_skip) if w_skip is not None else None)


def calibrate_training_kernels(
        net, *, batch_size: int = 128,
        store: Optional[KernelCrossoverStore] = None, warmup: int = 1,
        iters: int = 3, persist: bool = False,
        include_stem: bool = True) -> dict:
    """Measure kernel against fallback for every distinct fusable shape
    of ``net`` at ``batch_size`` and record the results into ``store``
    (default: the process's store); ``persist`` saves it. Returns
    ``{key: entry}``.

    Calibrate at the batch ``fit`` trains at (the default is the
    ResNet50 training step's, ``bench_all.py``'s 128; the JAX harness
    takes 8, where a compiled step keeps the device busy). An eager
    PyTorch step at a small batch measures the host's launches, not the
    device: at B=8 on an H100 both sides of every block took 4-7 ms
    and the fused side, with fewer launches, won 8 of 9 keys, while the
    plan they chose trained at 357 ms a step against the xla plan's 188
    at B=128 (``chip_smoke.py`` auto plan phase, on an H100 80GB HBM3
    at 700 W; PERF.md)."""
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import (
        BnParams, fused_bottleneck)
    from deeplearning4j_tpu_torch.nn.layers.stem import fused_stem

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

    def leaf(t):
        return t.detach().requires_grad_() if t is not None else None

    def record(key, kernel, fallback):
        results[key] = store.calibrate(key, kernel, fallback, device=dev,
                                       warmup=warmup, iters=iters)
        log.info("calibrated %s: kernel %.3fms vs fallback %.3fms", key,
                 results[key]["kernel_ms"], results[key]["fallback_ms"])

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
        bns = dict(bn_a=bn_of(cmid), bn_b=bn_of(cmid), bn_c=bn_of(cout),
                   bn_skip=bn_of(cout) if has_skip else None,
                   stride=grp.get("stride", 1), train=True)
        fused = [t for t in (x, wa, wb, wc, ws) if t is not None]
        xla = [leaf(t) for t in (x, *oihw_weights(wa, wb, wc, ws))]
        record(key,
               step(fused_bottleneck, fused, x=x, wa=wa, wb=wb, wc=wc,
                    w_skip=ws, **bns),
               step(xla_plan_bottleneck, [t for t in xla if t is not None],
                    **dict(zip(("x", "wa", "wb", "wc", "w_skip"), xla)),
                    **bns))
    if include_stem:
        for grp in scands.values():
            key = _stem_key(grp, dtype)
            if key in seen:
                continue
            seen.add(key)
            x = arr(batch_size, grp["h"], grp["w"], grp["cin"])
            w7 = arr(grp["cout"], grp["cin"], 7, 7, scale=0.1)
            bn = bn_of(grp["cout"])
            xl, wl = leaf(x), leaf(w7)
            record(key,
                   step(fused_stem, [x, w7], x=x, w=w7, bn=bn, train=True),
                   step(xla_plan_stem, [xl, wl], x=xl, w=wl, bn=bn,
                        train=True))
    if persist and results:
        try:
            store.save()
        except OSError as e:
            # the measurements stay in the returned and in-memory store
            log.warning("kernel-crossover store not persisted to %s (%s); "
                        "pass a writable KernelCrossoverStore(path=...)",
                        store.path, e)
    return results
