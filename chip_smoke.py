#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits nonzero):

1. device: the card's name, power limit and top SM clock (nvidia-smi);
2. build: both CUDA kernel libraries (paged attention, flash attention)
   from the sources in the checkout, one nvcc each, started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, with the kernel's, the plain
   version's and a library call's times (CUDA events, L2 flushed before
   each launch) beside the kernel's bound. Paged decode: the engine and
   GQA/verify shapes, bf16 and f32. Flash forward, dq and dk/dv: the
   training shape (B=4, H=8, T=8192, D=64, bf16, causal), then f32
   causal, cross attention with Tq != Tk, a key mask with one fully
   masked row, and a T that is no tile multiple; each output held to
   limits relative to each row's and each 64-row tile's own size, and
   in bf16 shown to tell apart a kernel that dropped its rounding
   points;
4. serve: the serving path at full width: the rope
   TextGenerationTransformer (vocab 2048, width 512, 8 heads, 6 layers,
   max_length 1024, bf16) behind the paged GenerationEngine (8 slots,
   page size 16, prefix cache) answering 16 requests of 128 new tokens;
   every decode dispatch must launch the paged kernel in every layer;
5. profile: 20 decode steps of the same configuration with all slots
   busy, timed with the kernel, with its plain version swapped in, with
   torch's fused gelu and softmax swapped in (one rounding each, not the
   JAX package's), and with everything as shipped again; then
   ``torch.profiler`` over 20 more (device busy share, launches and the
   top kernels per step);
6. reference: in f32 with 2 layers at the same width, the engine's
   greedy streams equal one-shot ``sample_stream``'s;
7. train: the training path at full width: the learned-position
   TextGenerationTransformer of bench_all.py's transformer_train_T8192
   (vocab 256, width 512, 8 heads, 6 layers, max_length 8192, Adam(3e-4),
   bf16) through ``net.fit`` on one fixed batch of 4 x 8192 tokens: one
   warm-up step, then 5 timed steps; the loss must be finite and fall,
   and each flash kernel must launch 6 times per step;
8. train reference: in f32 with 2 layers at the same width and T=1024,
   two Adam steps with the kernels and two with their plain versions
   swapped in give the same parameters;
9. train profile: one training step under ``torch.profiler`` (device
   busy share, launches per step, the top kernels).

The last lines are the ``kernels`` JSON, the nvidia-smi line and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits nonzero and prints no result. ``--json`` also writes every
measurement to PATH.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: exp2 results per clock per SM on compute capability 9.0 (CUDA C++
#: Programming Guide, arithmetic instruction throughput table); times
#: the SM count and the card's top SM clock it bounds the exponentials
EXP2_PER_CLOCK_PER_SM = 16
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}   # paged decode
# Flash kernels against their plain versions, per output, by
# flash_attention.agreement (each row's error over that row's largest
# |plain|; each 64-row tile's summed error over its summed |plain|):
# bf16 rows within two ulps of their largest element; bf16 tiles of dq,
# dk, dv within FLASH_TILE (they round the same p and ds as the plain
# versions: ~1e-6 apart, where leaving a rounding point out gives
# ~1e-3); the forward's online softmax rounds p against each key tile's
# running max, not the row's, so its o sits ~1e-3 from the plain
# version's and at least FLASH_UNROUNDED from the forward without its
# rounding point. f32 (sums in other orders only): rows within 1e-3,
# tiles within 1e-5. lse (f32) within 2e-5 absolute.
FLASH_ROW = {torch.bfloat16: 2 ** -6, torch.float32: 1e-3}
FLASH_TILE = {(torch.bfloat16, "o"): 4e-3, (torch.bfloat16, "grad"): 1e-4,
              (torch.float32, "o"): 1e-5, (torch.float32, "grad"): 1e-5}
FLASH_UNROUNDED = 1e-4
FLASH_LSE = 2e-5

# the served model and engine (bench_all.py's widest served transformer)
VOCAB, WIDTH, HEADS, LAYERS, MAX_LEN = 2048, 512, 8, 6, 1024
SLOTS, PAGE = 8, 16
N_REQUESTS, NEW_TOKENS, SYSTEM_PREFIX = 16, 128, 64

# the trained model (bench_all.py's transformer_train_T8192)
TRAIN_VOCAB, TRAIN_T, TRAIN_B, TRAIN_STEPS = 256, 8192, 4, 5


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line(query="name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def exp2_per_s(device) -> float:
    """The card's exp2 rate: the SFU's results per clock per SM, times
    the SMs, times the top SM clock nvidia-smi reports."""
    mhz = float(nvidia_smi_line("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return EXP2_PER_CLOCK_PER_SM * sms * mhz * 1e6


def kernel_counters():
    """Every kernel's launch counter, by the name the kernels line
    uses."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION)
    return {"paged_attention": PAGED_ATTENTION, "flash_fwd": fa.FLASH_FWD,
            "flash_bwd_dq": fa.FLASH_BWD_DQ,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV}


def zero_counts():
    for c in kernel_counters().values():
        c.launches = 0


def read_counts():
    return {n: c.launches for n, c in kernel_counters().items()}


def median_ms(fn, device, iters=30, warm=3):
    """Median time of one call of ``fn`` on the card, by CUDA events,
    with the 50 MB L2 flushed before every call (the decode step reads
    each layer's pages after the other layers evicted them)."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device=device)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------
# phase 3: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------
def paged_case(S, hkv, reps, W, D, ps, n_max, lengths, dtype, device, seed):
    """Random pools and a page table mapping each row's live blocks to
    distinct pages (dead entries at the null page 0)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = S * n_max + 1
    q = torch.randn((S, hkv, reps * W, D), generator=g).to(device, dtype)
    kp = torch.randn((P, hkv, ps, D), generator=g).to(device, dtype)
    vp = torch.randn((P, hkv, ps, D), generator=g).to(device, dtype)
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros((S, n_max), dtype=torch.int32)
    for s, ln in enumerate(lengths):
        live = -(-int(ln) // ps)
        table[s, :live] = perm[s * n_max:s * n_max + live]
    return (q, kp, vp, table.to(device),
            torch.as_tensor(lengths, dtype=torch.int32, device=device))


def paged_bound(q, kp, lengths, W):
    """Least time for the function on this card: the bytes it must move
    (queries and output once, the live K and V tokens once, the live
    table entries and lengths once) over the memory rate, against the
    multiply-adds the causal masks leave (QK and PV) over the peak rate
    for the dtype. Returns (ms, "bytes" | "operations")."""
    S, hkv, rw, D = q.shape
    ps = kp.shape[2]
    el = q.element_size()
    lens = [int(x) for x in lengths.cpu()]
    kv_bytes = sum(lens) * hkv * D * 2 * el
    table_bytes = sum(-(-ln // ps) for ln in lens) * 4
    nbytes = 2 * q.numel() * el + kv_bytes + table_bytes + 4 * S
    reps = rw // W
    keys = sum(reps * max(0, ln - W + w + 1) for ln in lens
               for w in range(W))
    flops = 4.0 * keys * D * hkv
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_inputs(q, kp, vp, table, lengths, W):
    """Dense K/V gathered through the table and the causal mask, for
    the library yardstick (scaled_dot_product_attention). The gather is
    set-up, outside its time."""
    S, hkv, rw, D = q.shape
    ps, n_max = kp.shape[2], table.shape[1]
    idx = table.long()
    kd = kp[idx].transpose(1, 2).reshape(S, hkv, n_max * ps, D)
    vd = vp[idx].transpose(1, 2).reshape(S, hkv, n_max * ps, D)
    kpos = torch.arange(n_max * ps, device=q.device)
    qpos = (lengths.long()[:, None] - W
            + torch.arange(rw, device=q.device)[None, :] % W)
    mask = (kpos[None, None, :] <= qpos[..., None])[:, None]
    return kd, vd, mask


def check_paged_kernel(device, rng):
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    F = torch.nn.functional
    # the engine's decode shape (S=8 slots, 8 kv heads, one query row,
    # head dim 64, page 16, 64 pages for max_length 1024) with the serve
    # phase's context lengths (prompt 16..300 plus up to 128 tokens),
    # then a GQA / speculative-verify shape (4 query heads per kv head,
    # 5 query positions)
    shapes = [("engine", dict(S=SLOTS, hkv=HEADS, reps=1, W=1)),
              ("gqa_verify", dict(S=SLOTS, hkv=2, reps=4, W=5))]
    cases = []
    for label, shp in shapes:
        lengths = rng.integers(16, 300 + NEW_TOKENS + 1, shp["S"])
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_case(D=WIDTH // HEADS, ps=PAGE,
                              n_max=MAX_LEN // PAGE, lengths=lengths,
                              dtype=dtype, device=device, seed=len(cases),
                              **shp)
            W = shp["W"]
            out = pk.paged_attention(*args, query_width=W)
            torch.cuda.synchronize()
            ref = pk.paged_attention_plain(*args, query_width=W)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            kd, vd, mask = sdpa_inputs(*args, W=W)
            lib = F.scaled_dot_product_attention(args[0], kd, vd,
                                                 attn_mask=mask)
            lib_err = float((lib.float() - ref.float()).abs().max())
            ms = median_ms(lambda: pk.paged_attention(*args, query_width=W),
                           device)
            plain_ms = median_ms(
                lambda: pk.paged_attention_plain(*args, query_width=W),
                device)
            lib_ms = median_ms(
                lambda: F.scaled_dot_product_attention(
                    args[0], kd, vd, attn_mask=mask), device)
            bound_ms, bound_by = paged_bound(args[0], args[1], args[4], W)
            case = {"shape": label, "dtype": str(dtype).split(".")[-1],
                    "q": list(args[0].shape), "pool": list(args[1].shape),
                    "lengths": [int(x) for x in lengths],
                    "max_abs_err": err, "tolerance": TOLERANCE[dtype],
                    "finite": finite, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_max_abs_err": lib_err,
                    "bound_ms": bound_ms, "bound_by": bound_by}
            log("paged_attention", json.dumps(case))
            if not finite or err > TOLERANCE[dtype]:
                raise AssertionError(f"paged_attention kernel disagrees with "
                                     f"its plain version: {case}")
            cases.append(case)
    # edge rows: a 0-length row, a 1-token row, a row filling its table
    for dtype in (torch.bfloat16, torch.float32):
        lengths = [0, 1, 17, MAX_LEN]
        args = paged_case(S=4, hkv=2, reps=4, W=1, D=WIDTH // HEADS,
                          ps=PAGE, n_max=MAX_LEN // PAGE, lengths=lengths,
                          dtype=dtype, device=device, seed=99)
        out = pk.paged_attention(*args, query_width=1)
        ref = pk.paged_attention_plain(*args, query_width=1)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        log(f"paged_attention edge rows {lengths} {dtype}: "
            f"max_abs_err {err}")
        if not bool(torch.isfinite(out).all()) or err > TOLERANCE[dtype] \
                or bool(out[0].any()):
            raise AssertionError(f"paged_attention edge rows: err {err}")
    return cases


# ---------------------------------------------------------------------
# phase 3b: the flash-attention kernels against their plain versions
# ---------------------------------------------------------------------
def flash_inputs(B, H, tq, tk, D, dtype, device, seed, lengths=None):
    """q, dO [B,H,tq,D], k, v [B,H,tk,D] (N(0, 0.25), seeded) and an
    optional key mask keeping the first ``lengths[b]`` keys of row b."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def mk(t):
        return (0.5 * torch.randn((B, H, t, D), generator=g)).to(device,
                                                                 dtype)
    q, k, v, do = mk(tq), mk(tk), mk(tk), mk(tq)
    km = None
    if lengths is not None:
        km = (torch.arange(tk)[None, :]
              < torch.as_tensor(lengths)[:, None]).to(device, torch.float32)
    return q, k, v, km, do


def valid_pairs(B, H, tq, tk, causal, km) -> int:
    """The (query, key) pairs the masks leave: the work these inputs
    need, not the most a shape could."""
    if km is None:
        per = tq * (tq + 1) // 2 if causal else tq * tk
        return B * H * per
    keep = (km != 0).to(torch.int64)
    if causal:
        per = keep.cumsum(dim=1).sum(dim=1)     # row i sees keys 0..i
    else:
        per = keep.sum(dim=1) * tq
    return H * int(per.sum())


def flash_bound(kernel, q, k, km, causal, exp_rate):
    """Least time for the function on this card: the larger of the
    bytes it must move (inputs once, outputs once) over the memory
    rate, its matmul flops over the dtype's peak, and its exponentials
    over the exp2 rate. Returns (ms, "bytes" | "operations", terms)."""
    B, H, tq, D = q.shape
    tk = k.shape[2]
    el = q.element_size()
    pairs = valid_pairs(B, H, tq, tk, causal, km)
    qb, kb, rows = B * H * tq * D * el, B * H * tk * D * el, B * H * tq * 4
    mask = 0 if km is None else B * tk
    nbytes, flops = {
        "flash_fwd": (2 * qb + 2 * kb + rows + mask, 4 * D * pairs),
        "flash_bwd_dq": (3 * qb + 2 * kb + 2 * rows + mask, 6 * D * pairs),
        "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * rows + mask,
                          8 * D * pairs)}[kernel]
    terms = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
             "flops_ms": 1e3 * flops / PEAK_FLOPS[q.dtype],
             "exp2_ms": 1e3 * pairs / exp_rate}
    ms = max(terms.values())
    return ms, ("bytes" if terms["bytes_ms"] >= ms else "operations"), terms


def sdpa_mask(q, k, km, causal):
    """The boolean attention mask SDPA takes for a key mask (None
    otherwise: SDPA's own is_causal covers the causal triangle)."""
    if km is None:
        return None
    valid = (km != 0)[:, None, None, :]
    if causal:
        i = torch.arange(q.shape[2], device=q.device)
        valid = valid & (i[None, :] <= i[:, None])[None, None]
    return valid


def max_err(a, b):
    """Max |a - b| over entries where the reference is not the -1e30
    fill of a fully masked row's lse."""
    a, b = a.float(), b.float()
    keep = b > -1e20
    return float((a - b)[keep].abs().max()) if bool(keep.any()) else 0.0


def flash_compare(q, k, v, km, do, causal, got, lse, delta):
    """The kernels' outputs ``got`` (o, dq, dk, dv) against the plain
    versions on the same inputs (the backward from the kernel forward's
    lse and delta, as in training). In bf16 also against the plain
    versions without their rounding points (inputs widened to f32,
    outputs rounded to bf16 as a kernel stores them): what a kernel
    that left them out would give, up to f32 summation order. Returns
    (record, failures)."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    dtype = q.dtype

    def plain(q_, k_, v_, do_):
        o_, lse_ = fa.flash_attention_fwd_plain(q_, k_, v_, km, causal)
        dq_ = fa.flash_attention_bwd_dq_plain(q_, k_, v_, km, do_, lse,
                                              delta, causal)
        dk_, dv_ = fa.flash_attention_bwd_dkv_plain(q_, k_, v_, km, do_,
                                                    lse, delta, causal)
        return {"o": o_.to(dtype), "dq": dq_.to(dtype), "dk": dk_.to(dtype),
                "dv": dv_.to(dtype)}, lse_

    ref, ref_lse = plain(q, k, v, do)
    rec = {"max_abs_err": {n: max_err(got[n], ref[n]) for n in got},
           "row_rel": {}, "tile_rel": {}}
    rec["max_abs_err"]["lse"] = max_err(lse, ref_lse)
    failures = []
    if rec["max_abs_err"]["lse"] > FLASH_LSE:
        failures.append("lse")
    for n in got:
        row_rel, tile_rel = fa.agreement(got[n], ref[n])
        rec["row_rel"][n], rec["tile_rel"][n] = row_rel, tile_rel
        if row_rel > FLASH_ROW[dtype] or \
                tile_rel > FLASH_TILE[dtype, "o" if n == "o" else "grad"]:
            failures.append(n)
    if dtype == torch.bfloat16:
        # the limits' power at this shape: the plain versions without
        # their rounding points fail the gradients' tile limit, and the
        # kernel forward stands off the unrounded forward
        unrounded, _ = plain(q.float(), k.float(), v.float(), do.float())
        power = {"o_kernel_from_unrounded":
                 fa.agreement(got["o"], unrounded["o"])[1]}
        for n in ("dq", "dk", "dv"):
            power[f"{n}_unrounded"] = fa.agreement(unrounded[n], ref[n])[1]
        rec["unrounded_tile_rel"] = power
        if power["o_kernel_from_unrounded"] < FLASH_UNROUNDED:
            failures.append("o is the unrounded forward")
        for n in ("dq", "dk", "dv"):
            if power[f"{n}_unrounded"] <= FLASH_TILE[dtype, "grad"]:
                failures.append(f"the limit does not tell {n} unrounded")
    return rec, failures


def flash_case(label, shape, dtype, causal, device, exp_rate, seed,
               lengths=None):
    """One case: the three kernels against their plain versions on the
    same inputs (flash_compare), and each kernel's, plain version's and
    SDPA's times beside its bound."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    F = torch.nn.functional
    B, H, tq, tk, D = shape
    q, k, v, km, do = flash_inputs(B, H, tq, tk, D, dtype, device, seed,
                                   lengths)
    o, lse = fa.flash_attention_fwd(q, k, v, km, causal)
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta, causal)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta, causal)
    torch.cuda.synchronize()
    case = {"case": label, "dtype": str(dtype).split(".")[-1],
            "shape": [B, H, tq, tk, D], "causal": causal,
            "key_lengths": lengths,
            "limits": {"row_rel": FLASH_ROW[dtype],
                       "tile_rel_o": FLASH_TILE[dtype, "o"],
                       "tile_rel_grad": FLASH_TILE[dtype, "grad"],
                       "lse_abs": FLASH_LSE,
                       **({"o_from_unrounded_min": FLASH_UNROUNDED}
                          if dtype == torch.bfloat16 else {})}}
    finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
    rec, failures = flash_compare(q, k, v, km, do, causal,
                                  {"o": o, "dq": dq, "dk": dk, "dv": dv},
                                  lse, delta)
    case.update(rec)
    torch.cuda.synchronize()
    if lengths is not None and 0 in lengths:
        row = lengths.index(0)
        case["empty_row_o_abs_max"] = float(o[row].abs().max())
        if case["empty_row_o_abs_max"] != 0.0:
            failures.append("empty row")
    log("flash check", json.dumps(case))
    if not finite or failures:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions ({failures}, finite {finite}): "
                             f"{case}")
    # library yardstick: SDPA forward, and its backward (dq, dk, dv in
    # one call) through autograd
    mask = sdpa_mask(q, k, km, causal)
    lib_causal = causal and mask is None
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                             is_causal=lib_causal)
    fns = {
        "flash_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, km, causal),
            lambda: fa.flash_attention_fwd_plain(q, k, v, km, causal)),
        "flash_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta,
                                              causal),
            lambda: fa.flash_attention_bwd_dq_plain(q, k, v, km, do, lse,
                                                    delta, causal)),
        "flash_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                               causal),
            lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, km, do, lse,
                                                     delta, causal))}
    timed = {}
    for name, (kern, plain) in fns.items():
        bound_ms, bound_by, terms = flash_bound(name, q, k, km, causal,
                                                exp_rate)
        timed[name] = {"ms": median_ms(kern, device),
                       "plain_ms": median_ms(plain, device, iters=10),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_terms_ms": terms}
    timed["flash_fwd"]["library_ms"] = median_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               is_causal=lib_causal), device)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), do, retain_graph=True), device)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        timed[name]["library_ms"] = None
        timed[name]["library_bwd_ms"] = lib_bwd
    case["kernels"] = timed
    log("flash", json.dumps(case))
    del lib_out, qr, kr, vr
    torch.cuda.empty_cache()
    return case


def check_flash_kernels(device, exp_rate):
    """The training shape first (compared and timed at T=8192; the plain
    versions hold their [B,H,T,T] f32 tensors in place, ~30 GB), then
    the edge cases at T <= 2048."""
    w = WIDTH // HEADS
    cases = [
        flash_case("train_shape_bf16", (TRAIN_B, HEADS, TRAIN_T, TRAIN_T, w),
                   torch.bfloat16, True, device, exp_rate, seed=1),
        flash_case("train_width_T2048_bf16", (TRAIN_B, HEADS, 2048, 2048, w),
                   torch.bfloat16, True, device, exp_rate, seed=2),
        flash_case("causal_f32", (TRAIN_B, HEADS, 2048, 2048, w),
                   torch.float32, True, device, exp_rate, seed=3),
        flash_case("cross_tq_ne_tk_bf16", (2, HEADS, 1000, 3000, w),
                   torch.bfloat16, False, device, exp_rate, seed=4),
        flash_case("key_mask_empty_row_bf16", (4, HEADS, 2048, 2048, w),
                   torch.bfloat16, True, device, exp_rate, seed=5,
                   lengths=[2048, 1500, 700, 0]),
        flash_case("ragged_t_f32", (2, HEADS, 1999, 1999, w), torch.float32,
                   True, device, exp_rate, seed=6),
    ]
    return cases


# ---------------------------------------------------------------------
# phase 4: the serving path at full width
# ---------------------------------------------------------------------
def serve(device, rng):
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    model = TextGenerationTransformer(
        vocab_size=VOCAB, embed_dim=WIDTH, n_heads=HEADS, n_layers=LAYERS,
        ffn_mult=4, max_length=MAX_LEN, positional="rope", seed=7)
    net = model.init(device=device)
    net.conf.dtype = "bfloat16"
    probe = net.output(np.eye(VOCAB, dtype=np.float32)[:, :8][None])
    if tuple(probe.shape) != (1, VOCAB, 8) or \
            not bool(torch.isfinite(probe).all()) or \
            float((probe.sum(dim=1) - 1).abs().max()) > 1e-2:
        raise AssertionError("output() is not a finite distribution")
    engine = GenerationEngine(net, VOCAB, slots=SLOTS,
                              paging=PagedKVConfig(page_size=PAGE),
                              device=device)
    system = [int(t) for t in rng.integers(1, VOCAB, SYSTEM_PREFIX)]
    requests = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(16, 301))
        body = [int(t) for t in rng.integers(1, VOCAB, n)]
        # a quarter share the system prefix (prompts of 80..300 tokens)
        prompt = (system + body[:max(16, n - SYSTEM_PREFIX)] if i % 4 == 0
                  else body)
        sampling = dict(top_k=1)
        if i % 5 == 4:
            sampling = dict(top_k=40, temperature=0.9)
        elif i % 7 == 6:
            sampling = dict(top_p=0.9)
        requests.append((prompt, sampling))
    t0 = time.perf_counter()
    engine.warmup(max_prompt_len=300)
    warm_s = time.perf_counter() - t0
    engine.ttft_s.clear()
    engine.tpot_s.clear()
    zero_counts()
    d0, hits0 = engine.dispatches, engine.prefix_cache.hits
    engine.start()
    t0 = time.perf_counter()
    handles = [engine.submit(p, steps=NEW_TOKENS,
                             rng=np.random.default_rng(i), **kw)
               for i, (p, kw) in enumerate(requests)]
    outs = [h.result(timeout=600) for h in handles]
    dt = time.perf_counter() - t0
    engine.shutdown()
    dispatches = engine.dispatches - d0
    counts = read_counts()
    launches = counts["paged_attention"]
    reasons = [h.finish_reason for h in handles]
    generated = sum(len(o) - len(p) for o, (p, _) in zip(outs, requests))
    if reasons != ["length"] * N_REQUESTS or \
            generated != N_REQUESTS * NEW_TOKENS:
        raise AssertionError(f"serve: reasons {reasons}, {generated} tokens")
    if not all(0 <= t < VOCAB for o in outs for t in o):
        raise AssertionError("serve: token id out of range")
    if dispatches == 0 or launches != dispatches * LAYERS:
        raise AssertionError(f"serve: {launches} paged kernel launches for "
                             f"{dispatches} decode dispatches x {LAYERS} "
                             f"layers")
    rec = {"requests": N_REQUESTS, "new_tokens": NEW_TOKENS,
           "prompt_tokens": [len(p) for p, _ in requests],
           "generated_tokens": generated, "wall_s": dt,
           "tokens_per_s": generated / dt,
           "ttft_p50_ms": 1e3 * float(np.median([h.ttft_s for h in handles])),
           "tpot_p50_ms": 1e3 * float(np.median(engine.tpot_s)),
           "decode_dispatches": dispatches,
           "decode_dispatch_mean_ms":
               1e3 * engine.dispatch_s_total / engine.dispatches,
           "paged_attention_launches": launches, "launches": counts,
           "prefix_hits": engine.prefix_cache.hits - hits0,
           "warmup_s": warm_s, "finish_reasons": sorted(set(reasons))}
    return rec, launches


def step_ms(engine, steps):
    """Wall ms per engine step over ``steps`` steps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / steps


def profile_decode(device, rng, steps=20):
    """Where a decode step's time goes, with all 8 slots of the served
    configuration decoding (no admission in the window). First the wall
    ms per step as shipped, then with one part swapped out (what the
    step would cost without it; measurements only, outside the counted
    serve run): the paged kernel for its plain version, and the
    op-by-op gelu and softmax (the JAX package's rounding points) for
    torch's fused ops; then as shipped again. Then ``torch.profiler``
    over ``steps`` steps: the device's busy share (kernel time over wall
    time, one stream), CUDA kernel launches per step and the kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import activations as act
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    net = TextGenerationTransformer(
        vocab_size=VOCAB, embed_dim=WIDTH, n_heads=HEADS, n_layers=LAYERS,
        max_length=MAX_LEN, positional="rope", seed=7).init(device=device)
    net.conf.dtype = "bfloat16"
    engine = GenerationEngine(net, VOCAB, slots=SLOTS,
                              paging=PagedKVConfig(page_size=PAGE),
                              device=device)
    for _ in range(SLOTS):
        engine.submit([int(t) for t in rng.integers(1, VOCAB, 200)],
                      steps=5 * steps + 8, top_k=1)
    for _ in range(3):          # admit all, then two plain decode steps
        engine.step()
    F = torch.nn.functional
    swaps = {
        "plain_attention": (vars(pk), {
            "paged_attention": pk.paged_attention_plain}),
        "fused_activations": (act.ACTIVATIONS, {
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "softmax": lambda x: torch.softmax(x, dim=1)})}
    timed = {"shipped": [step_ms(engine, steps)]}
    for label, (table, new) in swaps.items():
        old = {k: table[k] for k in new}
        table.update(new)
        try:
            timed[label] = step_ms(engine, steps)
        finally:
            table.update(old)
    timed["shipped"].append(step_ms(engine, steps))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.shutdown()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy_us = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "step_ms_unprofiled": timed,
            "step_ms": 1e3 * wall / steps,
            "device_busy_share": busy_us / (wall * 1e6),
            "kernel_launches_per_step":
                sum(e.count for e in kernels) / steps,
            "paged_kernel_share_of_device_time": (
                sum(t for k, t in dev_us.items()
                    if "paged_decode_kernel" in k) / busy_us
                if busy_us else None),
            "top_kernels_us_per_step": [[k[:80], t / steps] for k, t in top]}


# ---------------------------------------------------------------------
# phase 6: engine == sample_stream on the card, f32
# ---------------------------------------------------------------------
def reference(device, rng):
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION)
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer

    model = TextGenerationTransformer(
        vocab_size=VOCAB, embed_dim=WIDTH, n_heads=HEADS, n_layers=2,
        max_length=MAX_LEN, positional="rope", seed=11)
    net = model.init(device=device)
    prompts = [[int(t) for t in rng.integers(1, VOCAB, n)] for n in (40, 9)]
    engine = GenerationEngine(net, VOCAB, slots=SLOTS,
                              paging=PagedKVConfig(page_size=PAGE),
                              device=device)
    before = PAGED_ATTENTION.launches
    handles = [engine.submit(p, steps=32, top_k=1) for p in prompts]
    engine.run_until_idle()
    got = [h.result(timeout=0) for h in handles]
    launched = PAGED_ATTENTION.launches - before
    want = [model.sample_stream(net, p, steps=32, top_k=1) for p in prompts]
    same = got == want
    log("reference:", json.dumps({"dtype": "float32", "layers": 2,
                                  "equal": same, "kernel_launches": launched}))
    if not same or launched == 0:
        raise AssertionError(f"engine {got} != sample_stream {want}")
    return {"equal": same, "kernel_launches": launched}


# ---------------------------------------------------------------------
# phases 7-9: the training path at full width
# ---------------------------------------------------------------------
def one_hot_batch(rng, B, V, T):
    """A seeded token batch as one-hot [B, V, T] f32 and its labels, the
    inputs rolled by one position (bench_all.py's transformer batch)."""
    ids = rng.integers(0, V, (B, T))
    x = np.zeros((B, V, T), np.float32)
    x[np.arange(B)[:, None], ids, np.arange(T)[None, :]] = 1.0
    return x, np.roll(x, -1, axis=2)


def train_model(layers, T, seed):
    from deeplearning4j_tpu_torch.nn.updater import Adam
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
    return TextGenerationTransformer(
        vocab_size=TRAIN_VOCAB, embed_dim=WIDTH, n_heads=HEADS,
        n_layers=layers, max_length=T, block_size=1024,
        updater=Adam(3e-4), seed=seed)


def train(device, rng):
    """bench_all.py's transformer_train_T8192 through ``net.fit``: one
    warm-up step, then TRAIN_STEPS timed steps on one fixed batch, with
    every kernel count set to 0 just before them and read just after."""
    net = train_model(LAYERS, TRAIN_T, seed=3).init(device=device)
    net.conf.dtype = "bfloat16"
    x, y = one_hot_batch(rng, TRAIN_B, TRAIN_VOCAB, TRAIN_T)
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_B)
    first = net.score_value
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_s = [], []
    zero_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=TRAIN_B)
        losses.append(net.score_value)      # a host read of the loss
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    want = TRAIN_STEPS * LAYERS
    rec = {"config": {"vocab": TRAIN_VOCAB, "width": WIDTH, "heads": HEADS,
                      "layers": LAYERS, "T": TRAIN_T, "batch": TRAIN_B,
                      "positional": "learned", "updater": "Adam(3e-4)",
                      "dtype": "bfloat16"},
           "warmup_step_s": warm_s, "warmup_loss": first,
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * float(np.median(step_s)),
           "tokens_per_s": TRAIN_B * TRAIN_T / float(np.median(step_s)),
           "max_memory_allocated_bytes": peak, "launches": counts,
           "iteration_count": net.iteration_count}
    log("train:", json.dumps(rec))
    if not all(np.isfinite(losses)) or not losses[-1] < min(first,
                                                            losses[0]):
        raise AssertionError(f"train: loss not finite or not falling: "
                             f"{first} then {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name] != want:
            raise AssertionError(f"train: {name} launched {counts[name]} "
                                 f"times in {TRAIN_STEPS} steps, want "
                                 f"{want}")
    return rec, net, (x, y)


def key_bias_grad_ratio(net):
    """The attention key biases' gradient size over the key weights',
    from Adam's second moments (the root of v is the size of the
    gradients so far), at its largest over the attention layers."""
    v = net.updater_state["v"]
    return max(float(torch.sqrt(p["bk"].max() / p["Wk"].max()))
               for p in v.values() if "bk" in p)


def train_reference(device, rng, steps=2, T=1024, B=2):
    """f32, 2 layers at full width: Adam steps with the kernels, then
    from the same start with their plain versions swapped in; the
    parameters must agree within 2e-5 absolute and the losses to 1e-5
    relative. The attention key biases' exact gradient is zero (a bias
    on every key shifts a query's learned-position scores alike, and
    softmax ignores the shift): on both sides it must stay under 1e-5 of
    the key weights' gradient (a kernel whose ds rows do not sum to zero
    gives it one); below Adam's epsilon it barely moves them."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    from deeplearning4j_tpu_torch.util.convert import params_to_numpy
    model = train_model(2, T, seed=11)
    x, y = one_hot_batch(rng, B, TRAIN_VOCAB, T)
    runs = {}
    swap = {"flash_attention_fwd": fa.flash_attention_fwd_plain,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq_plain,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_plain}
    for label in ("kernels", "plain"):
        net = model.init(device=device)
        old = {k: vars(fa)[k] for k in swap}
        zero_counts()
        if label == "plain":
            vars(fa).update(swap)
        try:
            losses = []
            for _ in range(steps):
                net.fit(x, y, batch_size=B)
                losses.append(net.score_value)
        finally:
            vars(fa).update(old)
        runs[label] = (params_to_numpy(net.params), losses, read_counts(),
                       key_bias_grad_ratio(net))
    (pk, lk, ck, gk), (pp, lp, cp, gp) = runs["kernels"], runs["plain"]
    diff = {"max_abs": 0.0, "key_bias_max_abs": 0.0}
    for v, p in pk.items():
        for k, a in p.items():
            key = "key_bias_max_abs" if k == "bk" else "max_abs"
            diff[key] = max(diff[key], float(np.abs(a - pp[v][k]).max()))
    rec = {"dtype": "float32", "layers": 2, "T": T, "batch": B,
           "steps": steps, "losses_kernels": lk, "losses_plain": lp,
           "param_diff": diff, "tolerance": 2e-5,
           "key_bias_grad_ratio": {"kernels": gk, "plain": gp},
           "key_bias_grad_ratio_limit": 1e-5,
           "launches_kernels": ck, "launches_plain": cp}
    log("train reference:", json.dumps(rec))
    if max(diff.values()) > 2e-5 or max(gk, gp) > 1e-5 or \
            not np.allclose(lk, lp, rtol=1e-5) or \
            ck["flash_fwd"] != steps * 2 or cp["flash_fwd"] != 0:
        raise AssertionError(f"train reference: kernels and plain "
                             f"attention disagree: {rec}")
    return rec


def profile_train(net, batch):
    """One training step under torch.profiler: the device's busy share
    (kernel time over wall time, one stream), CUDA kernel launches and
    the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    x, y = batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(x, y, batch_size=TRAIN_B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy_us = sum(dev_us.values())
    flash_us = sum(t for k, t in dev_us.items() if "flash_" in k)
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    rec = {"step_ms": 1e3 * wall, "device_busy_share": busy_us / (wall * 1e6),
           "kernel_launches_per_step": sum(e.count for e in kernels),
           "flash_kernels_share_of_device_time":
               flash_us / busy_us if busy_us else None,
           "top_kernels_us_per_step": [[k[:80], t] for k, t in top]}
    log("train profile:", json.dumps(rec))
    return rec


def build_all():
    """Build every kernel library, one nvcc each, all started together;
    returns (seconds, {library: ptxas lines})."""
    from deeplearning4j_tpu_torch.nn.layers.flash_attention import (
        FLASH_FWD)
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION)
    libs = [PAGED_ATTENTION.library, FLASH_FWD.library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs]:
            f.result()
    build_s = time.perf_counter() - t0
    logs = {lib.name: [line.strip() for line in lib.build_log.splitlines()
                       if "registers" in line or "spill" in line]
            for lib in libs}
    return build_s, logs


def kernel_entry(name, source, replaces, launches, main, cases):
    """A flash kernel's entry of the kernels line: its times and errors
    at the main path's shape (``main``), and every case's."""
    outs = {"flash_fwd": ("o",), "flash_bwd_dq": ("dq",),
            "flash_bwd_dkv": ("dk", "dv")}[name]

    def worst(c, key):
        return max(c[key][n] for n in outs)

    def errors(c):
        e = {key: worst(c, key) for key in ("max_abs_err", "row_rel",
                                            "tile_rel")}
        if name == "flash_fwd":
            e["lse_max_abs_err"] = c["max_abs_err"]["lse"]
        return e

    k = main["kernels"][name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **errors(main), "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            **({"library_bwd_ms": k["library_bwd_ms"]}
               if "library_bwd_ms" in k else {}),
            "shape": main["shape"], "dtype": main["dtype"],
            "limits": main["limits"],
            "max_abs_err_all": max(worst(c, "max_abs_err") for c in cases),
            "cases": [{"case": c["case"], **c["kernels"][name], **errors(c),
                       "limits": c["limits"]} for c in cases]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    exp_rate = exp2_per_s(device)
    log(f"device: {kind} | nvidia-smi: {smi} | exp2 {exp_rate:.4g}/s | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    build_s, build_logs = build_all()
    log(f"build: {build_s:.2f} s for {sorted(build_logs)}")
    for name, lines in build_logs.items():
        for line in lines:
            log(f"  {name}: {line}")

    rng = np.random.default_rng(0)
    paged_cases = check_paged_kernel(device, rng)
    flash_cases = check_flash_kernels(device, exp_rate)
    rec, launches = serve(device, rng)
    log("serve:", json.dumps({**rec, "card": smi}))
    prof = profile_decode(device, rng)
    log("profile:", json.dumps({**prof, "card": smi}))
    ref = reference(device, rng)
    train_rec, net, batch = train(device, rng)
    log("train:", json.dumps({"tokens_per_s": train_rec["tokens_per_s"],
                              "step_ms_median": train_rec["step_ms_median"],
                              "max_memory_allocated_bytes":
                                  train_rec["max_memory_allocated_bytes"],
                              "card": smi}))
    train_prof = profile_train(net, batch)
    del net, batch
    torch.cuda.empty_cache()
    train_ref = train_reference(device, rng)

    main_case = next(c for c in paged_cases
                     if c["shape"] == "engine" and c["dtype"] == "bfloat16")
    flash_main = flash_cases[0]
    csrc = "deeplearning4j_tpu_torch/nn/layers/csrc/flash_attention.cu"
    pallas = "deeplearning4j_tpu/nn/layers/pallas_attention.py"
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/serving/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/serving/paged_kernel.py:71",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "max_abs_err_all": max(c["max_abs_err"] for c in paged_cases),
        "cases": paged_cases}]
    for name, line in (("flash_fwd", 121), ("flash_bwd_dq", 172),
                       ("flash_bwd_dkv", 213)):
        kernels.append(kernel_entry(name, csrc, f"{pallas}:{line}",
                                    train_rec["launches"][name], flash_main,
                                    flash_cases))
    total_s = time.perf_counter() - t_start
    log(f"chip_smoke: all phases passed in {total_s:.1f} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "build_s": build_s, "total_s": total_s,
                       "kernels": kernels, "flash_cases": flash_cases,
                       "serve": rec, "profile": prof,
                       "reference": ref, "train": train_rec,
                       "train_profile": train_prof,
                       "train_reference": train_ref}, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
