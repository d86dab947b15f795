#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits nonzero):

1. device: the card's name, power limit and top SM clock (nvidia-smi);
2. build: every CUDA kernel library (paged attention with its int8
   variant, flash attention,
   bottleneck, bottleneck backward, stem, stem backward) from the
   sources in the checkout, one nvcc each, started together;
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
   points. The int8 paged decode (``paged_quant``): the engine and
   GQA/verify shapes over int8 pools with power-of-two page scales, bf16
   and f32 queries, SDPA timed on the dequantized dense view, the limits
   shown to fail two faults planted in the plain version (the V scale
   dropped; p rounded to bf16), edge rows and an out-of-pool page id;
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
6b. serve int8 (``serve_int8``): phase 4's configuration and traffic
   with ``PagedKVConfig(kv_dtype="int8")`` and with the bf16 pool in
   turns (int8, bf16, bf16, int8): tokens/s, ms per decode step, TTFT
   and TPOT p50, peak memory; every int8 decode dispatch launches the
   int8 kernel once per layer and row 15's kernel never; the pages the
   bf16 pool's byte budget buys under int8 (>= 1.9x); ``kv_dtype=
   "auto"`` resolving as a temporary store's verdicts imply; phase 5's
   profile of the int8 engine's decode steps;
6c. int8 reference (``quant_reference``): in f32 with 2 layers, the
   int8 engine's greedy streams with the kernel equal those with its
   plain version swapped in, and a prefix hit equals a miss;
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
   busy share, launches per step, the top kernels);
10. cnn kernels: the four ResNet50 forward kernels (bottleneck conv1x1
    and conv3x3, stem conv and stem pool) against their plain versions
    at the inference path's shapes, bf16 at B=128 and f32 at B=16: each
    output row and each 64-row tile held to limits relative to its own
    size, the channel sums to 1e-5 of the sum of |output| (against the
    kernel's own stored output), the pool exactly; in bf16 the check is
    shown to fail a version that skips the rounding of the activated
    input before the dot; a conv launcher given partial sums one row
    tile short refuses. Times of the
    kernel, the plain version and the nearest library call (a cuBLAS
    matmul on the activated input, cuDNN's conv, ``F.max_pool2d``)
    beside the bound;
11. resnet: ResNet50 inference at full width (1000 classes, 224x224,
    B=128, bf16, NHWC, the fused plan with the stem, random weights
    from a seed, BN statistics calibrated on 16 seeded images) through
    ``ComputationGraph.output``: the probabilities finite with rows
    summing to 1; per forward the conv1x1 kernel launches 36 times,
    conv3x3 16, the stem conv and pool once each; the logits against
    the same forward's with the plain versions swapped in, each row's
    largest difference over the row's spread, and the same limit shown
    to fail two faults planted in one block (a conv_c prologue without
    its relu; a 3x3 padded with relu(bb)); images/s of the fused and the
    "xla" plan (cuDNN convolutions) in turns, peak memory, and one
    forward under ``torch.profiler``;
12. resnet reference: in f32 at B=8, the fused plan's (kernels) logits
    against the "xla" plan's of the same graph, with the same two
    planted faults;
13. cnn bwd kernels: the two ResNet50 backward kernels (a bottleneck
    stage's 1x1 and 3x3 backward: dz0, dW and the BN sums in one entry
    point) against their plain versions at the training path's shapes,
    bf16 at B=128 and f32 at B=16: dz0 and dW by row and 64-row tile as
    in phase 10, the sums within 1e-6 of each channel's sum of |terms|,
    the rows a stride-2 conv never read exactly 0, the identity
    prologue's sums exactly 0; in bf16 the limits are shown to fail
    three faults planted through the kernels (a 3x3 padded with the
    BN-backward affine of zero, a 1x1 without its relu' mask, sums over
    the stored rounded dz0). Times of the kernel, the plain version and
    cuDNN's ``aten.convolution_backward`` (dgrad and wgrad,
    channels-last) beside the bound;
14. resnet train: ResNet50 training at full width (bench_all.py's
    bench_train_plan: 1000 classes, 224x224, B=128, bf16, NHWC,
    Nesterovs(0.1, 0.9), the fused plan, random weights from the conf
    seed, seeded images and labels) through ``net.fit``: one warm-up
    step, then 5 timed steps on the same batch, each ending in a host
    read of the loss; the loss finite; per step the conv1x1 kernel
    launches 36 times, conv3x3 16, bwd1x1 36, bwd3x3 16, the stem
    kernels never; ms per step, images/s and peak memory; the "xla"
    plan's steps in turns with the fused plan's; one fused step under
    ``torch.profiler``. Then a fresh net from the same seed takes the
    same 6 steps on the "xla" plan (cuDNN convolutions under autograd):
    both start from the same weights, the first losses agree, the first
    step's parameters and velocity agree by ``update_err`` (leaf by
    leaf) and a planted fault (s4b4's stage c backward without its
    relu' mask) fails that limit, both losses fall at the first update,
    and both trajectories are recorded;
15. resnet train reference: in f32 at B=8, 224x224, Nesterovs(1e-6,
    0.9), two fit steps with the kernels against two with the plain
    versions swapped in, and against two on the "xla" plan (cuDNN, TF32
    off), by parameters, BN state and Nesterovs velocity (``update_err``,
    leaf by leaf); the same planted fault must fail the limit.

16. stem bwd kernels: the fused stem's three backward kernels (bwd_pool:
    the pool and relu backward with the BN-backward sums; bwd_dw: dy and
    the weight gradient; bwd_dx: the input gradient) against their plain
    versions at the training shape (224x224x3 -> 64), bf16 at B=128 and
    f32 at B=16, each on its plain version's inputs: dz0, dy, dW and dx
    by row and 64-row tile as in phase 13 (dx's tiles to 1e-3 in bf16:
    its sums cancel), the sums within 1e-6 of each channel's sum of
    |terms|; in bf16 four faults planted in the plain versions fail the
    limits (bwd_pool without its relu' mask, the window maxima compared
    in f32, dW from the unrounded dy, dx rounded per tap). Times of the
    kernel, the plain version and ``aten.max_pool2d_with_indices_
    backward`` or cuDNN's ``convolution_backward`` (wgrad, dgrad;
    channels-last) beside the bound;
17. resnet train stem: phase 14's configuration with the stem kernels
    engaged (``set_fusion("bottleneck", stem=True)``) through
    ``net.fit``: a warm-up step and 5 timed steps, the loss finite, per
    step conv1x1 36, conv3x3 16, bwd1x1 36, bwd3x3 16 launches, the stem
    conv, pool, bwd_pool and bwd_dw once each, bwd_dx never; the first
    four losses within 3e-2 of the xla plan's from the same seed and
    moving alike; ms per step, images/s and peak memory of the stem-
    fused, fused (no stem) and xla plans in turns; one profiled step;
18. resnet train stem reference: phase 15 with the stem engaged: the
    kernels against the plain versions (the stem's too) and against the
    xla plan, two f32 fit steps at B=8, by update_err leaf by leaf; a
    fault planted in the stem's backward (dW summed over half the batch,
    through the kernel) fails the limit;
19. auto plan: ``calibrate_training_kernels`` on the full-width
    ResNet50 (bf16, B=128, the batch fit trains at) into a store in a
    temporary directory (every
    distinct block shape and the stem; bwd_dx launched), each key's
    kernel and fallback ms and verdict; a fresh net's
    ``fit(execution_plan="auto")`` at B=128 fuses and launches exactly
    what the verdicts imply, and so does the store saved and loaded
    back; entries stamped with another device kind resolve to the xla
    plan; a store of synthetic verdicts (the stem and the s2 and s4
    blocks win) engages the stem and those blocks. The fallback is timed
    as the xla plan's own layers, and ``fit(execution_plan=
    "auto")`` on the calibrated store must be within the xla plan's
    spread of step times, or faster, in turns.

The last lines are the ``kernels`` JSON, the nvidia-smi line and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits nonzero and prints no result. ``--json`` also writes every
measurement to PATH; ``--phases`` runs a subset (by their names in
``phase_s``), for debugging, and then prints neither of the last two.
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
# The int8 paged-decode kernel against its plain version (the pools
# dequantized exactly, then row 15's plain version): bf16 outputs within
# row 15's limit; f32 outputs within 2e-5 (the JAX package's own
# tolerance for its int8 kernel against the dequantized reference: the
# two differ only in the order of f32 sums and the online softmax's
# rescaling, ~1e-7 here), which p rounded to bf16 before the PV product
# (the fault planted to show the limit bites) exceeds.
QUANT_TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
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

# ResNet50 inference (bench.py's BATCH, bench_all.py's bench_train_plan
# configuration run forward)
RESNET_B, RESNET_HW, RESNET_CLASSES, RESNET_REF_B = 128, 224, 1000, 8
RESNET_TIMED = 5                 # timed output() calls per plan and turn
#: launches per forward: 16 conv_a + 16 conv_c + 4 conv shortcuts; the 16
#: 3x3 convs; the stem once
RESNET_LAUNCHES = {"conv1x1": 36, "conv3x3": 16, "stem_conv": 1,
                   "stem_pool": 1}
# The conv kernels against their plain versions, by
# flash_attention.agreement over output rows (one pixel's channels) and
# 64-row tiles: bf16 rows within two ulps of their largest element and
# tiles within CONV_TILE (the kernels round at the plain versions' points
# and sum in another f32 order, so a few outputs flip one ulp; leaving
# the rounding of the activated input out flips a third of them); f32
# rows within 1e-4 and tiles within 1e-5. The sums within CONV_SUMS of
# each channel's sum of |output| (sum of squares: of itself). The pool
# compares the same f32 values, so exactly. The sums are held against
# torch's sums of the kernel's own stored output.
CONV_ROW = {torch.bfloat16: 2 ** -6, torch.float32: 1e-4}
CONV_TILE = {torch.bfloat16: 1e-4, torch.float32: 1e-5}
CONV_SUMS = 1e-5
# ResNet50 logits (the output layer's values before the softmax), each
# row's largest difference over that row's spread (its largest logit
# less its smallest): the kernels' forward against the plain versions'
# in bf16 (one-ulp flips, propagated through 53 layers), and the fused
# plan against the xla plan in f32 (sums in other orders only). Each
# phase also shows the limit failing two faults planted in one block,
# through the kernels (PLANTED).
RESNET_LOGIT = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
RESNET_ROW_SUM = 1e-2            # bf16 softmax probabilities, rounded
#: fault: the index of its block among the 16 in topological order.
#: "conv_c_no_relu": s3b1's conv_c reads its input without the relu of
#: its prologue; "pad_relu_bb": s2b1's 3x3 pads with relu(bb), the
#: prologue of a zero pixel, instead of 0 (the trap the kernel's padding
#: of the activated image avoids), on 7% of the pixels at 56x56
PLANTED = {"conv_c_no_relu": 4, "pad_relu_bb": 1}

# ResNet50 training (bench_all.py's bench_train_plan at its defaults)
TRAIN_RESNET_STEPS, TRAIN_RESNET_TURNS = 5, 2
#: launches per training step: the forward's 36 conv1x1 and 16 conv3x3;
#: the backward's 16 stage c, 16 stage a and 4 conv shortcut 1x1 stages
#: and 16 3x3 stages; the stem trains unfused
RESNET_TRAIN_LAUNCHES = {"conv1x1": 36, "conv3x3": 16, "bwd1x1": 36,
                         "bwd3x3": 16, "stem_conv": 0, "stem_pool": 0,
                         "stem_bwd_pool": 0, "stem_bwd_dw": 0,
                         "stem_bwd_dx": 0}
#: with the stem engaged (phases 17-18): its forward kernels, bwd_pool
#: and bwd_dw once a step; the input gradient never (the stem's input is
#: the network input)
RESNET_TRAIN_STEM_LAUNCHES = {**RESNET_TRAIN_LAUNCHES, "stem_conv": 1,
                              "stem_pool": 1, "stem_bwd_pool": 1,
                              "stem_bwd_dw": 1}
# The backward kernels against their plain versions. dz0 (stored in the
# compute dtype) by rows and 64-row tiles as the forward convs (CONV_ROW,
# CONV_TILE: same rounding points, f32 sums in another order). dW is
# f32 from both, a sum over up to 401,408 pixels in another order (the
# kernel: per-split f32 partials merged in f64; the plain version:
# cuBLAS): rows within BWD_DW_ROW of their largest entry, tiles within
# BWD_DW_TILE. The sums within BWD_SUMS of each channel's sum of |terms|
# (the kernel's f32 sums in another order: at most 3e-7; sums over the
# stored, rounded dz0 instead: 1.4e-5 and more).
BWD_DW_ROW = {torch.bfloat16: 1e-4, torch.float32: 1e-4}
BWD_DW_TILE = {torch.bfloat16: 1e-5, torch.float32: 1e-5}
BWD_SUMS = 1e-6
# Two training runs by update_err, leaf by leaf: each leaf's largest
# difference over that leaf's own change since the start, the change
# floored at UPDATE_ULP_FLOOR of the leaf's largest value (a change of a
# few f32 ulps is rounding, not an update) and at UPDATE_REL_FLOOR of
# the largest change of any leaf.
UPDATE_ULP_FLOOR, UPDATE_REL_FLOOR = 2.0 ** -16, 1e-2
# The full-width fused steps against a fresh net's on the xla plan from
# the same seed, by their losses: the first TRAIN_LOSS_AGREED (the same
# weights, then three updates) within TRAIN_LOSS_AGREE of the xla plan's,
# relative (0.14-0.71% on the H100, the same in every call: both plans
# are deterministic); later the two part, as any two bf16 runs at lr 0.1
# do (6.7%, then 15.5%). The first step's gradient is no finer check in
# bf16: its velocity differs from the xla plan's, and from the plain
# versions' (the same rounding points), by about its own norm (1.27 and
# 1.06), so it is recorded, not held; the f32 reference holds the
# gradients leaf by leaf.
TRAIN_LOSS_AGREE, TRAIN_LOSS_AGREED = 3e-2, 4
# The f32 training reference: B=8 at 224x224, a learning rate at which
# the loss falls about linearly (BN makes the loss scale-free in the
# small He-init conv weights: the gradient is large) and the updates
# stay far above the f32 spacing of the parameters (at 1e-7 one ulp of a
# BN gain near 1 is 4% of the largest update), two steps. The kernels
# against the plain versions and the fused plan against the xla plan
# within TRAIN_REF_LIMIT in the parameters and the velocity (f32 sums in
# other orders through 53 layers with batch statistics: at most 0.104,
# the velocity of one s4 3x3 conv against the plain versions; the
# planted fault reads 1.16 and more); the BN running statistics, a
# forward quantity, within TRAIN_REF_STATE (1.3e-4 read).
TRAIN_REF_B, TRAIN_REF_LR, TRAIN_REF_STEPS = 8, 1e-6, 2
TRAIN_REF_LIMIT, TRAIN_REF_STATE = 0.3, 1e-2
#: the planted fault's block, counted in the backward's order (from the
#: output): s4b4, the fifth
TRAIN_REF_PLANTED = 4


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
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    from deeplearning4j_tpu_torch.nn.layers import stem
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION, PAGED_ATTENTION_QUANT)
    return {"paged_attention": PAGED_ATTENTION,
            "paged_attention_quant": PAGED_ATTENTION_QUANT,
            "flash_fwd": fa.FLASH_FWD,
            "flash_bwd_dq": fa.FLASH_BWD_DQ,
            "flash_bwd_dkv": fa.FLASH_BWD_DKV, "conv1x1": bn.CONV1X1,
            "conv3x3": bn.CONV3X3, "stem_conv": stem.STEM_CONV,
            "stem_pool": stem.STEM_POOL, "bwd1x1": bn.BWD1X1,
            "bwd3x3": bn.BWD3X3, "stem_bwd_pool": stem.STEM_BWD_POOL,
            "stem_bwd_dw": stem.STEM_BWD_DW, "stem_bwd_dx": stem.STEM_BWD_DX}


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
# phase 3c: the int8 paged-decode kernel against its plain version
# ---------------------------------------------------------------------
def quant_case(S, hkv, reps, W, D, ps, n_max, lengths, dtype, device, seed):
    """paged_case's pools quantized per (page, head) as the int8 pool
    stores them: (q, k int8, v int8, table, lengths, k scales, v
    scales)."""
    from deeplearning4j_tpu_torch.serving.quant import pow2ceil, quantize
    q, kp, vp, table, lens = paged_case(S, hkv, reps, W, D, ps, n_max,
                                        lengths, torch.float32, device,
                                        seed)
    vp = vp * 3.0                       # a V scale unlike the K scale
    ks = pow2ceil(kp.abs().amax(dim=(2, 3)) / 127.0)
    vs = pow2ceil(vp.abs().amax(dim=(2, 3)) / 127.0)
    return (q.to(dtype), quantize(kp, ks[:, :, None, None]),
            quantize(vp, vs[:, :, None, None]), table, lens, ks, vs)


def quant_bound(q, kq, ks, lengths, W):
    """paged_bound for the int8 pool: the live K and V tokens at one
    byte a value, each live page's K and V scale of its head once, the
    queries and output, the live table entries and the lengths; against
    the multiply-adds over the peak rate for the query dtype."""
    S, hkv, rw, D = q.shape
    ps = kq.shape[2]
    el = q.element_size()
    lens = [int(x) for x in lengths.cpu()]
    pages = sum(-(-ln // ps) for ln in lens)
    nbytes = (2 * q.numel() * el + sum(lens) * hkv * D * 2
              + pages * hkv * 2 * ks.element_size() + pages * 4 + 4 * S)
    reps = rw // W
    keys = sum(reps * max(0, ln - W + w + 1) for ln in lens
               for w in range(W))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4.0 * keys * D * hkv / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def quant_plain_fault(fault):
    """The int8 plain version with one planted fault: the V scale
    dropped, or p rounded to bf16 before the PV product (the int8
    kernel keeps p in f32)."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    from deeplearning4j_tpu_torch.serving.quant import dequantize

    def faulty(q, kq, vq, table, lengths, *, query_width, k_scales,
               v_scales):
        kd = dequantize(kq, k_scales[:, :, None, None])
        if fault == "no_v_scale":
            return pk.paged_attention_plain(q, kd, vq.float(), table,
                                            lengths, query_width=query_width)
        vd = dequantize(vq, v_scales[:, :, None, None], torch.bfloat16)
        out = pk.paged_attention_plain(q.float(), kd.bfloat16(), vd, table,
                                       lengths, query_width=query_width)
        return out.to(q.dtype)
    return faulty


def check_paged_quant_kernel(device, rng):
    """The int8 kernel against its plain version at the engine shape and
    the GQA/verify shape, bf16 and f32 queries, with the kernel's, the
    plain version's and SDPA's times (SDPA on the dequantized dense view,
    its gather outside the time, as row 15's) beside the bound; the
    limits shown to fail two faults planted in the plain version."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    from deeplearning4j_tpu_torch.serving.quant import dequantize
    F = torch.nn.functional
    shapes = [("engine", dict(S=SLOTS, hkv=HEADS, reps=1, W=1)),
              ("gqa_verify", dict(S=SLOTS, hkv=2, reps=4, W=5))]
    cases = []
    for label, shp in shapes:
        lengths = rng.integers(16, 300 + NEW_TOKENS + 1, shp["S"])
        for dtype in (torch.bfloat16, torch.float32):
            args = quant_case(D=WIDTH // HEADS, ps=PAGE,
                              n_max=MAX_LEN // PAGE, lengths=lengths,
                              dtype=dtype, device=device,
                              seed=10 + len(cases), **shp)
            q, kq, vq, table, lens, ks, vs = args
            W = shp["W"]
            kw = dict(query_width=W, k_scales=ks, v_scales=vs)
            out = pk.paged_attention(q, kq, vq, table, lens, **kw)
            torch.cuda.synchronize()
            ref = pk.paged_attention_quant_plain(q, kq, vq, table, lens,
                                                 **kw)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            planted = {}
            for fault in ("no_v_scale", "p_bf16"):
                bad = quant_plain_fault(fault)(q, kq, vq, table, lens, **kw)
                planted[fault] = float((bad.float() - ref.float()).abs()
                                       .max())
            kd = dequantize(kq, ks[:, :, None, None], dtype)
            vd = dequantize(vq, vs[:, :, None, None], dtype)
            dk, dv, mask = sdpa_inputs(q, kd, vd, table, lens, W=W)
            lib = F.scaled_dot_product_attention(q, dk, dv, attn_mask=mask)
            lib_err = float((lib.float() - ref.float()).abs().max())
            ms = median_ms(lambda: pk.paged_attention(q, kq, vq, table,
                                                      lens, **kw), device)
            plain_ms = median_ms(lambda: pk.paged_attention_quant_plain(
                q, kq, vq, table, lens, **kw), device)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, dk, dv, attn_mask=mask), device)
            bound_ms, bound_by = quant_bound(q, kq, ks, lens, W)
            case = {"shape": label, "dtype": str(dtype).split(".")[-1],
                    "q": list(q.shape), "pool": list(kq.shape),
                    "lengths": [int(x) for x in lengths],
                    "max_abs_err": err, "tolerance": QUANT_TOLERANCE[dtype],
                    "planted": planted, "finite": finite, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                    "bound_by": bound_by}
            log("paged_attention_quant", json.dumps(case))
            if not finite or err > QUANT_TOLERANCE[dtype]:
                raise AssertionError(f"int8 paged kernel disagrees with its "
                                     f"plain version: {case}")
            # the V scale dropped fails every case; p in bf16 the f32 ones
            # (with bf16 queries the output's own rounding hides it)
            caught = ["no_v_scale"] + (["p_bf16"] if dtype == torch.float32
                                       else [])
            if any(planted[f] <= QUANT_TOLERANCE[dtype] for f in caught):
                raise AssertionError(f"a planted fault passes the int8 "
                                     f"limit: {case}")
            cases.append(case)
    # edge rows: a 0-length row, a 1-token row, a row filling its table;
    # and a page id outside the pool turns its (slot, head) to NaN
    for dtype in (torch.bfloat16, torch.float32):
        lengths = [0, 1, 17, MAX_LEN]
        q, kq, vq, table, lens, ks, vs = quant_case(
            S=4, hkv=2, reps=4, W=1, D=WIDTH // HEADS, ps=PAGE,
            n_max=MAX_LEN // PAGE, lengths=lengths, dtype=dtype,
            device=device, seed=98)
        kw = dict(query_width=1, k_scales=ks, v_scales=vs)
        out = pk.paged_attention(q, kq, vq, table, lens, **kw)
        ref = pk.paged_attention_quant_plain(q, kq, vq, table, lens, **kw)
        bad_table = table.clone()
        bad_table[2, 0] = kq.shape[0]
        poisoned = pk.paged_attention(q, kq, vq, bad_table, lens, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        log(f"paged_attention_quant edge rows {lengths} {dtype}: "
            f"max_abs_err {err}")
        if not bool(torch.isfinite(out).all()) or bool(out[0].any()) or \
                err > QUANT_TOLERANCE[dtype] or \
                not bool(torch.isnan(poisoned[2]).all()) or \
                not torch.equal(poisoned[3], out[3]):
            raise AssertionError(f"int8 paged kernel edge rows: err {err}")
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
def serve_requests(rng):
    """The served traffic: N_REQUESTS prompts of 16..300 tokens, a
    quarter of them sharing a system prefix, most greedy, some sampled
    (top-k, top-p)."""
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
    return requests


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
    requests = serve_requests(rng)
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


def profile_decode(device, rng, steps=20, kv_dtype="bf16"):
    """Where a decode step's time goes, with all 8 slots of the served
    configuration decoding (no admission in the window). First the wall
    ms per step as shipped, then with one part swapped out (what the
    step would cost without it; measurements only, outside the counted
    serve run): the paged kernel for its plain version, and the
    op-by-op gelu and softmax (the JAX package's rounding points) for
    torch's fused ops; then as shipped again. Then ``torch.profiler``
    over ``steps`` steps: the device's busy share (kernel time over wall
    time, one stream), CUDA kernel launches per step and the kernels
    with the most device time. ``kv_dtype`` is the pool's ("int8" in the
    serve int8 phase)."""
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
                              paging=PagedKVConfig(page_size=PAGE,
                                                   kv_dtype=kv_dtype),
                              device=device)
    for _ in range(SLOTS):
        engine.submit([int(t) for t in rng.integers(1, VOCAB, 200)],
                      steps=5 * steps + 8, top_k=1)
    for _ in range(3):          # admit all, then two plain decode steps
        engine.step()
    F = torch.nn.functional

    def plain(*args, k_scales=None, v_scales=None, **kw):
        if k_scales is None:
            return pk.paged_attention_plain(*args, **kw)
        return pk.paged_attention_quant_plain(
            *args, k_scales=k_scales, v_scales=v_scales, **kw)

    swaps = {
        "plain_attention": (vars(pk), {"paged_attention": plain}),
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
    if not engine.is_healthy() or \
            sum(r is not None for r in engine._slots) != SLOTS:
        raise AssertionError(f"profile: the engine stopped decoding "
                             f"({engine._broken!r})")
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
                    if "paged_decode" in k) / busy_us
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
# phases 6b-6c: int8 KV serving at full width, and its f32 reference
# ---------------------------------------------------------------------
def served_net(device, layers=None, dtype="bfloat16", seed=7):
    """Phase 4's served rope transformer (``layers`` cut for the
    references), random weights from ``seed``."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationTransformer
    model = TextGenerationTransformer(
        vocab_size=VOCAB, embed_dim=WIDTH, n_heads=HEADS,
        n_layers=layers or LAYERS,
        ffn_mult=4, max_length=MAX_LEN, positional="rope", seed=seed)
    net = model.init(device=device)
    net.conf.dtype = dtype
    return model, net


def serve_turn(engine, requests):
    """Serve ``requests`` through a warmed engine's background loop;
    returns the turn's numbers (tokens/s, the decode dispatches' mean
    ms, TTFT and TPOT p50, peak device memory) and the launches."""
    engine.ttft_s.clear()
    engine.tpot_s.clear()
    d0, s0 = engine.dispatches, engine.dispatch_s_total
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    engine.start()
    t0 = time.perf_counter()
    handles = [engine.submit(p, steps=NEW_TOKENS,
                             rng=np.random.default_rng(i), **kw)
               for i, (p, kw) in enumerate(requests)]
    outs = [h.result(timeout=600) for h in handles]
    dt = time.perf_counter() - t0
    engine.shutdown()
    counts = read_counts()
    dispatches = engine.dispatches - d0
    generated = sum(len(o) - len(p) for o, (p, _) in zip(outs, requests))
    reasons = [h.finish_reason for h in handles]
    if reasons != ["length"] * len(requests) or \
            generated != len(requests) * NEW_TOKENS:
        raise AssertionError(f"serve: reasons {reasons}, {generated} tokens")
    return {"tokens_per_s": generated / dt, "wall_s": dt,
            "decode_dispatches": dispatches,
            "decode_step_ms": 1e3 * (engine.dispatch_s_total - s0)
            / max(1, dispatches),
            "ttft_p50_ms": 1e3 * float(np.median([h.ttft_s
                                                  for h in handles])),
            "tpot_p50_ms": 1e3 * float(np.median(engine.tpot_s)),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts}


def serve_int8(device):
    """Phase 4's configuration with ``kv_dtype="int8"``: the same
    requests through the int8 engine and the bf16 engine in turns (int8,
    bf16, bf16, int8), every int8 decode dispatch launching the int8
    kernel once per layer and row 15's kernel never; the pages the bf16
    pool's byte budget buys under int8; ``kv_dtype="auto"`` resolving as
    a temporary store's verdict implies (the turns' measured verdict,
    another card's entry, a synthetic win)."""
    import tempfile
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.serving.quant import kv_page_bytes
    from deeplearning4j_tpu_torch.tuning import (
        KernelCrossoverStore, reset_default_store, winner)
    _, net = served_net(device)
    requests = serve_requests(np.random.default_rng(1))
    engines = {}
    turns = {"int8": [], "bf16": []}
    for kv in ("int8", "bf16", "bf16", "int8"):
        eng = engines[kv] = GenerationEngine(
            net, VOCAB, slots=SLOTS, device=device,
            paging=PagedKVConfig(page_size=PAGE, kv_dtype=kv))
        eng.warmup(max_prompt_len=300)
        rec = serve_turn(eng, requests)
        n = rec["decode_dispatches"]
        want = {"paged_attention_quant": n * LAYERS if kv == "int8" else 0,
                "paged_attention": 0 if kv == "int8" else n * LAYERS}
        got = {k: rec["launches"][k] for k in want}
        if n == 0 or got != want:
            raise AssertionError(f"serve int8: {kv} turn launched {got}, "
                                 f"want {want}")
        turns[kv].append(rec)
        log(f"serve {kv} turn:", json.dumps(
            {k: v for k, v in rec.items() if k != "launches"}))
    med = {kv: {k: float(np.median([r[k] for r in rs]))
                for k in ("tokens_per_s", "decode_step_ms", "ttft_p50_ms",
                          "tpot_p50_ms", "max_memory_allocated_bytes")}
           for kv, rs in turns.items()}
    # the bf16 pool's byte budget, spent on int8 pages
    e16 = engines["bf16"]
    dims = [(h, d) for _, h, d in e16._paged_layer_dims()]
    budget = e16.page_pool.usable * kv_page_bytes(dims, PAGE, "bf16",
                                                  "bfloat16")
    e8 = GenerationEngine(net, VOCAB, slots=SLOTS, device=device,
                          paging=PagedKVConfig(page_size=PAGE,
                                               kv_dtype="int8",
                                               total_bytes=budget))
    pages = {"bf16": e16.page_pool.usable, "int8": e8.page_pool.usable,
             "budget_bytes": budget}
    if pages["int8"] < 1.9 * pages["bf16"]:
        raise AssertionError(f"serve int8: pages {pages}")
    # kv_dtype="auto" through a store in a temporary directory
    auto = {}
    key = engines["int8"]._quant_key
    with tempfile.TemporaryDirectory(prefix="dl4j_crossover_") as tmp:
        measured = KernelCrossoverStore(path=tmp + "/measured.json")
        entry = measured.record(key, med["int8"]["decode_step_ms"],
                                med["bf16"]["decode_step_ms"], device=device)
        foreign = KernelCrossoverStore(path=tmp + "/foreign.json", entries={
            key: {**entry, "kernel_ms": 1.0, "fallback_ms": 2.0,
                  "device_kind": "another card"}})
        synthetic = KernelCrossoverStore(path=tmp + "/synthetic.json")
        synthetic.record(key, 1.0, 2.0, device=device)
        for label, store, want in (
                ("measured", measured,
                 "int8" if winner(entry) == "kernel" else "bf16"),
                ("foreign", foreign, "bf16"),
                ("synthetic", synthetic, "int8")):
            reset_default_store(store)
            try:
                eng = GenerationEngine(net, VOCAB, slots=SLOTS, device=device,
                                       paging=PagedKVConfig(
                                           page_size=PAGE, kv_dtype="auto"))
            finally:
                reset_default_store(None)
            auto[label] = {"kv_dtype": eng._kv_dtype, "want": want}
            if eng._kv_dtype != want:
                raise AssertionError(f"kv_dtype='auto' with the {label} "
                                     f"store resolved {eng._kv_dtype}")
    del engines, e16, e8
    torch.cuda.empty_cache()
    rec = {"turns": turns, "median": med, "pages": pages, "auto": auto,
           "quant_key": key,
           "launches": turns["int8"][-1]["launches"],
           "profile": profile_decode(device, np.random.default_rng(2),
                                     kv_dtype="int8")}
    log("serve int8:", json.dumps({"median": med, "pages": pages,
                                   "auto": auto,
                                   "profile": rec["profile"]}))
    return rec


def quant_reference(device):
    """In f32 with 2 layers at the served width, the int8 engine with
    the kernel against the same engine with the kernel's plain version
    swapped in: the same greedy streams; and a prefix hit equals a miss
    (the prompts sharing two full pages)."""
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    _, net = served_net(device, layers=2, dtype="float32", seed=11)
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, VOCAB, 2 * PAGE)]
    prompts = [shared + [int(t) for t in rng.integers(1, VOCAB, n)]
               for n in (5, 40, 1)] + \
        [[int(t) for t in rng.integers(1, VOCAB, n)] for n in (40, 9)]

    def plain(q, kp, vp, table, lengths, *, query_width, k_scales=None,
              v_scales=None):
        return pk.paged_attention_quant_plain(
            q, kp, vp, table, lengths, query_width=query_width,
            k_scales=k_scales, v_scales=v_scales)

    def run(prefix_cache, swaps=()):
        eng = GenerationEngine(net, VOCAB, slots=SLOTS, device=device,
                               paging=PagedKVConfig(
                                   page_size=PAGE, kv_dtype="int8",
                                   prefix_cache=prefix_cache))
        zero_counts()
        hs = [eng.submit(p, steps=32, top_k=1) for p in prompts]
        with_swaps(swaps, eng.run_until_idle)
        hits = eng.prefix_cache.hits if prefix_cache else 0
        return ([h.result(timeout=0) for h in hs],
                read_counts()["paged_attention_quant"], hits)

    kernel, launched, hits = run(True)
    swapped, launched_plain, _ = run(True, [(vars(pk),
                                             {"paged_attention": plain})])
    miss, _, _ = run(False)
    rec = {"dtype": "float32", "layers": 2, "kernel_launches": launched,
           "plain_launches": launched_plain, "prefix_hits": hits,
           "kernel_equals_plain": kernel == swapped,
           "hit_equals_miss": kernel == miss}
    log("int8 reference:", json.dumps(rec))
    if not rec["kernel_equals_plain"] or not rec["hit_equals_miss"] or \
            launched == 0 or launched_plain != 0 or hits < 2:
        raise AssertionError(f"int8 reference: {rec}")
    return rec


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


# ---------------------------------------------------------------------
# phase 10: the ResNet50 forward kernels against their plain versions
# ---------------------------------------------------------------------
#: name: (kernel, geometry at the inference path's shapes)
CNN_CASES = {
    "s2_conv_c": ("conv1x1", dict(h=56, w=56, c=64, k=256, stride=1,
                                  act="relu")),
    "s3b0_conv_a": ("conv1x1", dict(h=56, w=56, c=256, k=128, stride=2,
                                    act="identity")),
    "s2_conv_b": ("conv3x3", dict(h=56, w=56, c=64, k=64, act="relu")),
    "s5_conv_b": ("conv3x3", dict(h=7, w=7, c=512, k=512, act="relu")),
    "stem_conv": ("stem_conv", dict(h=224, w=224, c=3, k=64)),
    "stem_pool": ("stem_pool", dict(h=112, w=112, k=64)),
}


def cnn_inputs(kernel, geo, n, dtype, device, seed):
    """Seeded inputs at a case's shape: x (NHWC), and the prologue's
    (sc, bb) and the weight where the kernel takes them. A relu
    prologue normalizes a raw conv output (per-channel mean and scale
    drawn) and zeroes about half of it; an identity prologue reads a
    post-relu block input; weights are He-normal."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    h, w = geo["h"], geo["w"]
    if kernel == "stem_pool":
        k = geo["k"]
        y = randn(n, h, w, k).to(device, dtype)
        sc = (0.5 + torch.rand(k, generator=g)).to(device)
        bb = (0.3 * randn(k)).to(device)
        return {"y": y, "sc": sc, "bb": bb}
    c, k = geo["c"], geo["k"]
    if kernel == "stem_conv":
        w7 = randn(k, c, 7, 7) * (2.0 / (49 * c)) ** 0.5
        return {"x": randn(n, h, w, c).to(device, dtype),
                "w7": w7.to(device, dtype)}
    taps = 9 if kernel == "conv3x3" else 1
    if geo["act"] == "relu":
        mean, std = 0.3 * randn(c), 0.5 + torch.rand(c, generator=g)
        x = mean + std * randn(n, h, w, c)
        sc = (0.5 + torch.rand(c, generator=g)) / std
        bb = 0.2 * randn(c) - mean * sc
    else:
        x = torch.clamp_min(randn(n, h, w, c), 0.0)
        sc, bb = torch.ones(c), torch.zeros(c)
    wshape = (9, c, k) if taps == 9 else (c, k)
    wt = randn(*wshape) * (2.0 / (taps * c)) ** 0.5
    return {"x": x.to(device, dtype), "sc": sc.to(device),
            "bb": bb.to(device), "w": wt.to(device, dtype)}


def cnn_fns(kernel, geo, a):
    """(kernel call, plain call, library call, the plain version without
    the rounding of the activated input or None) on inputs ``a``; the
    library call's operands are made here, outside its time."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    F = torch.nn.functional
    if kernel == "stem_pool":
        y, sc, bb = a["y"], a["sc"], a["bb"]
        z = torch.clamp_min(y.float() * sc + bb, 0.0).to(y.dtype) \
            .permute(0, 3, 1, 2)
        return (lambda: stem.stem_pool(y, sc, bb),
                lambda: stem.stem_pool_plain(y, sc, bb),
                lambda: F.max_pool2d(z, 3, 2, 1), None)
    if kernel == "stem_conv":
        x, w7 = a["x"], a["w7"]
        ws = stem.stem_weight_s2d(w7)
        xn = x.permute(0, 3, 1, 2)
        return (lambda: stem.stem_conv(x, ws),
                lambda: stem.stem_conv_plain(x, ws),
                lambda: F.conv2d(xn, w7, stride=2, padding=3), None)
    x, sc, bb, w = a["x"], a["sc"], a["bb"], a["w"]
    act = geo["act"]
    z = bn._prologue(x, sc, bb, act, w.dtype).to(w.dtype)
    if kernel == "conv3x3":
        c, k = geo["c"], geo["k"]
        w4 = w.reshape(3, 3, c, k).permute(3, 2, 0, 1).contiguous()
        zn = z.permute(0, 3, 1, 2)
        return (lambda: bn.conv3x3(x, sc, bb, w, act=act),
                lambda: bn.conv3x3_plain(x, sc, bb, w, act=act),
                lambda: F.conv2d(zn, w4, padding=1),
                lambda: bn.conv3x3_plain(x, sc, bb, w.float(), act=act))
    s = geo["stride"]
    z2 = z[:, ::s, ::s, :].reshape(-1, geo["c"]).contiguous()
    # an identity prologue rounds nothing (x is already in w's dtype)
    return (lambda: bn.conv1x1(x, sc, bb, w, act=act, stride=s),
            lambda: bn.conv1x1_plain(x, sc, bb, w, act=act, stride=s),
            lambda: torch.matmul(z2, w),
            (lambda: bn.conv1x1_plain(x, sc, bb, w.float(), act=act,
                                      stride=s)) if act == "relu" else None)


def cnn_bound(kernel, geo, n, dtype):
    """Least time on this card: the bytes the function must move (the
    inputs it needs once, the output and sums once) over the memory
    rate, against its multiply-adds over the dtype's peak (for the stem
    conv the 7x7 taps, not the zero-extended 8x8's). Returns (ms,
    "bytes" | "operations")."""
    el = 2 if dtype == torch.bfloat16 else 4
    h, w, k = geo["h"], geo["w"], geo["k"]
    if kernel == "stem_pool":
        po, pw = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        nbytes = (n * h * w * k + n * po * pw * k) * el + 2 * k * 4
        ops = 2 * n * h * w * k + 9 * n * po * pw * k
        peak = PEAK_FLOPS[torch.float32]
    else:
        c = geo["c"]
        if kernel == "stem_conv":
            ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            red, x_el, w_el = 49 * c, n * h * w * c, 49 * c * k
        else:
            s = geo.get("stride", 1)
            ho, wo = h // s, w // s
            red = 9 * c if kernel == "conv3x3" else c
            x_el = n * ho * wo * c if kernel == "conv1x1" else n * h * w * c
            w_el = red * k
        m = n * ho * wo
        nbytes = (x_el + w_el + m * k) * el + 2 * k * 4 + (
            0 if kernel == "stem_conv" else 2 * c * 4)
        ops = 2 * m * red * k
        peak = PEAK_FLOPS[dtype]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def conv_agreement(out, ref):
    """flash_attention.agreement over output rows (one pixel's channels)
    and 64-row tiles."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    k = out.shape[-1]
    return fa.agreement(out.reshape(1, 1, -1, k), ref.reshape(1, 1, -1, k))


def cnn_case(name, dtype, n, device, seed):
    """One case: the kernel against its plain version on the same
    inputs, and the kernel's, plain version's and library call's times
    beside the bound."""
    kernel, geo = CNN_CASES[name]
    a = cnn_inputs(kernel, geo, n, dtype, device, seed)
    kern, plain, library, unrounded = cnn_fns(kernel, geo, a)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    case = {"case": name, "kernel": kernel, "dtype": str(dtype).split(".")[-1],
            "batch": n, **geo}
    failures = []
    if kernel == "stem_pool":
        case["max_abs_err"] = float((got.float() - ref.float()).abs().max())
        case["limits"] = {"max_abs_err": 0.0}
        finite = bool(torch.isfinite(got).all())
        if case["max_abs_err"] != 0.0:
            failures.append("pool")
    else:
        (o, s1, s2), (ro, rs1, rs2) = got, ref
        finite = all(bool(torch.isfinite(t).all()) for t in (o, s1, s2))
        row_rel, tile_rel = conv_agreement(o, ro)
        # the epilogue's sums against torch's sums of the kernel's own
        # stored output (the plain version's output differs by the
        # flips, and so do its sums)
        from deeplearning4j_tpu_torch.nn.layers.bottleneck import _stats
        ts1, ts2 = _stats(o)
        absum = o.float().reshape(-1, o.shape[-1]).abs().sum(0)
        sums_rel = max(float(((s1 - ts1).abs() / absum.clamp_min(1e-30))
                             .max()),
                       float(((s2 - ts2).abs() / ts2.abs().clamp_min(1e-30))
                             .max()))
        case["sums_rel_vs_plain"] = float(
            ((s1 - rs1).abs() / absum.clamp_min(1e-30)).max())
        case.update(max_abs_err=float((o.float() - ro.float()).abs().max()),
                    row_rel=row_rel, tile_rel=tile_rel, sums_rel=sums_rel,
                    limits={"row_rel": CONV_ROW[dtype],
                            "tile_rel": CONV_TILE[dtype],
                            "sums_rel": CONV_SUMS})
        if row_rel > CONV_ROW[dtype] or tile_rel > CONV_TILE[dtype]:
            failures.append("output")
        if sums_rel > CONV_SUMS:
            failures.append("sums")
        if dtype == torch.bfloat16 and unrounded is not None:
            # the limits' power: the plain version without the rounding
            # of the activated input (z in f32), its output rounded as
            # the kernel stores it, fails the tile limit
            u = unrounded()[0].to(dtype)
            case["unrounded_tile_rel"] = conv_agreement(u, ro)[1]
            if case["unrounded_tile_rel"] <= CONV_TILE[dtype]:
                failures.append("the limit does not tell z unrounded")
            del u
    log("cnn check", json.dumps(case))
    if not finite or failures:
        raise AssertionError(f"{kernel} kernel disagrees with its plain "
                             f"version ({failures}, finite {finite}): {case}")
    del got, ref
    bound_ms, bound_by = cnn_bound(kernel, geo, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    log("cnn", json.dumps(case))
    del a, kern, plain, library, unrounded
    torch.cuda.empty_cache()
    return case


def check_tile_guard(device):
    """The conv launcher refuses partial sums one row tile short of the
    grid (a CUDA error, no launch) instead of writing past them."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    x = torch.zeros((2, 16, 16, 64), dtype=torch.bfloat16, device=device)
    w = torch.zeros((64, 64), dtype=torch.bfloat16, device=device)
    one = torch.ones(64, device=device)
    out, part, tiles, sums = bn._outputs(bn._LIBRARY, x, 2, 16, 16, 64)
    before = bn.CONV1X1.launches
    try:
        bn.CONV1X1.launch(x.dtype, x.data_ptr(), one.data_ptr(),
                          one.data_ptr(), w.data_ptr(), out.data_ptr(),
                          part[0].data_ptr(), part[1].data_ptr(),
                          sums[0].data_ptr(), sums[1].data_ptr(), 2, 16, 16,
                          64, 64, 1, 0, tiles - 1, bn._stream(x))
    except RuntimeError as e:
        assert bn.CONV1X1.launches == before, "a refused launch counted"
        log(f"cnn tile guard: {tiles - 1} of {tiles} tiles refused ({e})")
        return
    raise AssertionError("conv1x1 took partial sums one tile short")


def check_cnn_kernels(device):
    """Every case in bf16 at the main path's batch, then in f32 at 16."""
    check_tile_guard(device)
    return [cnn_case(name, dtype, n, device, seed=i)
            for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16))
            for i, name in enumerate(CNN_CASES)]


# ---------------------------------------------------------------------
# phases 11-12: ResNet50 inference through ComputationGraph.output
# ---------------------------------------------------------------------
def calibrate_bn(net, x):
    """Set every BN's running statistics to the batch statistics of its
    input over ``x`` (one f32 pass of the unfused graph, vertex by
    vertex): random weights with the init's zeros and ones would blow
    the activations up and saturate the softmax."""
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    acts = {net.conf.network_inputs[0]: x}
    with torch.no_grad():
        for name in net._topo:
            v = net.conf.vertices[name]
            xs = [acts[i] for i in net.conf.vertex_inputs[name]]
            if isinstance(getattr(v, "layer", None), BatchNormalization):
                dims = (0, 1, 2) if v.layer.data_format == "NHWC" \
                    else (0, 2, 3)
                net.state[name] = {"mean": xs[0].mean(dims),
                                   "var": xs[0].var(dims, unbiased=False)}
            acts[name], _ = v.apply(net.params[name], xs, net.state[name])


def resnet_net(device, dtype):
    """bench_all.py's bench_train_plan ResNet50 on the fused plan with
    the stem: 1000 classes, 224x224, NHWC, Nesterovs(0.1, 0.9), random
    weights from seed 7, BN statistics calibrated on 16 seeded images."""
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.tuning import apply_execution_plan
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW,
                   width=RESNET_HW, seed=7,
                   updater=Nesterovs(0.1, momentum=0.9), data_format="NHWC",
                   execution_plan="fused").init(device=device)
    net.set_fusion(False)
    cal = np.random.default_rng(7).standard_normal(
        (16, 3, RESNET_HW, RESNET_HW)).astype(np.float32)
    calibrate_bn(net, torch.as_tensor(cal, device=device))
    net.conf.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    apply_execution_plan(net, "fused")
    net.set_fusion("bottleneck", stem=True)
    return net


def images(n, device, seed):
    x = np.random.default_rng(seed).standard_normal(
        (n, 3, RESNET_HW, RESNET_HW)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def plain_swapped():
    """The four kernels' wrappers swapped for their plain versions (as
    (module dict, {name: function}) pairs for ``swap``)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    return [(vars(bn), {"conv1x1": bn.conv1x1_plain,
                        "conv3x3": bn.conv3x3_plain}),
            (vars(stem), {"stem_conv": stem.stem_conv_plain,
                          "stem_pool": stem.stem_pool_plain})]


def with_swaps(swaps, fn):
    old = [(table, {k: table[k] for k in new}) for table, new in swaps]
    for table, new in swaps:
        table.update(new)
    try:
        return fn()
    finally:
        for table, saved in old:
            table.update(saved)


def output_s(net, x):
    """Wall seconds of one output() that ends in a host read of the
    probabilities, and the probabilities."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = net.output(x).cpu()
    return time.perf_counter() - t0, probs


def logits(net, x):
    """The output layer's values before the softmax (f32, on the host),
    of the inference forward under the selected plan."""
    out = net.conf.network_outputs[0]
    with torch.no_grad():
        acts, _ = net._forward(net._compute_params(), net.state,
                               net._as_input_dict([x]), preout_of={out})
    return acts[out].float().cpu()


def logit_rel(a, b):
    """The worst row's largest |a - b| over that row's spread in b."""
    a, b = a.double(), b.double()
    spread = (b.max(dim=1).values - b.min(dim=1).values).clamp_min(1e-30)
    return float(((a - b).abs().max(dim=1).values / spread).max())


def planted(fault):
    """Swaps (for ``with_swaps``) that plant ``fault`` (PLANTED) in one
    block of the fused forward; the block still runs through the
    kernels."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    conv1x1, conv3x3, target = bn.conv1x1, bn.conv3x3, PLANTED[fault]
    seen = [0]

    def no_relu(x, sc, bb, w, *, act="identity", stride=1):
        if act == "relu":            # conv_c: a block's one relu 1x1
            seen[0] += 1
            if seen[0] - 1 == target:
                act = "identity"
        return conv1x1(x, sc, bb, w, act=act, stride=stride)

    def pad_relu_bb(x, sc, bb, w, *, act="identity"):
        seen[0] += 1
        if seen[0] - 1 != target:
            return conv3x3(x, sc, bb, w, act=act)
        # zero pixels around the image, whose prologue is relu(bb); the
        # interior of the output over them
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1)).contiguous()
        o, s1, s2 = conv3x3(xp, sc, bb, w, act=act)
        return o[:, 1:-1, 1:-1, :].contiguous(), s1, s2

    if fault == "conv_c_no_relu":
        return [(vars(bn), {"conv1x1": no_relu})]
    return [(vars(bn), {"conv3x3": pad_relu_bb})]


def logit_check(net, x, ref, dtype, rec, failures):
    """The fused forward's logits against ``ref`` within
    RESNET_LOGIT[dtype], and every planted fault's beyond it."""
    limit = RESNET_LOGIT[dtype]
    rec["logit_rel"] = logit_rel(logits(net, x), ref)
    rec["logit_rel_limit"] = limit
    rec["logit_rel_planted"] = {
        f: logit_rel(with_swaps(planted(f), lambda: logits(net, x)), ref)
        for f in PLANTED}
    if rec["logit_rel"] > limit:
        failures.append("logits disagree")
    for f, v in rec["logit_rel_planted"].items():
        if v <= limit:
            failures.append(f"the limit does not tell the planted {f}")


def resnet(device):
    """The ResNet50 inference path at full width: counted forward,
    agreement with the plain versions, images/s of the fused and xla
    plans in turns, peak memory, one profiled forward."""
    from torch.profiler import ProfilerActivity, profile
    net = resnet_net(device, torch.bfloat16)
    x = images(RESNET_B, device, seed=8)
    t0 = time.perf_counter()
    net.output(x)
    warm_s = time.perf_counter() - t0
    zero_counts()
    _, probs = output_s(net, x)
    counts = read_counts()
    rec = {"config": {"model": "ResNet50", "classes": RESNET_CLASSES,
                      "hw": RESNET_HW, "batch": RESNET_B,
                      "dtype": "bfloat16", "data_format": "NHWC",
                      "plan": "fused + stem",
                      "fused_blocks": len(net._fusion()[1]),
                      "stem": bool(net._fusion()[2])},
           "warmup_s": warm_s, "launches": counts}
    failures = []
    if tuple(probs.shape) != (RESNET_B, RESNET_CLASSES) or \
            not bool(torch.isfinite(probs).all()):
        failures.append("probabilities not finite or misshapen")
    rec["row_sum_max_dev"] = float((probs.double().sum(1) - 1).abs().max())
    rec["max_probability"] = float(probs.max())
    if rec["row_sum_max_dev"] > RESNET_ROW_SUM:
        failures.append("rows do not sum to 1")
    for name, want in RESNET_LAUNCHES.items():
        if counts[name] != want:
            failures.append(f"{name} launched {counts[name]}, want {want}")
    zero_counts()
    plain = with_swaps(plain_swapped(), lambda: logits(net, x))
    rec["plain_launches"] = {n: c for n, c in read_counts().items()
                             if n in RESNET_LAUNCHES}
    if any(rec["plain_launches"].values()):
        failures.append("the plain versions launched a kernel")
    logit_check(net, x, plain, torch.bfloat16, rec, failures)
    # images/s: the fused and xla plans in turns (fused, xla, fused, xla)
    times = {"fused": [], "xla": []}
    for _ in range(2):
        for plan in ("fused", "xla"):
            if plan == "fused":
                net.set_fusion("bottleneck", stem=True)
            else:
                net.set_fusion(False)
            net.output(x)
            for _ in range(RESNET_TIMED):
                times[plan].append(output_s(net, x)[0])
    net.set_fusion(False)
    rec["logit_rel_xla_vs_plain"] = logit_rel(logits(net, x), plain)
    net.set_fusion("bottleneck", stem=True)
    for plan, ts in times.items():
        med = float(np.median(ts))
        rec[plan] = {"output_ms": [1e3 * t for t in ts],
                     "output_ms_median": 1e3 * med,
                     "images_per_s": RESNET_B / med}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    net.output(x)
    rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
        device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = output_s(net, x)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy_us = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    rec["profile"] = {
        "output_ms": 1e3 * wall, "device_busy_share": busy_us / (wall * 1e6),
        "kernel_launches": sum(e.count for e in kernels),
        "conv_kernels_share_of_device_time": (
            sum(t for k, t in dev_us.items() if "conv_gemm" in k
                or "stem_pool" in k or "reduce_partials" in k) / busy_us
            if busy_us else None),
        "top_kernels_us": [[k[:80], t] for k, t in top]}
    log("resnet:", json.dumps(rec))
    if failures:
        raise AssertionError(f"resnet: {failures}: {rec}")
    return rec


def resnet_reference(device):
    """f32 at B=8: the fused plan with the stem (the kernels) against the
    xla plan (cuDNN convolutions, TF32 off) of the same graph, by their
    logits; the planted faults fail the same limit."""
    net = resnet_net(device, torch.float32)
    x = images(RESNET_REF_B, device, seed=9)
    zero_counts()
    fused = net.output(x).cpu()
    counts = read_counts()
    net.set_fusion(False)
    xla_logits, xla = logits(net, x), net.output(x).cpu()
    net.set_fusion("bottleneck", stem=True)
    rec = {"dtype": "float32", "batch": RESNET_REF_B,
           "max_abs_err": float((fused - xla).abs().max()),
           "max_probability": float(fused.max()),
           "launches": {n: counts[n] for n in RESNET_LAUNCHES}}
    failures = []
    logit_check(net, x, xla_logits, torch.float32, rec, failures)
    log("resnet reference:", json.dumps(rec))
    if any(counts[n] != c for n, c in RESNET_LAUNCHES.items()) or \
            not bool(torch.isfinite(fused).all()):
        failures.append("launches or finite")
    if failures:
        raise AssertionError(f"resnet reference: {failures}: {rec}")
    return rec


# ---------------------------------------------------------------------
# phase 13: the ResNet50 backward kernels against their plain versions
# ---------------------------------------------------------------------
#: name: (kernel, geometry at the training path's shapes)
BWD_CASES = {
    "s2_c_bwd": ("bwd1x1", dict(h=56, w=56, c=64, k=256, stride=1,
                                act="relu")),
    "s3b0_a_bwd": ("bwd1x1", dict(h=56, w=56, c=256, k=128, stride=2,
                                  act="identity")),
    "s2_b_bwd": ("bwd3x3", dict(h=56, w=56, c=64, k=64, stride=1,
                                act="relu")),
    "s5_b_bwd": ("bwd3x3", dict(h=7, w=7, c=512, k=512, stride=1,
                                act="relu")),
}


def bwd_inputs(kernel, geo, n, dtype, device, seed):
    """Seeded inputs of a backward stage: y_k a raw conv output (a
    per-channel mean and scale drawn) with its BN rows aff_k (sc, bb,
    inv, mu of those statistics, m1, m2 drawn); g = dz0_k, a gradient
    masked by a relu (about half zero); yprev a raw conv output with its
    rows aff_p under a relu prologue, or a post-relu block input with
    (1, 0, 1, 0) under the identity; He-normal weights."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def rand(*shape):
        return torch.rand(shape, generator=g)

    h, w, c, k, s = geo["h"], geo["w"], geo["c"], geo["k"], geo["stride"]
    taps = 9 if kernel == "bwd3x3" else 1
    mk, sk = 0.3 * randn(k), 0.5 + rand(k)
    yk = mk + sk * randn(n, h // s, w // s, k)
    sck = (0.5 + rand(k)) / sk
    aff_k = torch.stack([sck, 0.2 * randn(k) - mk * sck, 1 / sk, mk,
                         0.05 * randn(k), 0.05 * randn(k)])
    gz = randn(n, h // s, w // s, k) * (rand(n, h // s, w // s, k) > 0.5)
    if geo["act"] == "relu":
        mp, sp = 0.3 * randn(c), 0.5 + rand(c)
        yprev = mp + sp * randn(n, h, w, c)
        scp = (0.5 + rand(c)) / sp
        aff_p = torch.stack([scp, 0.2 * randn(c) - mp * scp, 1 / sp, mp])
    else:
        yprev = torch.clamp_min(randn(n, h, w, c), 0.0)
        aff_p = torch.stack([torch.ones(c), torch.zeros(c), torch.ones(c),
                             torch.zeros(c)])
    wshape = (9, c, k) if taps == 9 else (c, k)
    wt = randn(*wshape) * (2.0 / (taps * c)) ** 0.5
    return {"yk": yk.to(device, dtype), "g": gz.to(device, dtype),
            "yprev": yprev.to(device, dtype), "w": wt.to(device, dtype),
            "aff_k": aff_k.to(device).contiguous(),
            "aff_p": aff_p.to(device).contiguous()}


def bwd_fns(kernel, geo, a):
    """(kernel call, plain call, library call, {fault: call}) on inputs
    ``a``: the library call is cuDNN's convolution backward (dgrad and
    wgrad) on dy and the activated input, both rounded to the compute
    dtype, channels-last, made here outside its time; the faults are
    planted through the kernel."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    args = (a["yk"], a["g"], a["yprev"], a["w"], a["aff_k"], a["aff_p"])
    c, k, s, act = geo["c"], geo["k"], geo["stride"], geo["act"]
    dtype = a["yk"].dtype
    cl = torch.channels_last
    dy = bn._dy(a["yk"], a["g"], a["aff_k"]).to(dtype) \
        .permute(0, 3, 1, 2)
    z = bn._z_prev(a["yprev"], a["aff_p"], act == "relu")[1].to(dtype) \
        .permute(0, 3, 1, 2)
    if kernel == "bwd3x3":
        w4 = a["w"].reshape(3, 3, c, k).permute(3, 2, 0, 1)
        pad = 1
    else:
        w4 = a["w"].t().reshape(k, c, 1, 1)
        pad = 0
    w4 = w4.contiguous(memory_format=cl)

    def library():
        return torch.ops.aten.convolution_backward(
            dy, z, w4, None, [s, s], [pad, pad], [1, 1], False, [0, 0], 1,
            [True, True, False])

    faults = {}
    if kernel == "bwd3x3":
        kw = dict(act_prev=act)

        def pad_affine():
            # a ring of zero pixels around y_k and g: the kernel computes
            # dy there as the BN-backward affine of zero, and the interior
            # of dz0 takes it in through the transposed taps
            def p(t):
                return torch.nn.functional.pad(t, (0, 0, 1, 1, 1, 1))
            dz, _, _ = bn.conv3x3_bwd(p(a["yk"]), p(a["g"]), p(a["yprev"]),
                                      a["w"], a["aff_k"], a["aff_p"], **kw)
            return dz[:, 1:-1, 1:-1, :].contiguous()

        faults["pad_affine"] = pad_affine
        return (lambda: bn.conv3x3_bwd(*args, **kw),
                lambda: bn.conv3x3_bwd_plain(*args, **kw), library, faults)
    kw = dict(act_prev=act, stride=s)
    if act == "relu":
        faults["no_mask"] = lambda: bn.conv1x1_bwd(
            *args, act_prev="identity", stride=s)[0]
    return (lambda: bn.conv1x1_bwd(*args, **kw),
            lambda: bn.conv1x1_bwd_plain(*args, **kw), library, faults)


def bwd_bound(kernel, geo, n, dtype):
    """Least time on this card for one backward stage: the bytes it must
    move (yk and g at the conv's output pixels, yprev at the pixels the
    conv read, the weight and BN rows once; dz0 at full resolution, dW in
    f32, the sums) over the memory rate, against its multiply-adds (dW
    and dz0, 2 M R K each, R = 9C or C) over the dtype's peak."""
    el = 2 if dtype == torch.bfloat16 else 4
    h, w, c, k, s = geo["h"], geo["w"], geo["c"], geo["k"], geo["stride"]
    red = (9 if kernel == "bwd3x3" else 1) * c
    m = n * (h // s) * (w // s)
    read = (2 * m * k + m * c + red * k) * el + (6 * k + 4 * c) * 4
    written = n * h * w * c * el + red * k * 4 + 2 * c * 4
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = 4 * m * red * k / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_sums_rel(sums, ref_dz, yprev, aff_p, ref_sums):
    """The sums' largest error per channel over that channel's sum of
    |terms| (|dz0| and |dz0 yhat|, from the plain version's dz0)."""
    c = yprev.shape[-1]
    d = ref_dz.float().reshape(-1, c)
    yhat = ((yprev.float() - aff_p[3]) * aff_p[2]).reshape(-1, c)
    mag = torch.stack([d.abs().sum(0), (d * yhat).abs().sum(0)])
    return float(((sums - ref_sums).abs() / mag.clamp_min(1e-30)).max())


def bwd_case(name, dtype, n, device, seed):
    """One backward case: the kernel against its plain version (dz0, dW,
    sums), the zero rows of stride 2, the planted faults in bf16, then
    the kernel's, plain version's and cuDNN's times beside the bound."""
    kernel, geo = BWD_CASES[name]
    a = bwd_inputs(kernel, geo, n, dtype, device, seed)
    kern, plain, library, faults = bwd_fns(kernel, geo, a)
    (dz, dw, sums), (rdz, rdw, rsums) = kern(), plain()
    torch.cuda.synchronize()
    case = {"case": name, "kernel": kernel,
            "dtype": str(dtype).split(".")[-1], "batch": n, **geo}
    failures = []
    finite = all(bool(torch.isfinite(t).all()) for t in (dz, dw, sums))
    row_rel, tile_rel = conv_agreement(dz, rdz)
    dw_row, dw_tile = conv_agreement(dw.reshape(-1, geo["k"]),
                                     rdw.reshape(-1, geo["k"]))
    case.update(max_abs_err=float((dz.float() - rdz.float()).abs().max()),
                dw_max_abs_err=float((dw - rdw).abs().max()),
                row_rel=row_rel, tile_rel=tile_rel, dw_row_rel=dw_row,
                dw_tile_rel=dw_tile,
                limits={"row_rel": CONV_ROW[dtype],
                        "tile_rel": CONV_TILE[dtype],
                        "dw_row_rel": BWD_DW_ROW[dtype],
                        "dw_tile_rel": BWD_DW_TILE[dtype],
                        "sums_rel": BWD_SUMS})
    if row_rel > CONV_ROW[dtype] or tile_rel > CONV_TILE[dtype]:
        failures.append("dz0")
    if dw_row > BWD_DW_ROW[dtype] or dw_tile > BWD_DW_TILE[dtype]:
        failures.append("dW")
    if geo["act"] == "relu":
        case["sums_rel"] = bwd_sums_rel(sums, rdz, a["yprev"], a["aff_p"],
                                        rsums)
        if case["sums_rel"] > BWD_SUMS:
            failures.append("sums")
    elif bool(sums.any()):
        failures.append("identity prologue's sums not zero")
    if geo["stride"] == 2:
        unread = dz.clone()
        unread[:, ::2, ::2, :] = 0
        case["unread_nonzero"] = int(torch.count_nonzero(unread))
        if case["unread_nonzero"]:
            failures.append("stride-2 rows the conv never read not zero")
    if dtype == torch.bfloat16:
        # the limits' power: each planted fault fails them
        planted_rec = {}
        for fault, fn in faults.items():
            planted_rec[fault] = conv_agreement(fn(), rdz)
            if planted_rec[fault][0] <= CONV_ROW[dtype] and \
                    planted_rec[fault][1] <= CONV_TILE[dtype]:
                failures.append(f"the limits do not tell {fault}")
        if geo["act"] == "relu":
            # sums over the stored, rounded dz0 (the forward's habit)
            c = geo["c"]
            d = dz.float().reshape(-1, c)
            yhat = ((a["yprev"].float() - a["aff_p"][3]) * a["aff_p"][2]) \
                .reshape(-1, c)
            stored = torch.stack([d.sum(0), (d * yhat).sum(0)])
            planted_rec["rounded_sums"] = bwd_sums_rel(
                stored, rdz, a["yprev"], a["aff_p"], rsums)
            if planted_rec["rounded_sums"] <= BWD_SUMS:
                failures.append("the limit does not tell rounded sums")
        case["planted"] = planted_rec
    log("cnn bwd check", json.dumps(case))
    if not finite or failures:
        raise AssertionError(f"{kernel} kernel disagrees with its plain "
                             f"version ({failures}, finite {finite}): "
                             f"{case}")
    del dz, dw, sums, rdz, rdw, rsums
    bound_ms, bound_by = bwd_bound(kernel, geo, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    log("cnn bwd", json.dumps(case))
    del a, kern, plain, library, faults
    torch.cuda.empty_cache()
    return case


def check_cnn_bwd_kernels(device):
    """Every backward case in bf16 at the main path's batch, then in f32
    at 16."""
    return [bwd_case(name, dtype, n, device, seed=20 + i)
            for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16))
            for i, name in enumerate(BWD_CASES)]


# ---------------------------------------------------------------------
# phases 14-15: ResNet50 training through ComputationGraph.fit
# ---------------------------------------------------------------------
def resnet_train_net(device, dtype, lr=0.1):
    """bench_all.py's bench_train_plan ResNet50: 1000 classes, 224x224,
    NHWC, Nesterovs(lr, 0.9), the fused plan resolved under the compute
    dtype, random weights from the conf seed."""
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.tuning import apply_execution_plan
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW,
                   width=RESNET_HW, updater=Nesterovs(lr, momentum=0.9),
                   data_format="NHWC",
                   execution_plan="fused").init(device=device)
    net.conf.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    apply_execution_plan(net, "fused")
    return net


def train_images(n):
    """bench_all.py's batch: standard-normal images and one-hot labels
    drawn from default_rng(0)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3, RESNET_HW, RESNET_HW)).astype(np.float32)
    y = np.zeros((n, RESNET_CLASSES), np.float32)
    y[np.arange(n), rng.integers(0, RESNET_CLASSES, n)] = 1.0
    return x, y


def fit_s(net, x, y, plan):
    """Wall seconds of one fit step that ends in a host read of its
    loss, and the loss."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=x.shape[0], execution_plan=plan)
    loss = net.score_value
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss


def resnet_train(device):
    """The ResNet50 training path at full width: a warm-up step, the
    counted timed steps, the xla plan in turns, peak memory, one
    profiled step."""
    net = resnet_train_net(device, torch.bfloat16)
    x, y = train_images(RESNET_B)
    start = tree_numpy(net.params)
    warm_s, warm_loss = fit_s(net, x, y, "fused")
    first = tree_numpy(net.updater_state)
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_RESNET_STEPS):
        t, loss = fit_s(net, x, y, "fused")
        step_s.append(t)
        losses.append(loss)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    med = float(np.median(step_s))
    rec = {"config": {"model": "ResNet50", "classes": RESNET_CLASSES,
                      "hw": RESNET_HW, "batch": RESNET_B,
                      "dtype": "bfloat16", "data_format": "NHWC",
                      "updater": "Nesterovs(0.1, 0.9)", "plan": "fused",
                      "fused_blocks": len(net._fusion()[1]),
                      "stem": bool(net._fusion()[2])},
           "warmup_step_s": warm_s, "warmup_loss": warm_loss,
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * med, "images_per_s": RESNET_B / med,
           "max_memory_allocated_bytes": peak, "launches": counts}
    failures = []
    if not all(np.isfinite(losses + [warm_loss])):
        failures.append("loss not finite")
    for name, per_step in RESNET_TRAIN_LAUNCHES.items():
        if counts[name] != per_step * TRAIN_RESNET_STEPS:
            failures.append(f"{name} launched {counts[name]} in "
                            f"{TRAIN_RESNET_STEPS} steps, want "
                            f"{per_step} a step")
    # the fused and xla plans' steps in turns (fused, xla, fused, xla)
    times = {"fused": [], "xla": []}
    for _ in range(TRAIN_RESNET_TURNS):
        for plan in ("fused", "xla"):
            fit_s(net, x, y, plan)
            for _ in range(2):
                times[plan].append(fit_s(net, x, y, plan)[0])
    for plan, ts in times.items():
        m = float(np.median(ts))
        rec["turns_" + plan] = {"step_ms": [1e3 * t for t in ts],
                                "step_ms_median": 1e3 * m,
                                "images_per_s": RESNET_B / m}
    rec["profile"], share = profile_fit_step(net, x, y, "fused")
    rec["profile"].update(
        conv_fwd_share=share("conv_gemm_kernel"),
        conv_bwd_share=share("dz_kernel", "dw_kernel", "reduce_splits"))
    del net
    torch.cuda.empty_cache()
    rec["against_xla"] = train_against_xla(device, x, y, start, first,
                                           [warm_loss] + losses, failures)
    log("resnet train:", json.dumps(rec))
    if failures:
        raise AssertionError(f"resnet train: {failures}: {rec}")
    return rec


def profile_fit_step(net, x, y, plan, top=12):
    """A warm-up fit step, then one under ``torch.profiler``: (its record
    -- wall ms, device busy share, launches, the top kernels' device
    us -- and ``share(*names)``, the share of the device time in kernels
    whose names hold any of ``names``)."""
    from torch.profiler import ProfilerActivity, profile
    fit_s(net, x, y, plan)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = fit_s(net, x, y, plan)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy_us = sum(dev_us.values())

    def share(*names):
        return (sum(t for key, t in dev_us.items()
                    if any(n in key for n in names)) / busy_us
                if busy_us else None)

    ranked = sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]
    return {"step_ms": 1e3 * wall,
            "device_busy_share": busy_us / (wall * 1e6),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels_us": [[key[:90], t] for key, t in ranked]}, share


def train_steps(device, x, y, plan, steps, swaps=()):
    """A fresh full-width net from the conf seed trained ``steps`` fit
    steps on ``plan``: its start parameters, its velocity after the
    first step (the first gradient times -lr), and every step's loss."""
    net = resnet_train_net(device, torch.bfloat16)
    start = tree_numpy(net.params)
    losses = [with_swaps(swaps, lambda: fit_s(net, x, y, plan)[1])]
    first = tree_numpy(net.updater_state)
    losses += [fit_s(net, x, y, plan)[1] for _ in range(steps - 1)]
    del net
    torch.cuda.empty_cache()
    return start, first, losses


def rel_l2(got, want):
    """||got - want|| over ||want||, over every leaf of two trees."""
    g, w = leaf_values(got), leaf_values(want)
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(g, w))
                         / sum(np.sum(b ** 2) for b in w)))


def train_against_xla(device, x, y, start, first, losses, failures):
    """The fused plan's full-width loss trajectory against a fresh net's
    on the xla plan (cuDNN convolutions under autograd) from the same
    seed: the first TRAIN_LOSS_AGREED losses within TRAIN_LOSS_AGREE
    and moving the same way, the first falling; the first step's
    velocity, against the xla plan's and against the plain versions'
    (a reading: see TRAIN_LOSS_AGREE)."""
    xstart, xfirst, xlosses = train_steps(device, x, y, "xla",
                                          1 + TRAIN_RESNET_STEPS)
    _, pfirst, _ = train_steps(device, x, y, "fused", 1, train_swapped())
    n = TRAIN_LOSS_AGREED
    same = all(np.array_equal(a, b) for a, b in zip(leaf_values(start),
                                                    leaf_values(xstart)))
    rec = {"same_start": same, "losses_fused": losses,
           "losses_xla": xlosses,
           "loss_rel": [abs(a - b) / b for a, b in zip(losses, xlosses)],
           "first_velocity_rel_l2": {"xla": rel_l2(first, xfirst),
                                     "plain": rel_l2(first, pfirst)},
           "limits": {"loss_rel": TRAIN_LOSS_AGREE, "losses": n}}
    if not same:
        failures.append("the xla plan's net starts from other weights")
    if not max(rec["loss_rel"][:n]) <= TRAIN_LOSS_AGREE:
        failures.append("the losses part from the xla plan's")
    moves = [np.sign(np.diff(t[:n])).tolist() for t in (losses, xlosses)]
    if moves[0] != moves[1] or moves[0][0] >= 0:
        failures.append(f"the losses move {moves[0]} and on the xla plan "
                        f"{moves[1]}; both must fall at the first update "
                        f"and move alike")
    return rec


def train_fault():
    """Swaps (for ``with_swaps``) that plant the reference's fault:
    block TRAIN_REF_PLANTED's stage c backward (its one relu 1x1 stage)
    through the kernel with the identity prologue: no relu' mask, no
    affine in the dW pass, no sums."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    bwd, seen = bn.conv1x1_bwd, [0]

    def faulty(yk, g, yprev, w, aff_k, aff_p, *, act_prev, stride=1):
        if act_prev == "relu":            # stage c, once per block
            seen[0] += 1
            if (seen[0] - 1) % 16 == TRAIN_REF_PLANTED:
                act_prev = "identity"
        return bwd(yk, g, yprev, w, aff_k, aff_p, act_prev=act_prev,
                   stride=stride)

    return [(vars(bn), {"conv1x1_bwd": faulty})]


def train_swapped():
    """The forward and backward kernels' wrappers swapped for their plain
    versions (for ``with_swaps``)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    return [(vars(bn), {"conv1x1": bn.conv1x1_plain,
                        "conv3x3": bn.conv3x3_plain,
                        "conv1x1_bwd": bn.conv1x1_bwd_plain,
                        "conv3x3_bwd": bn.conv3x3_bwd_plain})]


def tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: tree_numpy(v) for k, v in tree.items()}
    return tree.detach().double().cpu().numpy()


def leaf_items(tree, pre=()):
    """(path, array) of a tree's leaves, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], pre + (k,))
    else:
        yield pre, tree


def leaf_values(tree):
    return [a for _, a in leaf_items(tree)]


def update_err(got, want, base):
    """How far two runs part, leaf by leaf: the worst leaf's largest
    |got - want| over that leaf's own change max|want - base| since
    ``base``, the change floored at UPDATE_ULP_FLOOR of the leaf's
    largest |base| and at UPDATE_REL_FLOOR of the largest change of any
    leaf; ``(err, the worst leaf's path)``."""
    g, w, b = (dict(leaf_items(t)) for t in (got, want, base))
    keys = [k for k in w if w[k].size]
    change = {k: float(np.abs(w[k] - b[k]).max()) for k in keys}
    top = max(change.values())
    return max((float(np.abs(g[k] - w[k]).max())
                / max(change[k], UPDATE_ULP_FLOOR * float(np.abs(b[k]).max()),
                      UPDATE_REL_FLOOR * top, 1e-30), "/".join(k))
               for k in keys)


def resnet_train_reference(device, stem=False):
    """f32 at B=8: two fit steps with the kernels (the fused plan; with
    ``stem``, the stem kernels engaged too), with the plain versions
    swapped in, on the xla plan, and with a planted fault (``stem``: in
    the stem's backward, else in a block's); parameters, BN state and
    velocity by update_err."""
    x, y = train_images(TRAIN_REF_B)
    plain = train_swapped() + (stem_swapped() if stem else [])
    fault = stem_fault() if stem else train_fault()
    runs = {}
    for label, plan, swaps in (("kernels", "fused", []),
                               ("plain", "fused", plain),
                               ("xla", "xla", []),
                               ("planted", "fused", fault)):
        net = resnet_train_net(device, torch.float32, lr=TRAIN_REF_LR)
        if stem and plan == "fused":
            net.set_fusion("bottleneck", stem=True)
            plan = None
        if label == "kernels":
            base = {"params": tree_numpy(net.params),
                    "state": tree_numpy(net.state),
                    "updater": tree_numpy(net.updater_state)}
        zero_counts()

        def steps():
            return [fit_s(net, x, y, plan)[1]
                    for _ in range(TRAIN_REF_STEPS)]

        losses = with_swaps(swaps, steps)
        runs[label] = {"losses": losses, "launches": read_counts(),
                       "params": tree_numpy(net.params),
                       "state": tree_numpy(net.state),
                       "updater": tree_numpy(net.updater_state)}
        del net
        torch.cuda.empty_cache()
    ref = runs["kernels"]
    rec = {"dtype": "float32", "batch": TRAIN_REF_B, "hw": RESNET_HW,
           "lr": TRAIN_REF_LR, "steps": TRAIN_REF_STEPS, "stem": stem,
           "limits": {"params": TRAIN_REF_LIMIT, "updater": TRAIN_REF_LIMIT,
                      "state": TRAIN_REF_STATE}}
    failures = []
    for label in ("plain", "xla", "planted"):
        errs = {key: update_err(runs[label][key], ref[key], base[key])
                for key in ("params", "state", "updater")}
        rec[label] = {"update_err": errs, "losses": runs[label]["losses"],
                      "launches": runs[label]["launches"]}
        within = all(v <= rec["limits"][key] for key, (v, _) in errs.items())
        if label == "planted" and within:
            failures.append("the limit does not tell the planted fault")
        if label != "planted" and not within:
            failures.append(f"{label} disagrees with the kernels")
    rec["kernels"] = {"losses": ref["losses"], "launches": ref["launches"]}
    if not all(np.isfinite(ref["losses"])) or \
            not ref["losses"][1] < ref["losses"][0]:
        failures.append("the reference's loss not finite or not falling")
    per_step = RESNET_TRAIN_STEM_LAUNCHES if stem else RESNET_TRAIN_LAUNCHES
    want = {n: c * TRAIN_REF_STEPS for n, c in per_step.items()}
    if {n: ref["launches"][n] for n in want} != want or \
            any(runs["plain"]["launches"][n] for n in want):
        failures.append("launches")
    name = "resnet train stem reference" if stem else \
        "resnet train reference"
    log(f"{name}:", json.dumps(rec))
    if failures:
        raise AssertionError(f"{name}: {failures}: {rec}")
    return rec


# ---------------------------------------------------------------------
# phase 16: the stem's backward kernels against their plain versions
# ---------------------------------------------------------------------
#: the stem at the training path's shape: 224x224x3 -> 112x112x64
STEM_BWD_GEO = dict(h=224, w=224, c=3, k=64)
#: dx's 64-row tiles: dx sums 16 taps x 64 channels of a dy from which
#: the BN backward took the mean, so the sum cancels far below its terms
#: and the f32 sums in another order flip one bf16 ulp in more outputs
#: than the forward convs do (1.74e-4 on the H100, against CONV_TILE's
#: 1e-4); the rounding moved into the tap loop reads far above the limit
STEM_DX_TILE = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


def stem_bwd_inputs(n, dtype, device, seed):
    """Seeded inputs of the stem's backward at the training shape: x and
    a He-normal weight, the conv kernel's y and batch statistics with
    drawn BN gains and biases (the BN rows aff_p), the pooled output's
    gradient g; then, from the plain versions, dz0 and the rows aff_k
    (m1, m2 from its sums), and dy, so that each kernel is held on its
    plain version's inputs."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    gen = torch.Generator().manual_seed(seed)
    geo = STEM_BWD_GEO
    h, w, c, k = geo["h"], geo["w"], geo["c"], geo["k"]
    g = stem.stem_geometry(h, w)
    x = torch.randn((n, h, w, c), generator=gen).to(device, dtype)
    w7 = (torch.randn((k, c, 7, 7), generator=gen)
          * (2.0 / (49 * c)) ** 0.5).to(device, dtype)
    ws = stem.stem_weight_s2d(w7)
    gamma = (0.5 + torch.rand(k, generator=gen)).to(device)
    beta = (0.3 * torch.randn(k, generator=gen)).to(device)
    gout = torch.randn((n, g["po"], g["pw"], k), generator=gen) \
        .to(device, dtype)
    y, s1, s2 = stem.stem_conv(x, ws)
    count = n * g["ho"] * g["wo"]
    mu, var = bn._finalize_stats(s1, s2, count)
    sc, bb, inv = bn._affine(gamma, beta, mu, var, 1e-5)
    aff_p = bn._rows(sc, bb, inv, mu)
    dz, sums = stem.stem_bwd_pool_plain(y, gout, aff_p)
    aff_k = bn._rows(sc, bb, inv, mu, sums[0] / count, sums[1] / count)
    dy, _ = stem.stem_bwd_dw_plain(x, y, dz, aff_k)
    return {"x": x, "w7": w7, "ws": ws, "y": y, "g": gout, "aff_p": aff_p,
            "dz": dz, "aff_k": aff_k, "dy": dy}


def stem_pool_fault(y, g, aff, fault):
    """The plain pool backward with ``fault`` planted: dz0 only."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    z0 = y.float() * aff[0] + aff[1]
    zc = torch.clamp_min(z0, 0.0)
    if fault != "max_in_f32":
        zc = zc.to(y.dtype).float()
    dz = stem._pool_grad(zc, g.float())
    if fault != "no_mask":
        dz = torch.where(z0 > 0, dz, 0.0)
    return dz.to(y.dtype)


def stem_bwd_fns(kernel, a):
    """(kernel call, plain call, library call, {fault: call}) on inputs
    ``a``. The faults are planted in the plain versions (the kernels
    cannot be told to skip a step): "no_mask", bwd_pool without its
    relu' mask; "max_in_f32", the window maxima compared on the f32 relu
    output, not on its rounding to the model dtype (ties are common in
    bf16); "dy_unrounded", dW from the f32 dy instead of the stored,
    rounded one; "dx_per_tap", dx rounded to the model dtype after every
    tap instead of once. The library calls, their operands made here
    outside their time: ``aten.max_pool2d_with_indices_backward`` on the
    rounded relu output (the indices of its forward), and cuDNN's
    ``convolution_backward`` of the 7x7/2 pad-3 conv, channels-last: the
    weight gradient for dw, the input gradient for dx."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    aten = torch.ops.aten
    cl = torch.channels_last
    x, y, g, dz, dy = a["x"], a["y"], a["g"], a["dz"], a["dy"]
    nchw = (0, 3, 1, 2)
    if kernel == "stem_bwd_pool":
        aff = a["aff_p"]
        zc = torch.clamp_min(y.float() * aff[0] + aff[1], 0.0) \
            .to(y.dtype).permute(nchw)
        _, idx = aten.max_pool2d_with_indices(zc, [3, 3], [2, 2], [1, 1])
        gn = g.permute(nchw)
        return (lambda: stem.stem_bwd_pool(y, g, aff),
                lambda: stem.stem_bwd_pool_plain(y, g, aff),
                lambda: aten.max_pool2d_with_indices_backward(
                    gn, zc, [3, 3], [2, 2], [1, 1], [1, 1], False, idx),
                {f: (lambda f=f: stem_pool_fault(y, g, aff, f))
                 for f in ("no_mask", "max_in_f32")})
    dyn, xn = dy.permute(nchw), x.permute(nchw)
    w7 = a["w7"].contiguous(memory_format=cl)

    def library(mask):
        return lambda: aten.convolution_backward(
            dyn, xn, w7, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1,
            mask)

    if kernel == "stem_bwd_dw":
        aff = a["aff_k"]

        def unrounded():
            g_ = stem.stem_geometry(x.shape[1], x.shape[2])
            sc, _, inv, mu, m1, m2 = aff
            dyf = sc * (dz.float() - m1 - (y.float() - mu) * inv * m2)
            ic = stem._im2col(stem._s2d_image(x.float(), g_), g_)
            return ic.t() @ dyf.reshape(-1, y.shape[3])

        return (lambda: stem.stem_bwd_dw(x, y, dz, aff),
                lambda: stem.stem_bwd_dw_plain(x, y, dz, aff),
                library([False, True, False]), {"dy_unrounded": unrounded})
    shape = tuple(x.shape)
    return (lambda: stem.stem_bwd_dx(dy, a["ws"], shape),
            lambda: stem.stem_bwd_dx_plain(dy, a["ws"], shape),
            library([True, False, False]),
            {"dx_per_tap": lambda: stem_dx_per_tap(dy, a["ws"], shape)})


def stem_dx_per_tap(dy, ws, shape):
    """The plain dx with the fault "dx_per_tap": the f32 sum rounded to
    dy's dtype after every tap."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    n, h, w, c = shape
    g = stem.stem_geometry(h, w)
    hs, ws_, ho, wo = g["hs"], g["ws"], g["ho"], g["wo"]
    k = dy.shape[3]
    dyp = torch.nn.functional.pad(dy.float(), (0, 0, 3, ws_ - wo, 3, hs - ho))
    acc = 0.0
    for t in range(16):
        i, j = divmod(t, 4)
        gs = dyp[:, 3 - i:3 - i + hs, 3 - j:3 - j + ws_, :] \
            .reshape(n, hs * ws_, k)
        acc = (acc + gs @ ws[t * 4 * c:(t + 1) * 4 * c].float().t()) \
            .to(dy.dtype).float()
    p = acc.reshape(n, hs, ws_, 2, 2, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(n, 2 * hs, 2 * ws_, c)
    return p[:, 3:3 + h, 3:3 + w, :].to(dy.dtype)


def stem_bwd_bound(kernel, n, dtype):
    """Least time on this card: the bytes the function must move (each
    input once, each output once) over the memory rate, against the
    multiply-adds of the 7x7 taps (dW and dx, 2 M 49 C K) over the
    dtype's peak."""
    el = 2 if dtype == torch.bfloat16 else 4
    geo = STEM_BWD_GEO
    h, w, c, k = geo["h"], geo["w"], geo["c"], geo["k"]
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    m = n * ho * wo
    if kernel == "stem_bwd_pool":
        nbytes = (2 * m * k + n * po * pw * k) * el + (4 + 2) * k * 4
        ops = 0
    elif kernel == "stem_bwd_dw":
        nbytes = (n * h * w * c + 3 * m * k) * el + 6 * k * 4 \
            + 64 * c * k * 4
        ops = 2 * m * 49 * c * k
    else:
        nbytes = (m * k + 64 * c * k + n * h * w * c) * el
        ops = 2 * m * 49 * c * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def stem_bwd_case(kernel, a, dtype, n, device):
    """One stem backward kernel against its plain version on the same
    inputs: each output by rows and 64-row tiles (dz0, dy, dx as stored
    in the compute dtype, dW in f32 by its rows), the sums within
    BWD_SUMS of each channel's sum of |terms|; in bf16 each planted
    fault fails the limits; then the kernel's, plain version's and
    library call's times beside the bound."""
    kern, plain, library, faults = stem_bwd_fns(kernel, a)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    case = {"case": kernel, "kernel": kernel,
            "dtype": str(dtype).split(".")[-1], "batch": n, **STEM_BWD_GEO}
    failures = []
    k = STEM_BWD_GEO["k"]
    limits = {"row_rel": CONV_ROW[dtype], "tile_rel": CONV_TILE[dtype]}
    if kernel == "stem_bwd_pool":
        (dz, sums), (rdz, rsums) = got, ref
        outs = {"dz0": (dz, rdz)}
        case["sums_rel"] = bwd_sums_rel(sums, rdz, a["y"], a["aff_p"],
                                        rsums)
        limits["sums_rel"] = BWD_SUMS
        if case["sums_rel"] > BWD_SUMS:
            failures.append("sums")
        finite = [dz, sums]
    elif kernel == "stem_bwd_dw":
        (dy, dw), (rdy, rdw) = got, ref
        outs = {"dy": (dy, rdy), "dW": (dw, rdw)}
        limits.update(dw_row_rel=BWD_DW_ROW[dtype],
                      dw_tile_rel=BWD_DW_TILE[dtype])
        finite = [dy, dw]
    else:
        outs = {"dx": (got, ref)}
        limits["tile_rel"] = STEM_DX_TILE[dtype]
        finite = [got]
    for name, (o, r) in outs.items():
        width = o.shape[-1] if name != "dW" else k
        rr, tr = conv_agreement(o.reshape(-1, width), r.reshape(-1, width))
        case[name] = {"max_abs_err": float((o.float() - r.float()).abs()
                                           .max()),
                      "row_rel": rr, "tile_rel": tr}
        lim = (("dw_row_rel", "dw_tile_rel") if name == "dW"
               else ("row_rel", "tile_rel"))
        if rr > limits[lim[0]] or tr > limits[lim[1]]:
            failures.append(name)
    main = {"stem_bwd_pool": "dz0", "stem_bwd_dw": "dW",
            "stem_bwd_dx": "dx"}[kernel]
    case["max_abs_err"] = case[main]["max_abs_err"]
    case["limits"] = limits
    if dtype == torch.bfloat16:
        planted_rec = {}
        for fault, fn in faults.items():
            name = "dW" if fault == "dy_unrounded" else main
            ref_out = outs[name][1]
            width = ref_out.shape[-1] if name != "dW" else k
            planted_rec[fault] = conv_agreement(
                fn().reshape(-1, width), ref_out.reshape(-1, width))
            lim = (("dw_row_rel", "dw_tile_rel") if name == "dW"
                   else ("row_rel", "tile_rel"))
            if planted_rec[fault][0] <= limits[lim[0]] and \
                    planted_rec[fault][1] <= limits[lim[1]]:
                failures.append(f"the limits do not tell {fault}")
        case["planted"] = planted_rec
    ok = all(bool(torch.isfinite(t).all()) for t in finite)
    log("stem bwd check", json.dumps(case))
    if not ok or failures:
        raise AssertionError(f"{kernel} kernel disagrees with its plain "
                             f"version ({failures}, finite {ok}): {case}")
    del got, ref, outs, finite
    bound_ms, bound_by = stem_bwd_bound(kernel, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    log("stem bwd", json.dumps(case))
    del kern, plain, library, faults
    torch.cuda.empty_cache()
    return case


def check_stem_bwd_kernels(device):
    """The three stem backward kernels in bf16 at the main path's batch,
    then in f32 at 16."""
    cases = []
    for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16)):
        a = stem_bwd_inputs(n, dtype, device, seed=40)
        for kernel in ("stem_bwd_pool", "stem_bwd_dw", "stem_bwd_dx"):
            cases.append(stem_bwd_case(kernel, a, dtype, n, device))
        del a
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------
# phases 17-18: ResNet50 training with the fused stem
# ---------------------------------------------------------------------
def resnet_train_stem(device, xla_losses=None):
    """ResNet50 training at full width with the stem kernels engaged
    (``set_fusion("bottleneck", stem=True)``): a warm-up step, the
    counted timed steps, the losses against the xla plan's from the same
    seed (phase 14's, or a fresh run), the stem-fused, fused (no stem) and
    xla plans' steps and peak memory in turns, one profiled step."""
    net = resnet_train_net(device, torch.bfloat16)
    net.set_fusion("bottleneck", stem=True)
    x, y = train_images(RESNET_B)
    warm_s, warm_loss = fit_s(net, x, y, None)
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_RESNET_STEPS):
        t, loss = fit_s(net, x, y, None)
        step_s.append(t)
        losses.append(loss)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    med = float(np.median(step_s))
    rec = {"config": {"model": "ResNet50", "classes": RESNET_CLASSES,
                      "hw": RESNET_HW, "batch": RESNET_B,
                      "dtype": "bfloat16", "data_format": "NHWC",
                      "updater": "Nesterovs(0.1, 0.9)",
                      "plan": "fused + stem",
                      "fused_blocks": len(net._fusion()[1]),
                      "stem": bool(net._fusion()[2])},
           "warmup_step_s": warm_s, "warmup_loss": warm_loss,
           "losses": losses, "step_ms": [1e3 * t for t in step_s],
           "step_ms_median": 1e3 * med, "images_per_s": RESNET_B / med,
           "max_memory_allocated_bytes": peak, "launches": counts}
    failures = []
    if not all(np.isfinite(losses + [warm_loss])):
        failures.append("loss not finite")
    for name, per_step in RESNET_TRAIN_STEM_LAUNCHES.items():
        if counts[name] != per_step * TRAIN_RESNET_STEPS:
            failures.append(f"{name} launched {counts[name]} in "
                            f"{TRAIN_RESNET_STEPS} steps, want "
                            f"{per_step} a step")
    # the three plans' steps in turns (stem, fused, xla, stem, ...)
    plans = {"fused_stem": ("bottleneck", True), "fused": ("bottleneck",
                                                           False),
             "xla": (False, False)}
    times = {p: [] for p in plans}
    peaks = {p: 0 for p in plans}
    for _ in range(TRAIN_RESNET_TURNS):
        for plan, (level, stem_on) in plans.items():
            net.set_fusion(level, stem=stem_on)
            fit_s(net, x, y, None)
            torch.cuda.reset_peak_memory_stats(device)
            for _ in range(2):
                times[plan].append(fit_s(net, x, y, None)[0])
            peaks[plan] = max(peaks[plan],
                              torch.cuda.max_memory_allocated(device))
    for plan, ts in times.items():
        m = float(np.median(ts))
        rec["turns_" + plan] = {"step_ms": [1e3 * t for t in ts],
                                "step_ms_median": 1e3 * m,
                                "images_per_s": RESNET_B / m,
                                "max_memory_allocated_bytes": peaks[plan]}
    net.set_fusion("bottleneck", stem=True)
    rec["profile"], share = profile_fit_step(net, x, y, None)
    rec["profile"].update(
        conv_fwd_share=share("conv_gemm_kernel"),
        conv_bwd_share=share("dz_kernel", "dw_kernel", "reduce_splits"),
        stem_share=share("conv_gemm_kernel<__nv_bfloat16, 2>",
                         "stem_pool_kernel", "bwd_pool_kernel", "dy_kernel",
                         "dw_kernel<__nv_bfloat16>("))
    del net
    torch.cuda.empty_cache()
    if xla_losses is None:
        xla_losses = train_steps(device, x, y, "xla",
                                 1 + TRAIN_RESNET_STEPS)[2]
    all_losses = [warm_loss] + losses
    n = TRAIN_LOSS_AGREED
    rec["against_xla"] = {
        "losses_xla": xla_losses,
        "loss_rel": [abs(a - b) / b for a, b in zip(all_losses, xla_losses)],
        "limits": {"loss_rel": TRAIN_LOSS_AGREE, "losses": n}}
    if not max(rec["against_xla"]["loss_rel"][:n]) <= TRAIN_LOSS_AGREE:
        failures.append("the losses part from the xla plan's")
    moves = [np.sign(np.diff(t[:n])).tolist()
             for t in (all_losses, xla_losses)]
    if moves[0] != moves[1] or moves[0][0] >= 0:
        failures.append(f"the losses move {moves[0]} and on the xla plan "
                        f"{moves[1]}; both must fall at the first update "
                        f"and move alike")
    log("resnet train stem:", json.dumps(rec))
    if failures:
        raise AssertionError(f"resnet train stem: {failures}: {rec}")
    return rec


def stem_swapped():
    """The stem kernels' wrappers swapped for their plain versions (for
    ``with_swaps``)."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    return [(vars(stem), {n: getattr(stem, n + "_plain")
                          for n in ("stem_conv", "stem_pool",
                                    "stem_bwd_pool", "stem_bwd_dw",
                                    "stem_bwd_dx")})]


def stem_fault():
    """Swaps (for ``with_swaps``) that plant a fault in the stem's
    backward, through the kernel: dW's pixel reduction loses the second
    half of the batch (as a dropped split of its partials would). (The
    BN backward without its mean terms m1, m2 moved the stem weight's
    update by only 0.093 of itself on the H100: in f32 at this init the
    projection is small.)"""
    from deeplearning4j_tpu_torch.nn.layers import stem
    bwd = stem.stem_bwd_dw

    def faulty(x, y, dz, aff):
        dy, _ = bwd(x, y, dz, aff)
        h = x.shape[0] // 2
        _, dw = bwd(x[:h].contiguous(), y[:h].contiguous(),
                    dz[:h].contiguous(), aff)
        return dy, dw

    return [(vars(stem), {"stem_bwd_dw": faulty})]


# ---------------------------------------------------------------------
# phase 19: the calibrated "auto" plan
# ---------------------------------------------------------------------
#: the synthetic verdicts' subset: the blocks of these stages win
AUTO_SYNTHETIC_STAGES = ("s2", "s4")
#: timed fit steps a turn of phase 19's auto-against-xla comparison
AUTO_TURN_STEPS = 3


def expected_launches(bcands, chosen, stem_on):
    """Launches of one training step that fuses the ``chosen`` blocks
    (and the stem iff ``stem_on``)."""
    ones = sum(2 + ("conv_skip" in bcands[b]) for b in chosen)
    s = int(bool(stem_on))
    return {"conv1x1": ones, "conv3x3": len(chosen), "bwd1x1": ones,
            "bwd3x3": len(chosen), "stem_conv": s, "stem_pool": s,
            "stem_bwd_pool": s, "stem_bwd_dw": s, "stem_bwd_dx": 0}


def auto_fit(device, store, x, y):
    """A fresh net's ``fit(execution_plan="auto")`` step with ``store``
    as the process's store: (the resolution record, the blocks and stem
    the store's verdicts imply, the step's launches, the loss)."""
    from deeplearning4j_tpu_torch.tuning import (
        apply_execution_plan, reset_default_store, winner)
    from deeplearning4j_tpu_torch.tuning.plan import _block_key, _stem_key
    net = resnet_train_net(device, torch.bfloat16)
    bcands, scands = net.fusion_candidates()
    entries = store.entries()

    def wins(key):
        return key in entries and winner(entries[key]) == "kernel"

    chosen = {b for b, g in bcands.items() if wins(_block_key(g, "bfloat16"))}
    stem_on = any(wins(_stem_key(g, "bfloat16")) for g in scands.values())
    reset_default_store(store)
    try:
        record = apply_execution_plan(net, "auto", store=store)
        net.set_fusion(False)
        zero_counts()
        _, loss = fit_s(net, x, y, "auto")
        counts = read_counts()
    finally:
        reset_default_store(None)
    fusion = net._fusion()
    resolved = (set(fusion[1]), bool(fusion[2]))
    del net
    torch.cuda.empty_cache()
    return (record, (chosen, stem_on), resolved,
            expected_launches(bcands, chosen, stem_on), counts, loss)


def auto_against_xla(device, store, x, y):
    """Steps of ``fit(execution_plan="auto")`` on the calibrated
    ``store`` and of ``fit(execution_plan="xla")``, two fresh nets in
    turns (auto, xla, xla, auto; a warm-up step each first, then
    AUTO_TURN_STEPS timed ones a turn). "auto" is within the xla plan's
    spread, or faster, when its median step is at most the xla plan's
    median plus the xla plan's spread (its largest step less its
    smallest)."""
    from deeplearning4j_tpu_torch.tuning import reset_default_store
    nets = {plan: resnet_train_net(device, torch.bfloat16)
            for plan in ("auto", "xla")}
    steps = {"auto": [], "xla": []}
    reset_default_store(store)
    try:
        for plan in ("auto", "xla"):
            fit_s(nets[plan], x, y, plan)
        for plan in ("auto", "xla", "xla", "auto"):
            steps[plan] += [fit_s(nets[plan], x, y, plan)[0]
                            for _ in range(AUTO_TURN_STEPS)]
    finally:
        reset_default_store(None)
    fusion = nets["auto"]._fusion()
    del nets
    torch.cuda.empty_cache()
    med = {p: float(np.median(t)) for p, t in steps.items()}
    spread = max(steps["xla"]) - min(steps["xla"])
    return {"step_ms": {p: [1e3 * t for t in ts] for p, ts in steps.items()},
            "step_ms_median": {p: 1e3 * m for p, m in med.items()},
            "xla_spread_ms": 1e3 * spread,
            "auto_blocks": len(fusion[1]), "auto_stem": bool(fusion[2]),
            "within": med["auto"] <= med["xla"] + spread}


def auto_plan(device):
    """``calibrate_training_kernels`` on the full-width ResNet50 (bf16)
    into a store in a temporary directory; a fresh net's
    ``fit(execution_plan="auto")`` launches what the verdicts imply; the
    store saved and loaded back resolves the same way; entries stamped
    with another device kind resolve to the xla plan; a store with
    synthetic verdicts picking the stem and a subset of blocks."""
    import os
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.tuning import (
        KernelCrossoverStore, apply_execution_plan,
        calibrate_training_kernels, winner)
    from deeplearning4j_tpu_torch.tuning.crossover import CROSSOVER_NAME
    tmp = tempfile.mkdtemp(prefix="dl4j_crossover_")
    failures = []
    rec = {"store_dir": "a temporary directory"}
    try:
        path = os.path.join(tmp, CROSSOVER_NAME)
        store = KernelCrossoverStore(path=path)
        net = resnet_train_net(device, torch.bfloat16)
        bcands, scands = net.fusion_candidates()
        zero_counts()
        t0 = time.perf_counter()
        results = calibrate_training_kernels(net, batch_size=RESNET_B,
                                             store=store, persist=True)
        rec["calibration_s"] = time.perf_counter() - t0
        rec["calibration_launches"] = read_counts()
        rec["calibration"] = {
            key: {"kernel_ms": e["kernel_ms"],
                  "fallback_ms": e["fallback_ms"], "verdict": winner(e),
                  "device_kind": e["device_kind"]}
            for key, e in results.items()}
        del net
        torch.cuda.empty_cache()
        from deeplearning4j_tpu_torch.tuning.plan import _block_key, _stem_key
        want_keys = {_block_key(g, "bfloat16") for g in bcands.values()} | \
            {_stem_key(g, "bfloat16") for g in scands.values()}
        if set(results) != want_keys or not scands:
            failures.append(f"calibrated {sorted(results)}, the net's "
                            f"distinct shapes are {sorted(want_keys)}")
        if rec["calibration_launches"]["stem_bwd_dx"] < 1:
            failures.append("calibration did not launch stem_bwd_dx")
        log("auto plan calibration (kernel ms / fallback ms): " + ", ".join(
            f"{k.split('|')[1]} {e['kernel_ms']:.3f} / "
            f"{e['fallback_ms']:.3f} {e['verdict']}"
            for k, e in rec["calibration"].items()))
        x, y = train_images(RESNET_B)
        rec["against_xla"] = auto_against_xla(device, store, x, y)
        if not rec["against_xla"]["within"]:
            failures.append(f"fit(auto) {rec['against_xla']} is slower "
                            f"than the xla plan beyond its spread")
        runs = {}
        for label, st in (("calibrated", store),
                          ("loaded", KernelCrossoverStore.load(path))):
            record, implied, resolved, want, counts, loss = auto_fit(
                device, st, x, y)
            runs[label] = record
            rec[label] = {"blocks": record["blocks"],
                          "stem": record["stem"], "launches": counts,
                          "want": want, "loss": loss}
            if resolved != implied:
                failures.append(f"{label}: the plan fused {resolved}, the "
                                f"verdicts imply {implied}")
            if {n: counts[n] for n in want} != want:
                failures.append(f"{label}: launches {counts}, want {want}")
            if not np.isfinite(loss):
                failures.append(f"{label}: loss not finite")
        if runs["loaded"] != runs["calibrated"]:
            failures.append("the loaded store resolves otherwise")
        # entries of another card: "auto" is the xla plan
        foreign = KernelCrossoverStore(
            path=os.path.join(tmp, "foreign.json"),
            entries={k: {**e, "device_kind": "another card"}
                     for k, e in store.entries().items()})
        net = resnet_train_net(device, torch.bfloat16)
        r = apply_execution_plan(net, "auto", store=foreign)
        rec["foreign"] = {"level": r["level"], "blocks": r["blocks"],
                          "stem": r["stem"]}
        if r["level"] is not False or r["stem"] or net.fusion_level:
            failures.append("a foreign card's entries engaged a kernel")
        del net
        # synthetic verdicts: the stem and the blocks of two stages win
        synth = KernelCrossoverStore(path=os.path.join(tmp, "synth.json"))
        for b, g in bcands.items():
            win = b.startswith(AUTO_SYNTHETIC_STAGES)
            synth.record(_block_key(g, "bfloat16"), 1.0 if win else 2.0,
                         1.5, device=device)
        for g in scands.values():
            synth.record(_stem_key(g, "bfloat16"), 1.0, 1.5, device=device)
        record, implied, resolved, want, counts, loss = auto_fit(
            device, synth, x, y)
        rec["synthetic"] = {"blocks": record["blocks"],
                            "stem": record["stem"], "launches": counts,
                            "want": want, "loss": loss}
        if resolved != implied or not implied[1] or \
                not 0 < len(implied[0]) < len(bcands):
            failures.append(f"synthetic: fused {resolved}, implied "
                            f"{implied}")
        if {n: counts[n] for n in want} != want or not np.isfinite(loss):
            failures.append(f"synthetic: launches {counts}, want {want}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("auto plan:", json.dumps(rec))
    if failures:
        raise AssertionError(f"auto plan: {failures}: {rec}")
    return rec


def cnn_entry(name, replaces, launches, cases):
    """A ResNet50 kernel's entry of the kernels line: its numbers at the
    main path's shape (the first bf16 case of the kernel), and every
    case's."""
    mine = [c for c in cases if c["kernel"] == name]
    main = mine[0]
    keys = ("max_abs_err", "row_rel", "tile_rel", "sums_rel",
            "unrounded_tile_rel")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/" + (
                "stem.cu" if name.startswith("stem") else "bottleneck.cu"),
            "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "case": main["case"], "dtype": main["dtype"],
            "batch": main["batch"], "limits": main["limits"],
            "max_abs_err_all": max(c["max_abs_err"] for c in mine),
            "cases": [{k: c[k] for k in ("case", "dtype", "batch", "ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", *keys)
                       if k in c} for c in mine]}


def bwd_entry(name, replaces, launches, cases):
    """A backward kernel's entry of the kernels line: its numbers at the
    main path's shape (the first bf16 case of the kernel), and every
    case's."""
    mine = [c for c in cases if c["kernel"] == name]
    main = mine[0]
    keys = ("max_abs_err", "dw_max_abs_err", "row_rel", "tile_rel",
            "dw_row_rel", "dw_tile_rel", "sums_rel", "planted")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/"
                      "bottleneck_bwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "aten.convolution_backward (cuDNN dgrad + wgrad)",
            "case": main["case"], "dtype": main["dtype"],
            "batch": main["batch"], "limits": main["limits"],
            "max_abs_err_all": max(c["max_abs_err"] for c in mine),
            "cases": [{k: c[k] for k in ("case", "dtype", "batch", "ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", *keys)
                       if k in c} for c in mine]}


def stem_bwd_entry(name, replaces, launches, path, cases):
    """A stem backward kernel's entry of the kernels line: its numbers at
    the main path's shape (the bf16 case), every case's, and the path
    its launches were counted on."""
    mine = [c for c in cases if c["kernel"] == name]
    main = mine[0]
    library = {"stem_bwd_pool": "aten.max_pool2d_with_indices_backward",
               "stem_bwd_dw": "aten.convolution_backward (cuDNN wgrad)",
               "stem_bwd_dx": "aten.convolution_backward (cuDNN dgrad)"}
    keys = ("max_abs_err", "sums_rel", "dz0", "dy", "dW", "dx", "planted")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/stem_bwd.cu",
            "replaces": replaces, "launches": launches,
            "launches_on": path,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": library[name], "dtype": main["dtype"],
            "batch": main["batch"], "limits": main["limits"],
            "max_abs_err_all": max(c["max_abs_err"] for c in mine),
            "cases": [{k: c[k] for k in ("dtype", "batch", "ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", *keys)
                       if k in c} for c in mine]}


def build_all():
    """Build every kernel library, one nvcc each, all started together;
    returns (seconds, {library: ptxas lines})."""
    libs = list({id(k.library): k.library
                 for k in kernel_counters().values()}.values())
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
    ap.add_argument("--phases", help="a comma-separated subset of the "
                    "phases to run (by their phase_s names; debugging): "
                    "no kernels line and no result line")
    args = ap.parse_args(argv)
    only = set(args.phases.split(",")) if args.phases else None
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

    out = {"card": smi, "build_s": build_s}
    phase_s = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return r

    def want(name):
        return only is None or name in only

    rng = np.random.default_rng(0)
    if want("paged"):
        out["paged_cases"] = phase("paged", check_paged_kernel, device, rng)
    if want("paged_quant"):
        out["paged_quant_cases"] = phase("paged_quant",
                                         check_paged_quant_kernel, device,
                                         np.random.default_rng(3))
    if want("flash"):
        out["flash_cases"] = phase("flash", check_flash_kernels, device,
                                   exp_rate)
    if want("serve"):
        out["serve"], out["serve_launches"] = phase("serve", serve, device,
                                                    rng)
        log("serve:", json.dumps({**out["serve"], "card": smi}))
        out["profile"] = phase("profile", profile_decode, device, rng)
        log("profile:", json.dumps({**out["profile"], "card": smi}))
        out["reference"] = phase("reference", reference, device, rng)
    if want("serve_int8"):
        out["serve_int8"] = phase("serve_int8", serve_int8, device)
        log("serve int8 medians:", json.dumps({**out["serve_int8"]["median"],
                                               "card": smi}))
        out["quant_reference"] = phase("quant_reference", quant_reference,
                                       device)
    if want("train"):
        train_rec, net, batch = phase("train", train, device, rng)
        log("train:", json.dumps({
            "tokens_per_s": train_rec["tokens_per_s"],
            "step_ms_median": train_rec["step_ms_median"],
            "max_memory_allocated_bytes":
                train_rec["max_memory_allocated_bytes"], "card": smi}))
        out["train"] = train_rec
        out["train_profile"] = phase("train_profile", profile_train, net,
                                     batch)
        del net, batch
        out["train_reference"] = phase("train_reference", train_reference,
                                       device, rng)
    if want("cnn"):
        out["cnn_cases"] = phase("cnn", check_cnn_kernels, device)
    if want("resnet"):
        out["resnet"] = phase("resnet", resnet, device)
        log("resnet:", json.dumps({
            "images_per_s_fused": out["resnet"]["fused"]["images_per_s"],
            "images_per_s_xla": out["resnet"]["xla"]["images_per_s"],
            "max_memory_allocated_bytes":
                out["resnet"]["max_memory_allocated_bytes"], "card": smi}))
        out["resnet_reference"] = phase("resnet_reference",
                                        resnet_reference, device)
    if want("cnn_bwd"):
        out["cnn_bwd_cases"] = phase("cnn_bwd", check_cnn_bwd_kernels,
                                     device)
    if want("resnet_train"):
        rt = out["resnet_train"] = phase("resnet_train", resnet_train,
                                         device)
        log("resnet train:", json.dumps({
            "images_per_s_fused": rt["images_per_s"],
            "step_ms_median": rt["step_ms_median"],
            "images_per_s_xla": rt["turns_xla"]["images_per_s"],
            "max_memory_allocated_bytes": rt["max_memory_allocated_bytes"],
            "card": smi}))
        out["resnet_train_reference"] = phase(
            "resnet_train_reference", resnet_train_reference, device)
    if want("stem_bwd"):
        out["stem_bwd_cases"] = phase("stem_bwd", check_stem_bwd_kernels,
                                      device)
    if want("resnet_train_stem"):
        xla_losses = out.get("resnet_train", {}).get("against_xla", {}) \
            .get("losses_xla")
        rs = out["resnet_train_stem"] = phase(
            "resnet_train_stem", resnet_train_stem, device, xla_losses)
        log("resnet train stem:", json.dumps({
            plan: {k: rs["turns_" + plan][k]
                   for k in ("step_ms_median", "images_per_s",
                             "max_memory_allocated_bytes")}
            for plan in ("fused_stem", "fused", "xla")} | {"card": smi}))
        out["resnet_train_stem_reference"] = phase(
            "resnet_train_stem_reference", resnet_train_reference, device,
            True)
    if want("auto_plan"):
        out["auto_plan"] = phase("auto_plan", auto_plan, device)

    if only is not None:
        log(f"chip_smoke: phases {sorted(only)} passed in "
            f"{time.perf_counter() - t_start:.1f} s (a partial run: no "
            f"kernels line, no result line)")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=1)
        return 0
    total_s = time.perf_counter() - t_start
    out.update(total_s=total_s, phase_s=phase_s)
    log(f"chip_smoke: all phases passed in {total_s:.1f} s "
        f"({json.dumps({k: round(v, 1) for k, v in phase_s.items()})})")
    kernels = out["kernels"] = kernels_line(out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_line(out):
    """Every kernel's entry of the kernels line, from a run of every
    phase: each kernel's numbers at its main path's shape and its
    launches on that path (the serve, train, resnet and resnet train
    phases)."""
    paged_cases, flash_cases = out["paged_cases"], out["flash_cases"]
    main_case = next(c for c in paged_cases
                     if c["shape"] == "engine" and c["dtype"] == "bfloat16")
    csrc = "deeplearning4j_tpu_torch/nn/layers/csrc/flash_attention.cu"
    pallas = "deeplearning4j_tpu/nn/layers/pallas_attention.py"
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/serving/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/serving/paged_kernel.py:71",
        "launches": out["serve_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "max_abs_err_all": max(c["max_abs_err"] for c in paged_cases),
        "cases": paged_cases}]
    quant_cases = out["paged_quant_cases"]
    quant_main = next(c for c in quant_cases
                      if c["shape"] == "engine" and c["dtype"] == "bfloat16")
    kernels.append({
        "name": "paged_attention_quant", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/serving/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/serving/paged_kernel.py:122",
        "launches": out["serve_int8"]["launches"]["paged_attention_quant"],
        "launches_on": "the last int8 turn of the serve int8 phase",
        **{k: quant_main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms")},
        "library": "scaled_dot_product_attention on the dequantized view",
        "max_abs_err_all": max(c["max_abs_err"] for c in quant_cases),
        "cases": quant_cases})
    for name, line in (("flash_fwd", 121), ("flash_bwd_dq", 172),
                       ("flash_bwd_dkv", 213)):
        kernels.append(kernel_entry(name, csrc, f"{pallas}:{line}",
                                    out["train"]["launches"][name],
                                    flash_cases[0], flash_cases))
    for name, line in (("conv1x1", "bottleneck.py:168"),
                       ("conv3x3", "bottleneck.py:208"),
                       ("stem_conv", "stem.py:169"),
                       ("stem_pool", "stem.py:199")):
        kernels.append(cnn_entry(
            name, f"deeplearning4j_tpu/nn/layers/{line}",
            out["resnet"]["launches"][name], out["cnn_cases"]))
    for name, line in (("bwd1x1", 301), ("bwd3x3", 403)):
        kernels.append(bwd_entry(
            name, f"deeplearning4j_tpu/nn/layers/bottleneck.py:{line}",
            out["resnet_train"]["launches"][name], out["cnn_bwd_cases"]))
    # the input gradient is off fit's path (the stem's input is the
    # network input): its launches are the calibration's
    for name, line in (("stem_bwd_pool", 220), ("stem_bwd_dw", 268),
                       ("stem_bwd_dx", 305)):
        on_dx = name == "stem_bwd_dx"
        kernels.append(stem_bwd_entry(
            name, f"deeplearning4j_tpu/nn/layers/stem.py:{line}",
            (out["auto_plan"]["calibration_launches"] if on_dx
             else out["resnet_train_stem"]["launches"])[name],
            "calibrate_training_kernels" if on_dx
            else "fit with the stem engaged", out["stem_bwd_cases"]))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
