#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--json PATH]

Phases (any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernel library from the sources in the checkout;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, bf16 and f32, with the
   kernel's, the plain version's and a library call's times (CUDA
   events, L2 flushed before each launch) beside the kernel's bound;
4. serve: the port's main path at full width: the rope
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
   greedy streams equal one-shot ``sample_stream``'s.

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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOLERANCE = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# the served model and engine (bench_all.py's widest served transformer)
VOCAB, WIDTH, HEADS, LAYERS, MAX_LEN = 2048, 512, 8, 6, 1024
SLOTS, PAGE = 8, 16
N_REQUESTS, NEW_TOKENS, SYSTEM_PREFIX = 16, 128, 64


def log(*parts):
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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
# phase 4: the main path at full width
# ---------------------------------------------------------------------
def serve(device, rng):
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION)
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
    PAGED_ATTENTION.launches = 0
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
    launches = PAGED_ATTENTION.launches
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
           "paged_attention_launches": launches,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.serving.paged_kernel import (
        PAGED_ATTENTION)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    PAGED_ATTENTION.load()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s for {PAGED_ATTENTION.name}")
    for line in PAGED_ATTENTION.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {PAGED_ATTENTION.name}: {line.strip()}")

    rng = np.random.default_rng(0)
    cases = check_paged_kernel(device, rng)
    rec, launches = serve(device, rng)
    log("serve:", json.dumps({**rec, "card": smi}))
    prof = profile_decode(device, rng)
    log("profile:", json.dumps({**prof, "card": smi}))
    ref = reference(device, rng)

    main_case = next(c for c in cases
                     if c["shape"] == "engine" and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/serving/csrc/paged_attention.cu",
        "replaces": "deeplearning4j_tpu/serving/paged_kernel.py:71",
        "launches": launches, "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "max_abs_err_all": max(c["max_abs_err"] for c in cases),
        "cases": cases}]
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "build_s": build_s, "kernels": kernels,
                       "serve": rec, "profile": prof, "reference": ref}, f,
                  indent=1)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
