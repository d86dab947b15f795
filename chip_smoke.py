#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--json PATH] [--parent DIR]

Phases (any failure exits nonzero):

1. device: the card's name, power limit and top SM clock (nvidia-smi);
2. build: every CUDA kernel library (paged attention with its int8
   variant, flash attention, bottleneck, bottleneck backward, stem, stem
   backward, the fused bn -> act -> 1x1 conv, the LSTM recurrence) from
   the sources in the checkout, one nvcc each, started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, with the kernel's, the plain
   version's and a library call's times (CUDA events around the card's
   time alone, a spin holding the stream while the host enqueues; L2
   flushed before each launch) beside the kernel's bound. Paged decode
   (the pages of a row split over the warps of its block): the engine
   and GQA/verify shapes, bf16 and f32, each launched twice and bitwise
   equal, the limit shown to fail the warps' partials combined without
   their rescale (planted in the plain version); the edge rows (lengths
   0, 1, 17, 1024) in both dtypes, the 0-length row exact zeros; with
   ``--parent DIR`` (another checkout, e.g. the parent commit's tree)
   that tree's paged kernel built beside this one and timed in turns
   with it on the same inputs. Flash forward, dq and dk/dv: the
   training shape (B=4, H=8, T=8192, D=64, bf16, causal), then f32
   causal, cross attention with Tq != Tk, a key mask with one fully
   masked row, a T that is no tile multiple (f32 and bf16) and one
   under a tile (T=40, bf16), bf16 causal at head dims 32 and 128
   (T=2048: the tensor-core kernels' other tile plans), and bf16 at
   head dim 40 (off that route: the CUDA-core kernels); each
   output held to limits relative to each row's and each 64-row tile's
   own size, and in bf16 shown to tell apart a kernel that dropped its
   rounding points; in every bf16 case the forward (o, lse), dq, dk and
   dv launched twice and bitwise equal; each case records its kernels'
   route (``flash_attention.kernel_route``) and each kernel's achieved
   TFLOP/s beside its bound. Before them, the flash library's SASS
   (``cuobjdump -sass``): the tensor-core forward, dq and dk/dv kernels
   hold HMMA.16816.F32.BF16, the CUDA-core ones none. The int8
   paged decode (``paged_quant``): the engine and
   GQA/verify shapes over int8 pools with power-of-two page scales, bf16
   and f32 queries, SDPA timed on the dequantized dense view, the limits
   shown to fail two faults planted in the plain version (the V scale
   dropped; p rounded to bf16), edge rows and an out-of-pool page id;
4. serve: the serving path at full width: the rope
   TextGenerationTransformer (vocab 2048, width 512, 8 heads, 6 layers,
   max_length 1024, bf16) behind the paged GenerationEngine (8 slots,
   page size 16, prefix cache) answering 16 requests of 128 new tokens;
   every decode dispatch is one replay of the decode-step CUDA graph
   (captured in the warm-up), whose replay launches the paged kernel
   in every layer (a replay calls no wrapper, so the serving phases
   count the serving rows' kernel records and the graph launches in the
   trace of the counted run itself, ``traced``, with the counts from 0
   before it);
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
   and TPOT p50, peak memory; then a traced int8 turn, in whose trace
   every decode dispatch launches the int8 kernel once per layer and
   row 15's kernel never; the pages the
   bf16 pool's byte budget buys under int8 (>= 1.9x); ``kv_dtype=
   "auto"`` resolving as a temporary store's verdicts imply; phase 5's
   profile of the int8 engine's decode steps; with ``--calibrate`` (off
   by default) the turns' verdict recorded
   into ``KERNEL_CROSSOVER_TORCH.json`` and read back by a fresh
   ``kv_dtype="auto"``;
6c. int8 reference (``quant_reference``): in f32 with 2 layers, the
   int8 engine's greedy streams with the kernel equal those with its
   plain version swapped in, and a prefix hit equals a miss;
7. train: the training path at full width: the learned-position
   TextGenerationTransformer of bench_all.py's transformer_train_T8192
   (vocab 256, width 512, 8 heads, 6 layers, max_length 8192, Adam(3e-4),
   bf16) through ``net.fit`` on one fixed batch of 4 x 8192 tokens: one
   warm-up step, then 5 timed steps; the loss must be finite and fall,
   and each flash kernel must launch 6 times per step. Then the
   non-finite sentinel's cost (steps with its policy "off" and "skip"
   in turns), and one step on the batch with a NaN planted, which must
   leave the parameters, Adam's state and the layer state bit-equal and
   count one skipped step;
8. train reference: in f32 with 2 layers at the same width and T=1024,
   two Adam steps with the kernels and two with their plain versions
   swapped in give the same parameters;
8b. train reference bf16 (``train_reference_bf16``): bf16, 2 layers at
   the same width, T=2048, B=4: one backward of the loss from the same
   parameters and batch with the kernels (the tensor-core forward and
   backward) and with their plain versions swapped in. The kernels' o,
   lse, dq, dk and dv on the path's own tensors within phase 3b's limits
   of the plain versions' on the same arguments (the forward with p
   unrounded before P.V and dv from the unrounded p, planted in the
   plain versions, fail them); each parameter leaf's gradient within
   TRAIN_BF16_GRAD_REL (relative L2) of the plain backward's (ds
   without its delta term, planted the same way, fails it) and within
   TRAIN_BF16_GRAD_REL_ALL of all three plain versions', as phase 8
   swaps them;
9. train profile: one training step under ``torch.profiler`` (device
   busy share, launches per step, the top kernels);
10. cnn kernels: the four ResNet50 forward kernels (bottleneck conv1x1
    and conv3x3, stem conv and stem pool) against their plain versions
    at the inference path's shapes, bf16 at B=128 and f32 at B=16: each
    output row and each 64-row tile held to limits relative to its own
    size, the channel sums to 1e-5 of the sum of |output| (against the
    kernel's own stored output), the pool exactly (NaN at the same
    elements, every other element bit-equal; sc of both signs and one
    zero channel; a case with NaN and +-inf planted in y; its route, the
    C plan against stem.py's ``_stem_fwd_pool_plan``, and two planted
    faults, the window's maximum alone and a NaN-dropping maximum, which
    must fail; with ``--parent DIR`` the parent tree's pool timed in
    turns and its NaN count on the planted case); in bf16 the check is
    shown to fail a version that skips the rounding of the activated
    input before the dot, and every case is launched twice, bitwise
    equal; the bf16 and f32 conv launchers given partial sums one pixel
    block short of their grid (the bf16 3x3: one patch short) refuse.
    Times of the kernel, the plain version and the nearest library call
    (a cuBLAS matmul on the activated input, cuDNN's conv,
    ``F.max_pool2d``) beside the bound. Before them, the bottleneck
    library's SASS: each bf16 forward function (the tensor cores,
    ``conv_fwd_tc.cuh``) holds 144 HMMA.16816.F32.BF16 (the 3x3) or 64
    (the 1x1), the f32 ones none, with their registers and spills from
    ``ptxas -v`` and their shared memory (the forward pool's four
    functions too, none may spill). Three ragged cases
    in bf16 and f32 at B=3 (C=20, K=36: no multiple of 8; a 1x1 and a
    3x3 over 9x13 images, whose patches cross images; a stride-2 1x1 at
    10x14) on the same limits, and three ragged pools (111x113, 8x9 at K
    = 36, 9x13 at K = 34: the element route). Then the sweep: every distinct forward
    conv of a ResNet50 forward at 224x224, B=128, bf16 (per stage s2-s5:
    conv_a of the first block, strided from s3 on, and of the later
    ones, the 3x3 conv_b, conv_c and the conv shortcut), each against
    its plain version once on the same limits, with its kernel and
    library times, bound and launches a forward, and the launch-weighted
    totals a forward; last the NaN bar (``nan_bar``, ROADMAP C4): one NaN
    planted in the input of a small bf16 and f32 conv1x1 and conv3x3
    (the relu prologue of ``conv_mma.cuh``'s z8 and ``conv_gemm.cuh``),
    the output and sums NaN at exactly the plain version's elements and
    within the limits elsewhere, the bar shown failing on the plain
    version with the NaN dropped and, with ``--parent DIR``, on the
    parent tree's kernels (``parent_kernels``: that tree's library built
    from its source and launched through this tree's wrappers), which
    ``--parent`` also times in turns with this tree's at the s2 conv_c
    and 3x3 (rows 1, 2);
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
13. cnn bwd kernels: first the library's SASS (HMMA.16816.F32.BF16 in
    every tensor-core function of ``conv_bwd_tc.cuh``'s stage mode, none
    in the f32 ones; with ``--parent DIR`` each stage function's HMMA
    count, registers and spill stores equal to the parent tree's, and
    two bf16 1x1 cases bitwise equal to its kernel's); then the two
    ResNet50 backward kernels (a bottleneck
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
    channels-last) beside the bound. Two ragged cases in bf16 and f32 at
    B=3 (C=20, K=36: no multiple of 8; M = 147, no multiple of a row
    tile; a stride-2 1x1 and a 7x7 3x3) on the same limits; every bf16
    case launched twice, bitwise equal. Then the sweep: every distinct
    backward stage of a ResNet50 step at B=128, bf16 (per stage s2-s5:
    the 1x1 stages c, a (first block, strided from s3 on), a (later
    blocks) and the conv shortcut, and the 3x3), each against its plain
    version once on the same limits, with its kernel and cuDNN times,
    bound and launches a step, and the launch-weighted totals a step;
    with ``--parent`` the s2 1x1 and 3x3 stages in turns with the parent
    tree's kernels (rows 3, 4); last the NaN bar of phase 10 at the
    bwd1x1 and bwd3x3 stages, one NaN planted in yprev (the recomputed
    prologue of ``conv_mma.cuh`` and ``bottleneck_bwd.cu``);
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
    channels-last) beside the bound. The bf16 weight gradient runs one
    pass on the tensor cores (``stem.stem_dw_route``): before the cases
    the stem library's SASS (128 HMMA.16816.F32.BF16 in that function,
    none in the CUDA-core GEMM; its registers, spills and shared
    memory), its dy and dW launched twice and bitwise equal, dy's
    largest difference from the plain version printed (0 expected), the
    device kernels one call starts on each route (the library's own
    counts: bf16 the pass and its reduction, no dy pass; f32 the dy
    pass, the GEMM and the reduction), a partials buffer one grid row
    short refused, and ragged cases in bf16 and f32 at B=3 (9x13 and
    15x17 images, C=4, K=36) of all three kernels on the same limits
    (the bf16 dW also from an x one element off 16-byte alignment,
    bitwise equal). The bf16 input gradient at 4 C <= 16 and K <= 64
    runs on the tensor cores too (``stem.stem_dx_route``): 96 HMMA in
    its function at C = 3, 4 (48 at C = 1, 2), none spilling, its dx
    launched twice and bitwise equal and from a dy one element off
    16-byte alignment, the device kernels of each route (bf16 the
    tensor-core pass, f32 the CUDA-core one), and the launcher refusing
    K = 65 and C = 5 (no launch); with ``--parent`` the pool backward in
    turns with the parent tree's (row 9); last the NaN bar of phase 10
    at the pool backward, one NaN planted in y inside two windows (its
    relu and the bf16 and f32 window maxima of ``stem_bwd.cu``: a window
    holding NaN sends no gradient);
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
    spread of step times, or faster, in turns;
20. fused kernels (``fused_kernels``): the fused bn -> act -> 1x1 conv's
    forward and one-pass backward kernels against their plain versions
    at the four stages' group shapes (56x56 64 -> 256, 28x28 128 -> 512,
    14x14 256 -> 1024, 7x7 512 -> 2048), bf16 at B=128 and f32 at B=16,
    a tail of M = 147 rows whose inputs are views of buffers with NaN
    rows after them, and a ragged group (C = 20, K = 36: the bf16
    kernels' element-wise copies): out, dy and dW by row and 64-row tile
    as in phase 10, dsc, dbb and db within 1e-6 of each channel's sum of
    |terms|, everything finite, two backward launches bitwise equal, the
    backward's route (bf16 the tensor cores: bwd1x1's kernels of
    ``conv_bwd_tc.cuh`` in their fused mode; f32 the CUDA cores), plan
    and shared memory recorded; in bf16 the limits fail four faults
    planted through the plain versions (no relu in the prologue, no
    relu' mask on dz, dW from the unrounded z, the sums over the
    bf16-rounded dz); with ``--parent DIR`` the parent tree's forward and
    backward timed in turns at every stage (rows 5, 6); last the NaN bar
    of phase 10 for the fused forward.
    Times of the kernels, the plain versions and cuBLAS (``torch.matmul``
    on the activated input; ``g @ W^T`` and ``z^T @ g``) beside the
    bounds. The bf16 forward is the bottleneck's tensor-core 1x1
    (``conv_fwd_tc.cuh``, bias epilogue): before the cases the fused
    library's SASS (64 HMMA.16816.F32.BF16 in each bf16 forward
    function, none in the f32 one; HMMA in every bf16 backward function,
    none in the f32 ones, no backward function spilling), and every
    forward launched twice, bitwise equal;
21. resnet fuse_true (``resnet_fuse_true``): ResNet50(fuse=True) at full
    width (1000 classes, 224x224, B=128, bf16, NHWC): one counted
    ``output()`` (BN statistics calibrated as phase 11's; 16 fused
    forward launches, none of the bottleneck or stem kernels), the
    probabilities finite with rows summing to 1, the logits against the
    plain versions' and a planted fault (one group's prologue without its
    relu) beyond the limit, ``output()`` of the fuse=True and xla plans
    in turns; then bench_all.py's bench_train_plan with ``fuse=True``
    through ``net.fit``: a warm-up step and 5 timed steps, 16 fused
    forward and 16 fused backward launches a step and none of the other
    CNN kernels, the loss finite and its first four values within 3e-2
    of the xla plan's from the same seed, ms per step, images/s and peak
    memory of the fuse=True and xla plans in turns, one profiled step;
22. resnet fuse_true reference (``resnet_fuse_true_reference``): phase
    15 on fuse=True: two f32 fit steps at B=8 with the kernels against
    the plain versions and the xla plan by update_err, leaf by leaf; one
    group's backward without its relu' mask (through the kernels) fails
    the limit.

23. lstm kernels (``lstm_kernels``): the LSTM recurrence's forward and
    backward kernels against their plain versions, bf16 and f32: the
    text LSTM's shape (T = N = H = 256) with and without peepholes, the
    decode shape (N = T = 1), a mask with fully masked steps and a fully
    masked row (forward), an H of 200 that splits unevenly, T = 8, and
    ``lstm_scan(reverse=True)`` (forward and autograd gradients against
    the plain versions swapped in): outputs, saves and gradients by row
    and 64-row tile, two forward and two backward launches bitwise
    equal, each kernel's route (the cluster kernels up to H = 256, the
    cooperative ones beyond) and the device kernel it started, the
    limits shown to fail planted faults (the output gate's peephole on
    the previous cell; no mask blend of c; in bf16 the carry left
    unrounded; a peer's piece of h read a step stale). Times of the
    kernels (inference forward, training forward, backward), the plain
    versions and cuDNN's LSTM (no peepholes) beside the bounds, per step
    too; with ``--parent DIR`` the parent tree's forward (main and
    decode) and backward in turns;
24. text_lstm (``text_lstm``): bench_all.py's bench_lstm at full width
    (TextGenerationLSTM, vocab 128, 2 GravesLSTM layers of 256,
    RmsProp(1e-3), bf16, B=256, T=256): one counted ``output()`` (2
    forward launches; probabilities finite, rows summing to 1; ms per
    forward), ``sample_stream`` with a 32-token prompt and 256 new
    tokens (2 launches a decode step; tokens/s; the streamed
    probabilities against one-shot ``output()``), then ``fit``: a
    warm-up step and 5 timed steps (2 forward and 2 backward launches a
    step; the loss finite and falling; ms per step, tokens/s, peak
    memory; one profiled step);
25. text_lstm reference (``text_lstm_reference``): f32, full width,
    T = 64: ``output()`` and two RmsProp fit steps with the kernels
    against the same with the plain versions swapped in (probabilities
    by row and tile, parameters and g2 by update_err), and a planted
    backward fault (the peephole gradient dropped) beyond the limit;
26. serializer (``serializer``): the port's model archives. Phase 24's
    text LSTM (bf16) after one fit step, written with ``write_model`` to
    a temporary directory and restored with ``restore_model`` onto the
    card: parameters, updater state and ``output()`` bitwise equal to
    the original's, one more fit step from each with losses within 1e-6
    relative; then ``tests/fixtures/regression_tfm_v1.zip`` (the JAX
    package's archive) restored onto the card, its output within 5e-3
    of the fixture's ``_output.npy``, the flash forward's launches
    recorded;
27. regularized_lstm (``regularized_lstm``): phase 24's text LSTM at full
    width (bf16, B = T = 256) with A1's training hooks: Dropout(0.9) on
    each LSTM's input, DropConnect(0.95) on the second's weights,
    MaxNormConstraint(0.75) on their weights, xavier_uniform init, the
    output bias at 0.1, AdaMax: a warm-up and 3 timed ``fit`` steps (2 +
    2 recurrence launches a step, the scan route never; columns rescaled
    by the constraint in every step; the loss finite and falling), the
    net written and restored onto the card bitwise
    (parameters, AdaMax's state, ``output()``), ms a step and peak memory
    against phase 24's unregularized net in turns (a report); in f32 at
    T = 64 the kernels against the plain versions with the same masks
    (losses within 1e-4, parameters and AdaMax state by update_err, a
    run with other masks beyond the limit); a hardsigmoid-gated LSTM on
    the scan route on the card against the same net on the CPU.
28. fit graphs (``fit_graph_transformer``, ``fit_graph_resnet``): the
    fit loop's K-step CUDA graph (``nn/network_base.py``). Phase 7's
    transformer (T 8192, B 4, bf16, 6 layers) and ResNet50 at B = 128
    (bf16, Nesterovs(0.01)) on fuse=True and on the fused plan with the
    stem: ``fit(steps_per_dispatch=4, prefetch=2)`` over 12 batches
    against the eager ``fit`` (K = 1, no prefetch), each from the same
    trees. Two eager fits first: where they agree bit for bit, the graph
    fits' losses and trees (parameters, updater state, BN statistics)
    must equal theirs bit for bit, else lie within twice their
    difference; one capture, the first group eager, then one replay per
    4 steps (the fit's dispatch counts); the turns graph, eager, eager,
    graph (ms a step); a steady-state profile of each (the Chrome
    trace's device busy share, host launch calls a step, the port's
    kernels a step by device function, equal in the graph and eager
    fits; the flash kernels 6 a step); one replay timed on the card;
    peak memory. cuDNN runs deterministic algorithms in the ResNet50
    runs;
29. fit graph sentinel (``fit_graph_sentinel``): the transformer cut to
    2 layers, one NaN in the third batch of a replayed group: the graph
    fit's losses and trees as the eager fit's skip leaves them, the
    registry's ``dl4jtpu_bad_steps_total`` and
    ``_skipped_updates_total`` up by one each; the same run with the
    device select removed (planted) fails;
30. fit graph draws (``fit_graph_draws``): networks whose training
    draws through the K-step graph. An MLP with Dropout(0.9) and
    WeightNoise: ``fit(steps_per_dispatch=4)`` twice (warm, capture,
    replays; then replays only) against two eager fits from the same
    trees and training generator state, bitwise by the gate, and a run
    with the graph's generators not re-offset before each replay
    (planted) failing it. The regularized text LSTM of phase 27 without
    tBPTT (bf16, B = T = 256) through ``graph_phase``: rows 17 and 17b
    inside the replays twice a step each, as in the eager fit. A bf16
    GravesLSTM of 512 units (the cooperative route) captured and gated
    the same way;
31. prefetch (``prefetch_lstm``): phase 24's text LSTM over 6 batches,
    ``fit(prefetch=2)`` against ``fit()`` in turns from the same trees:
    losses and trees bitwise equal; ms a step, the busy share, the
    copies' device time, and the copy's share of the critical path (the
    pageable copy without prefetch; with it, the compute stream's timed
    wait on each batch's copy event);
32. durable transformer (``durable_transformer``): phase 28's transformer
    through ``fit(steps_per_dispatch=4, prefetch=2)`` over 12 batches
    with a CheckpointListener (a save every 4 iterations, asynchronous,
    the newest 2 kept): a straight run (each save's snapshot, queue and
    wait ms, write s and bytes), the step with and without the listener
    in turns; a child process (this script with ``--durable-child
    kill``) running the same fit with a ProcessKillInjector at batch 9
    must die by SIGKILL leaving verified checkpoints, and a second child
    (``--durable-child resume``) restores the newest into a fresh
    network and finishes bitwise the straight run; in this process a
    PreemptionGuard triggered in iteration 6 saves at step 8 and raises
    PreemptionExit, and a fresh network restored from it finishes
    bitwise the straight run (restore s);
33. recovery ResNet50 (``recovery_resnet``): the stem plan's ResNet50
    (B = 128, bf16, Nesterovs(0.01)) under FaultTolerantTrainer, eager,
    a save every 2 iterations over 8 batches: RaiseOnBatch before batch
    5 restarts from the newest checkpoint and ends bitwise a straight
    run; NaN batches 4 and 5 with a DivergenceWatchdog roll back to step
    4 with the rate halved, and the next step is bitwise an eager step
    from the restored trees at the halved rate, not at the old one.

34. evaluate (``evaluate``): ``evaluate`` on both networks at full
    width, bf16. ResNet50 ``fuse=True`` (BN calibrated) over 300 seeded
    images through a DataSet, batched by 128 as the JAX package batches
    it (two full batches, a ragged 44): 16 fused forward launches a
    batch; the confusion matrix and the wire form equal
    ``Evaluation.eval`` fed the same ``output()`` heads, the counts sum
    to 300; every argmax that differs from the xla plan's sits at a
    top-two logit gap under EVAL_GAP of the row's spread; ms a batch and
    the host copy's share. The text LSTM (T = 256) on ``[N, C, T]`` labels under a labels mask
    through an iterator, 2 LSTM forward launches a batch, held the same
    way;
35. early stopping (``early_stop``): ``EarlyStoppingTrainer`` on
    ResNet50 ``fuse=True`` at B = 128 (3 epochs of 2 batches,
    ``ClassificationScoreCalculator``, ``LocalFileModelSaver``,
    ``MaxEpochsTerminationCondition``): the restored best model's logits
    equal those recorded at its save, bitwise; an
    ``InMemoryModelSaver``'s best copy unchanged while the source trains
    on, its last fit replaying a K=2 graph; an ``EvaluativeListener``
    (frequency 2) inside ``fit(steps_per_dispatch=4, prefetch=2)``
    evaluating at the JAX iterations, each evaluation equal to
    ``evaluate()`` after an eager fit stopped at its group's end, the
    fit's losses and trees bitwise those without the listener; the same
    on the drawing MLP of phase 30 (its training generator where the fit
    without the listener leaves it);
36. speculation (``serve_spec``): phase 4's configuration and traffic
    through ``SpeculationConfig(prompt_lookup_proposer(3), gamma=4)``
    against the plain engine in turns, bf16 and int8 pools, then a traced
    speculative turn of each pool, in whose trace every verify dispatch
    launches the pool's paged kernel once a layer at query width 5;
    acceptance, tokens a step, tokens/s, TPOT p50; each greedy
    request's first divergence from the plain engine at a top-two gap
    under SPEC_GAP; a profile of 20 verify steps (busy share, launches
    a step and a token); in f32 at 2 layers the speculative streams equal
    the plain engine's (bf16 and int8 pools) and ``sample_stream``'s.
37. survivable serving (``serve_survive``): phase 4's configuration
    and traffic driven by hand over a bf16 and an int8 pool, unperturbed
    and then under an ``EngineSupervisor`` with three decode faults, a
    page seizure and a seat-window fault: the rng's state at every draw
    equal to the unperturbed run's, each flip a near-tie explained by a
    distribution within SURVIVE_LOGP, the rebuilds by cause, each
    rebuild's wall time, survivors and allocated bytes (back to the old
    arena's, the int8 run's first rebuild with a free cached block a
    pool's size plus 504 KiB planted before it: ROADMAP.md C9), the
    paged kernel once a layer per dispatch and each
    capture's warm-up pass in each run's trace, the modeled KV
    bytes against the kernel's inputs' tally; a ``decode_retry`` run
    (no rebuild, streams equal), a zero budget
    (fail-all, a flight record), and tokens/s with the registry's
    handles against no-op handles in turns;
38. overload (``serve_overload``): 48 requests with deadlines and
    priorities into 8 slots over a 93-page pool with speculation:
    shedding lowest priority first, early rejection only once the rate
    calibrated, every brownout rung entered and left, the finished
    greedy streams against an unbrowned run's, ``drain()`` mid-run;
39. the LSTM arena (``serve_lstm``): phase 24's text LSTM behind the
    engine, 8 slots, 16 greedy requests of 256 new tokens: 2 forward
    launches a decode step at batch 8, the streams against
    ``sample_stream``'s (exact in f32), tokens/s and a profile against
    ``sample_stream`` at batch 1;
40. the capture's collector pause (``capture_gc``): an MLP's K-step
    graph captured while a dead network's step graph waits in a
    reference cycle, a collection made inside the capture where the
    collector is on (it may run at any allocation): one capture, finite
    losses, the collector on after it; the same fit with the pause
    taken out (planted, in a child process: this script with
    ``--capture-gc-child``) must fail with the invalidated capture;
41. the decode step as one CUDA graph (``serve_graph``): the graph
    against the engine's device part run eagerly, in turns (graph,
    eager, eager, graph), for a bf16 pool, an int8 pool, speculation at
    gamma 4 (phase 4's traffic, greedy and sampled) and the LSTM arena:
    streams and every dispatch's distributions bitwise equal, one
    capture a turn, host launch calls, kernels and the serving row's
    kernels a step from the trace (6, 6, 6, 2), busy share, tokens/s and
    TPOT p50; a stale page table planted in the graph caught; a
    supervised run's rebuilds, one capture after each, allocated bytes
    outside the graph pools back to the old arena's (REBUILD_BYTES);
42. beam search (``beam``): the text LSTM at 4 beams for 64 steps, row
    17 twice a step at batch 4, f32 equal to the plain route, bf16
    reported;
43. model-draft speculation (``spec_model``): phase 4's served
    transformer drafted by a one-layer one on the one-shot path,
    ``speculative_sample`` at gamma 4, greedy and sampled: f32 greedy
    tokens equal to ``sample_stream``'s or parting at a top-two gap
    under SPEC_GAP, every verify distribution within SPEC_MODEL_LOGP of
    one-shot ``output()``, sampled repeats equal with the rng state
    before every draw; acceptance, target forwards a token and tokens/s
    against ``sample_stream`` in bf16 turns; ``speculative_beam_search``
    at 4 beams, prompt-lookup and model drafts, f32 equal to
    ``beam_search``'s, bf16 reported. No kernel on this path (the
    one-shot stream attends the dense cache in PyTorch);
44. LeNet (``lenet``): the sequential CNN at full width on synthetic
    MNIST behind a min-max normalizer, the K=4 graph fit bitwise the
    eager fit, images/s graph against eager, ``evaluate`` above chance,
    ``feed_forward``, the archive with its normalizer restored bitwise.
    No kernel on this path (PyTorch's convolutions and pools, as the
    JAX package's are XLA's).

The last lines are the ``kernels`` JSON, the nvidia-smi line and the
result line ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits nonzero and prints no result. ``--json`` also writes every
measurement to PATH; ``--phases`` runs a subset (by their names in
``phase_s``), for debugging, and then prints neither of the last two.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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
# the non-finite sentinel's cost: fit steps with its policy "off" and
# "skip" (the default) in turns, each turn this many steps
SENTINEL_TURNS, SENTINEL_TURN_STEPS = ("off", "skip", "skip", "off"), 2
# The bf16 training-path check (train_reference_bf16): one backward of
# 2 layers at full width, T=2048, each leaf's gradient by grad_rel. On
# the H100 the kernels' dq, dk and dv sit 1.5e-6 to 4.8e-6 (tile_rel)
# from the plain versions' on the path's own tensors, yet the leaves
# upstream of both layers (layer 0, the embeddings) differ by up to
# 3.0e-3 against the plain backward and 7.6e-3 against all three plain
# versions: the bf16 casts of the network's own backward turn the few
# one-ulp differences into flips of their own. The limits sit ~3x above
# those readings; ds without its delta term reads 0.05-2.7.
TRAIN_BF16_T = 2048
TRAIN_BF16_GRAD_REL = 1e-2
TRAIN_BF16_GRAD_REL_ALL = 2e-2

# ResNet50 inference (bench.py's BATCH, bench_all.py's bench_train_plan
# configuration run forward)
RESNET_B, RESNET_HW, RESNET_CLASSES, RESNET_REF_B = 128, 224, 1000, 8
RESNET_TIMED = 5                 # timed output() calls per plan and turn
#: launches per forward: 16 conv_a + 16 conv_c + 4 conv shortcuts; the 16
#: 3x3 convs; the stem once
RESNET_LAUNCHES = {"conv1x1": 36, "conv3x3": 16, "stem_conv": 1,
                   "stem_pool": 1, "fused_fwd": 0}
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
                         "stem_bwd_dx": 0, "fused_fwd": 0, "fused_bwd": 0}
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

# ResNet50 on the bn -> act -> 1x1-conv plan (fuse=True)
#: each stage's fused group (b_bn -> b_act -> c_conv) at the main path's
#: batch: (H = W, C, K); M = B H W rows
FUSED_STAGES = {"s2": (56, 64, 256), "s3": (28, 128, 512),
                "s4": (14, 256, 1024), "s5": (7, 512, 2048)}
#: the tail case (B, H = W, C, K): M = 147 rows, no multiple of the row
#: tile; y and g are the first M rows of buffers whose later rows are NaN
FUSED_TAIL = (3, 7, 512, 2048)
#: a ragged group (B, H = W, C, K): widths that are not multiples of 8,
#: so the kernels take their element-wise copies and stores, NaN-bordered
#: as the tail
FUSED_RAGGED = (3, 7, 20, 36)
#: launches per forward: one fused forward per bottleneck block, none of
#: the bottleneck or stem kernels (the level does not touch the stem)
FUSE_TRUE_LAUNCHES = {**{n: 0 for n in RESNET_TRAIN_STEM_LAUNCHES},
                      "fused_fwd": 16}
#: launches per training step: the 16 groups' forward and backward
FUSE_TRUE_TRAIN_LAUNCHES = {**FUSE_TRUE_LAUNCHES, "fused_bwd": 16}
#: the planted faults' group among the 16, in the order of its calls
#: (forward: topological, s3b1; backward: from the output, s4b4)
FUSE_TRUE_PLANTED = 4
#: the fuse=True steps' losses held against the xla plan's (within
#: TRAIN_LOSS_AGREE): the first three. This trajectory turns chaotic one
#: step earlier than the bottleneck plan's: on the H100 the same fuse=True
#: net with only its first step through the plain versions (its first
#: velocity 1.7% apart) is 1.4e-4 and 4.1e-4 away at the second and third
#: losses and 6.5% at the fourth, so the fourth loss tells no fault
#: (the xla plan's: 0.19%, 0.19%, 0.75%, then 12%); all six are recorded,
#: and the f32 reference holds the gradients leaf by leaf
FUSE_TRUE_LOSS_AGREED = 3

# The text LSTM (bench_all.py's bench_lstm, BASELINE.json configs[2]):
# TextGenerationLSTM(vocab 128, max_length 256, RmsProp(1e-3)), 2
# GravesLSTM layers of 256, bf16, B=256, T=256
LSTM_VOCAB, LSTM_LAYERS, LSTM_B, LSTM_T, LSTM_STEPS = 128, 2, 256, 256, 5
LSTM_PROMPT, LSTM_NEW = 32, 256      # sample_stream's prompt, new tokens
LSTM_REF_T, LSTM_REF_STEPS = 64, 2   # the f32 reference
# The recurrence kernels against their plain versions, by
# flash_attention.agreement over rows (one (t, n)'s H or 4H values) and
# 64-row tiles, by dtype and by sequence length: f32 (sums in another
# order only) rows within 1e-4 and tiles within 1e-5 at any T. In bf16
# both round h and c at every step's end, but the f32 sums in another
# order flip an ulp now and then, and a flip in the carry travels through
# every later step and spreads over its row: up to T = 32 the two agree
# to ~3e-5 in the tiles (one-ulp flips; bitwise at T = 8), and a carry
# left unrounded (the planted fault) reads ~1e-3, so the "short" limits
# are rows 2^-6 (two ulps of the row's largest value) and tiles 1e-4.
# Over T = 256 the flips' spread is bf16 rounding noise of the same size
# as that fault (tiles 2.2e-4): the "long" limits, rows 2^-5 and tiles
# 1e-3, hold the kernels there, and the semantic faults (the output
# gate's peephole on the previous cell; no mask blend) read ~3e-2 and
# more at any T; the unrounded carry is recorded there, not held (nor at
# T = 1, where no carry crosses a step).
LSTM_SHORT_T = 32
LSTM_ROW = {(torch.bfloat16, "short"): 2 ** -6,
            (torch.bfloat16, "long"): 2 ** -5,
            (torch.float32, "short"): 1e-4, (torch.float32, "long"): 1e-4}
LSTM_TILE = {(torch.bfloat16, "short"): 1e-4,
             (torch.bfloat16, "long"): 1e-3,
             (torch.float32, "short"): 1e-5, (torch.float32, "long"): 1e-5}
# the f32 reference's fit steps, kernels against plain versions, by
# update_err leaf by leaf
LSTM_REF_LIMIT = 0.3
# The regularized text LSTM (regularized_lstm): bench_lstm's net with
# A1's training hooks as a DL4J character model sets them: each LSTM
# drops 10% of its input (Dropout(0.9)), the second drops 5% of its
# weights (DropConnect(0.95)), MaxNormConstraint on each LSTM's weights,
# xavier_uniform init, the output layer's bias at 0.1, AdaMax; REG_STEPS
# timed fit steps after a warm-up step, each rescaling some columns.
# REG_MAX_NORM binds: it lies under most initial column norms of three
# of the four LSTM matrices (the phase records each matrix's least,
# median and largest), so the projection rescales most of their columns
# and the updates push columns back over it each step. The f32
# reference (T =
# LSTM_REF_T) holds the kernels' losses within REG_LOSS_REL of the plain
# versions' (the same masks from the same generator seed; f32 sums in
# another order only) and the parameters and AdaMax state by update_err
# within LSTM_REF_LIMIT, and shows a run with another generator seed
# (other masks) beyond that limit. The scan route's check: a
# hardsigmoid-gated GravesLSTM of REG_SCAN_H units on the card against
# the same net on the CPU, output() and one fit step within
# REG_SCAN_TOL.
REG_MAX_NORM, REG_STEPS, REG_LOSS_REL = 0.75, 3, 1e-4
REG_SCAN_H, REG_SCAN_T, REG_SCAN_TOL = 32, 16, 1e-5


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
    from deeplearning4j_tpu_torch.nn.layers import fused, stem
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
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
            "stem_bwd_dw": stem.STEM_BWD_DW, "stem_bwd_dx": stem.STEM_BWD_DX,
            "fused_fwd": fused.FUSED_FWD, "fused_bwd": fused.FUSED_BWD,
            "lstm_fwd": lk.LSTM_FWD, "lstm_bwd": lk.LSTM_BWD}


def zero_counts():
    for c in kernel_counters().values():
        c.launches = 0


def read_counts():
    return {n: c.launches for n, c in kernel_counters().items()}


#: the serving rows' device functions (rows 15, 16 and 17): a decode
#: graph's replay calls no wrapper, so the serving phases count these
#: kernels' records in the trace of the card's activity
SERVE_ROWS = {"paged_attention": "paged_decode_split_kernel",
              "paged_attention_quant": "paged_decode_quant_kernel",
              "lstm_fwd": "lstm_fwd"}

#: the share of a serving row's launches (or of the graph launches)
#: whose records a trace may lack. On an H100, once a run has traced a
#: heavy session, a profiling session loses the first kernel records it
#: would hold (up to 45 late in a run, where the LSTM row's 20-step
#: windows read 34-36 of 40): each session opens with TRACE_WARM spin
#: kernels for those to fall on, after which the LSTM row's windows and
#: whole runs read every record. A whole served run's trace
#: (300,000-350,000 records) still lost 0-16 of a paged row's 1524-1548
#: records. At 5% one launch a step where two are due, or five of six
#: layers, fails.
TRACE_DROP = 0.05
TRACE_WARM = 256


class traced:
    """``with traced() as t:`` runs its body under ``torch.profiler``
    (the card's activity only), the card synchronized at both ends, and
    reads the trace's records from its Chrome export: ``t.rows`` each
    serving row's kernel records, ``t.kernels`` every kernel record,
    ``t.host`` the host's launch calls by name (``HOST_LAUNCHES``) and
    ``t.graph_launches`` the ``cudaGraphLaunch`` calls among them;
    ``t.read_s`` what stopping and reading the trace took, ``t.warm``
    the opening spins' records that came through (TRACE_DROP). With
    ``cpu=True`` the host's operators are traced too, and ``t.prof`` is
    the profile (``key_averages()``)."""

    #: Kineto writes each activity as ``"ph": "X", "cat": ..., "name":
    #: ...``: the records are counted in the file's bytes (a JSON parse
    #: of a whole served run's 330 MB took 5-7 s)
    RECORD = re.compile(rb'"cat": "([^"]*)", "name": "((?:[^"\\]|\\.)*)"')

    def __init__(self, cpu=False):
        self.cpu = cpu

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if self.cpu else []))
        self.prof.__enter__()
        open_session()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.read()
            self.read_s = time.perf_counter() - t0
        return False

    def read(self):
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, "rb") as f:
                raw = f.read()
        finally:
            os.remove(path)
        names = {}
        for cat, name in self.RECORD.findall(raw):
            if cat == b"kernel" or name.decode() in HOST_LAUNCHES:
                key = (cat, name)
                names[key] = names.get(key, 0) + 1
        kernels = sum(n for (cat, _), n in names.items() if cat == b"kernel")
        if kernels != raw.count(b'"cat": "kernel"'):
            raise AssertionError("traced: the trace's records are not in "
                                 "the form counted")
        #: the opening spins' records that came through
        self.warm = sum(n for (cat, name), n in names.items()
                        if cat == b"kernel" and b"spin_kernel" in name)
        self.kernels = kernels - self.warm
        self.rows = {row: sum(n for (cat, name), n in names.items()
                              if cat == b"kernel" and fn.encode() in name
                              and b"lstm_bwd" not in name)
                     for row, fn in SERVE_ROWS.items()}
        self.host = {name.decode(): n for (cat, name), n in names.items()
                     if cat != b"kernel"}
        self.graph_launches = self.host.get("cudaGraphLaunch", 0)


def open_session():
    """The opening of a profiling session: TRACE_WARM spin kernels (the
    records a session loses at its start fall on them), the card
    synchronized."""
    for _ in range(TRACE_WARM):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def without_spins(events):
    """A Chrome trace's events less the opening spins: their kernel
    records and their launch calls, the session's first TRACE_WARM
    ``cudaLaunchKernel`` calls (a spin's call stays where the session
    lost its kernel record)."""
    calls = sorted((e for e in events if e.get("name") == "cudaLaunchKernel"),
                   key=lambda e: float(e["ts"]))
    drop = {id(e) for e in calls[:TRACE_WARM]}
    return [e for e in events if id(e) not in drop and not (
        e.get("cat") == "kernel" and "spin_kernel" in e["name"])]


def trace_holds(rows, want):
    """Trace counts ``rows`` against ``want`` (name -> launches): each
    at most what is due and at least all but TRACE_DROP of it."""
    return all((1 - TRACE_DROP) * n <= rows[r] <= n for r, n in want.items())


def replay_calls(eng):
    """``eng`` with a count of its decode graphs' replays
    (``eng.replay_calls``: host calls of ``_replay``; the kernels they
    launch are the trace's)."""
    real = eng._replay
    eng.replay_calls = 0

    def replay(chunk):
        eng.replay_calls += 1
        return real(chunk)
    eng._replay = replay
    return eng


def counted(eng, fn):
    """``fn()`` with the counts from 0, ``traced``: its result and the
    run's launches. Each serving row's are its kernel records in the
    run's trace (a decode graph's replay calls no wrapper, and a
    capture's wrapper calls launch nothing); every other kernel's are
    its wrapper's. Beside them the wrapper counts, the trace's graph
    launches, the replays the engine made and the captures in the
    run."""
    zero_counts()
    r0, c0 = eng.replay_calls, eng.graph_captures
    with traced() as t:
        out = fn()
    wrapper = read_counts()
    return out, {"launches": {**wrapper, **t.rows}, "wrapper": wrapper,
                 "graph_launches": t.graph_launches,
                 "opening_spins_recorded": t.warm,
                 "replays": eng.replay_calls - r0,
                 "captures": eng.graph_captures - c0,
                 "trace_read_s": t.read_s}


def graph_pool_bytes():
    """The allocated bytes in CUDA graphs' private pools (segments of a
    pool other than the default one)."""
    return sum(seg["allocated_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or (0, 0)) != (0, 0))


#: the spin that holds the stream before each timed call (~0.5 ms at the
#: H100's top clock, far above a wrapper's host time)
SPIN_CYCLES = 1_000_000


def median_ms(fn, device, iters=30, warm=3):
    """Median time of one call of ``fn`` on the card, by CUDA events,
    with the 50 MB L2 flushed before every call (the decode step reads
    each layer's pages after the other layers evicted them). A spin
    holds the stream before the window opens, so the host has enqueued
    the call before the card reaches it and the window holds the card's
    time alone: without it, a wrapper whose host time outran the flush
    (the conv wrappers') had that time counted too."""
    flush = torch.empty(96 << 20, dtype=torch.int8, device=device)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def paged_plan(q, table, elem_bytes=None):
    """The split decode's plan for these inputs on this card, as the
    wrapper makes it (``elem_bytes``: the pool's, by default q's)."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    S, hkv, rw, D = q.shape
    return pk.decode_split_plan(
        rw, D, elem_bytes or q.element_size(), pairs=S * hkv,
        sms=torch.cuda.get_device_properties(q.device).multi_processor_count,
        n_max=table.shape[1])


def paged_no_rescale(q, kp, vp, table, lengths, W):
    """A planted fault: the split decode's partials (the plain version's
    math over each warp's share of the pages, p rounded at the share's
    own max) combined without their rescale, ``sum acc_w / sum l_w``
    (the kernel weighs each share by exp(m_w - max m))."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    S, hkv, rw, D = q.shape
    ps, n_max = kp.shape[2], table.shape[1]
    plan = paged_plan(q, table)
    wpt = plan.splits * plan.warps_per_tile
    kd, vd, mask = sdpa_inputs(q, kp, vp, table, lengths, W)
    sc = torch.einsum("nhrd,nhld->nhrl", q.float(), kd.float()) \
        * (1.0 / D ** 0.5)
    share = (torch.arange(n_max * ps, device=q.device) // ps) % wpt
    acc = lsum = 0.0
    for w in range(wpt):
        valid = mask & (share == w)
        sw = torch.where(valid, sc, torch.full_like(sc, pk.NEG_INF))
        p = torch.exp(sw - sw.amax(dim=-1, keepdim=True)) * valid
        lsum = lsum + p.sum(dim=-1, keepdim=True)
        acc = acc + torch.einsum("nhrl,nhld->nhrd", p.to(vp.dtype).float(),
                                 vd.float())
    return (acc / lsum.clamp_min(1e-30)).to(q.dtype)


#: the parent commit's paged-decode library, built once for both phases
_PARENT_PAGED = {}


def parent_paged_kernel(parent, quant=False):
    """The paged kernel of another checkout (``--parent``: the parent
    commit's tree), built from its own source beside this one's, for
    timing in turns on the same inputs; None without one. Its entry
    points take this tree's arguments (the split decode: scratch,
    counters and splits; the int8 ones also the pools' scales)."""
    if not parent:
        return None
    if not _PARENT_PAGED:
        import ctypes
        from pathlib import Path

        from deeplearning4j_tpu_torch.cuda_library import (
            CudaKernel, CudaLibrary)
        from deeplearning4j_tpu_torch.serving import paged_kernel as pk
        src = Path(parent).resolve() / "deeplearning4j_tpu_torch" / \
            "serving" / "csrc" / "paged_attention.cu"
        lib = CudaLibrary(
            "paged_attention_parent", [str(src)],
            {**{sym: pk._ARGTYPES for sym in pk._SYMBOL.values()},
             **{sym: pk._QUANT_ARGTYPES
                for sym in pk._QUANT_SYMBOL.values()}})
        _PARENT_PAGED[False] = CudaKernel(lib, "paged_attention_parent",
                                          pk._SYMBOL)
        _PARENT_PAGED[True] = CudaKernel(lib, "paged_attention_quant_parent",
                                         pk._QUANT_SYMBOL)
    return _PARENT_PAGED[quant]


def paged_launch(kernel, args, W, out):
    """One launch of the parent checkout's paged decode (``kernel``) on
    the wrapper's arguments, into ``out``, with this tree's plan and
    scratch: the bf16/f32 split decode, or (seven arguments: the int8
    pools and their scales) the int8 one."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    q, kp, vp, table, lengths = args[:5]
    S, hkv, rw, D = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    plan = paged_plan(q, table, kp.element_size())
    part = counters = None
    if plan.splits > 1:
        part = torch.empty(S * hkv * plan.splits * rw * (D + 2),
                           dtype=torch.float32, device=q.device)
        counters = pk._counters(q.device, stream, S * hkv)
    scales = tuple(t.data_ptr() for t in args[5:])
    kernel.launch(q.dtype, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                  *scales, table.data_ptr(), lengths.data_ptr(),
                  out.data_ptr(),
                  part.data_ptr() if part is not None else None,
                  counters.data_ptr() if counters is not None else None,
                  S, hkv, rw, D, kp.shape[2], table.shape[1], kp.shape[0], W,
                  plan.splits, 1.0 / D ** 0.5, stream)


def parent_turns(old, args, W, out, kern, ref, device):
    """The parent checkout's kernel (``old``) and this one's (``kern``)
    timed in turns on the same inputs (parent, kernel, kernel, parent):
    ({parent_ms, kernel_ms_turns, parent_max_abs_err}, this kernel's
    median ms); without a parent, ({}, this kernel's ms)."""
    if old is None:
        return {}, median_ms(kern, device)
    prev = torch.empty_like(out)
    paged_launch(old, args, W, prev)
    torch.cuda.synchronize()
    err = float((prev.float() - ref.float()).abs().max())

    def parent_call():
        paged_launch(old, args, W, prev)

    turns = [median_ms(parent_call, device), median_ms(kern, device),
             median_ms(kern, device), median_ms(parent_call, device)]
    return ({"parent_ms": [turns[0], turns[3]], "kernel_ms_turns": turns[1:3],
             "parent_max_abs_err": err}, float(np.median(turns[1:3])))


def check_paged_kernel(device, rng, parent=None):
    """The split decode against its plain version at the engine's shape
    and a GQA / verify shape, each dtype: within TOLERANCE, two launches
    bitwise equal, the partials combined without their rescale (planted)
    beyond the limit; the kernel's, plain version's, SDPA's and (with
    ``parent``) the parent checkout's kernel's times, the last two in
    turns with the kernel's (parent, kernel, kernel, parent). Then the
    edge rows in both dtypes."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    F = torch.nn.functional
    old = parent_paged_kernel(parent)
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
            again = pk.paged_attention(*args, query_width=W)
            torch.cuda.synchronize()
            ref = pk.paged_attention_plain(*args, query_width=W)
            fault = paged_no_rescale(*args, W=W)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            fault_err = float((fault.float() - ref.float()).abs().max())
            finite = bool(torch.isfinite(out).all())
            kd, vd, mask = sdpa_inputs(*args, W=W)
            lib = F.scaled_dot_product_attention(args[0], kd, vd,
                                                 attn_mask=mask)
            lib_err = float((lib.float() - ref.float()).abs().max())
            plan = paged_plan(args[0], args[3])

            def kern():
                return pk.paged_attention(*args, query_width=W)

            turns, ms = parent_turns(old, args, W, out, kern, ref, device)
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
                    "finite": finite,
                    "bitwise_repeat": bool(torch.equal(out, again)),
                    "planted": {"combine_without_rescale": fault_err},
                    "splits": plan.splits,
                    "warps_per_tile": plan.warps_per_tile,
                    "chunk_keys": plan.chunk_keys, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_max_abs_err": lib_err,
                    "bound_ms": bound_ms, "bound_by": bound_by, **turns}
            log("paged_attention", json.dumps(case))
            if not finite or err > TOLERANCE[dtype] or \
                    not case["bitwise_repeat"] or \
                    fault_err <= TOLERANCE[dtype]:
                raise AssertionError(f"paged_attention kernel disagrees with "
                                     f"its plain version, is not bitwise "
                                     f"repeatable, or the limit does not "
                                     f"tell the planted fault: {case}")
            cases.append(case)
    # edge rows: a 0-length row (exact zeros), a 1-token row, a row past
    # one page, a row filling its table
    for dtype in (torch.bfloat16, torch.float32):
        lengths = [0, 1, 17, MAX_LEN]
        args = paged_case(S=4, hkv=2, reps=4, W=1, D=WIDTH // HEADS,
                          ps=PAGE, n_max=MAX_LEN // PAGE, lengths=lengths,
                          dtype=dtype, device=device, seed=99)
        out = pk.paged_attention(*args, query_width=1)
        again = pk.paged_attention(*args, query_width=1)
        ref = pk.paged_attention_plain(*args, query_width=1)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        same = bool(torch.equal(out, again))
        log(f"paged_attention edge rows {lengths} {dtype}: "
            f"max_abs_err {err}, bitwise repeat {same}")
        if not bool(torch.isfinite(out).all()) or err > TOLERANCE[dtype] \
                or bool(out[0].any()) or not same:
            raise AssertionError(f"paged_attention edge rows: err {err}, "
                                 f"bitwise repeat {same}")
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


def quant_sass():
    """The int8 split decode's functions (``paged_decode_quant_kernel``,
    one per query dtype, route and row tile) with their registers and
    spills as ptxas reported them."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    pk._LIBRARY.load()
    rec = ptxas_usage(pk._LIBRARY, "paged_decode_quant_kernel")
    log("paged_attention_quant sass:", json.dumps(rec))
    if not rec:
        raise AssertionError("no paged_decode_quant_kernel function in the "
                             "paged library's ptxas log")
    return rec


def check_paged_quant_kernel(device, rng, parent=None):
    """The int8 kernel (row 15's split over int8 pools) against its
    plain version at the engine shape and the GQA/verify shape, bf16 and
    f32 queries: within QUANT_TOLERANCE, two launches bitwise equal, the
    limits shown to fail two faults planted in the plain version and the
    split's partials combined without their rescale; the kernel's, the
    plain version's and SDPA's times (SDPA on the dequantized dense
    view, its gather outside the time, as row 15's) beside the bound,
    and with ``parent`` the parent checkout's int8 kernel in turns with
    this one's. Then the edge rows, repeated, and a bad page."""
    from deeplearning4j_tpu_torch.serving import paged_kernel as pk
    from deeplearning4j_tpu_torch.serving.quant import dequantize
    F = torch.nn.functional
    old = parent_paged_kernel(parent, quant=True)
    sass = quant_sass()
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
            again = pk.paged_attention(q, kq, vq, table, lens, **kw)
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
            kd32 = dequantize(kq, ks[:, :, None, None])
            vd32 = dequantize(vq, vs[:, :, None, None])
            planted["combine_without_rescale"] = float(
                (paged_no_rescale(q, kd32, vd32, table, lens, W).float()
                 - ref.float()).abs().max())
            del kd32, vd32
            kd = dequantize(kq, ks[:, :, None, None], dtype)
            vd = dequantize(vq, vs[:, :, None, None], dtype)
            dk, dv, mask = sdpa_inputs(q, kd, vd, table, lens, W=W)
            lib = F.scaled_dot_product_attention(q, dk, dv, attn_mask=mask)
            lib_err = float((lib.float() - ref.float()).abs().max())
            plan = paged_plan(q, table, elem_bytes=1)

            def kern():
                return pk.paged_attention(q, kq, vq, table, lens, **kw)

            turns, ms = parent_turns(old, args, W, out, kern, ref, device)
            plain_ms = median_ms(lambda: pk.paged_attention_quant_plain(
                q, kq, vq, table, lens, **kw), device)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                q, dk, dv, attn_mask=mask), device)
            bound_ms, bound_by = quant_bound(q, kq, ks, lens, W)
            case = {"shape": label, "dtype": str(dtype).split(".")[-1],
                    "q": list(q.shape), "pool": list(kq.shape),
                    "lengths": [int(x) for x in lengths],
                    "max_abs_err": err, "tolerance": QUANT_TOLERANCE[dtype],
                    "planted": planted, "finite": finite,
                    "bitwise_repeat": bool(torch.equal(out, again)),
                    "splits": plan.splits,
                    "warps_per_tile": plan.warps_per_tile,
                    "chunk_keys": plan.chunk_keys,
                    "smem_bytes": plan.smem_bytes, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                    "bound_by": bound_by, **turns}
            log("paged_attention_quant", json.dumps(case))
            if not finite or err > QUANT_TOLERANCE[dtype] or \
                    not case["bitwise_repeat"]:
                raise AssertionError(f"int8 paged kernel disagrees with its "
                                     f"plain version or is not bitwise "
                                     f"repeatable: {case}")
            # the V scale dropped and the combine without its rescale fail
            # every case; p in bf16 the f32 ones (with bf16 queries the
            # output's own rounding hides it)
            caught = ["no_v_scale", "combine_without_rescale"] + (
                ["p_bf16"] if dtype == torch.float32 else [])
            if any(planted[f] <= QUANT_TOLERANCE[dtype] for f in caught):
                raise AssertionError(f"a planted fault passes the int8 "
                                     f"limit: {case}")
            cases.append(case)
    # edge rows: a 0-length row, a 1-token row, a row past one page, a
    # row filling its table, each repeated; and a page id outside the
    # pool turns its (slot, head) to NaN and nothing else
    for dtype in (torch.bfloat16, torch.float32):
        lengths = [0, 1, 17, MAX_LEN]
        q, kq, vq, table, lens, ks, vs = quant_case(
            S=4, hkv=2, reps=4, W=1, D=WIDTH // HEADS, ps=PAGE,
            n_max=MAX_LEN // PAGE, lengths=lengths, dtype=dtype,
            device=device, seed=98)
        kw = dict(query_width=1, k_scales=ks, v_scales=vs)
        out = pk.paged_attention(q, kq, vq, table, lens, **kw)
        again = pk.paged_attention(q, kq, vq, table, lens, **kw)
        ref = pk.paged_attention_quant_plain(q, kq, vq, table, lens, **kw)
        bad_table = table.clone()
        bad_table[2, 0] = kq.shape[0]
        poisoned = pk.paged_attention(q, kq, vq, bad_table, lens, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        same = bool(torch.equal(out, again))
        log(f"paged_attention_quant edge rows {lengths} {dtype}: "
            f"max_abs_err {err}, bitwise repeat {same}")
        keep = [0, 1, 3]
        if not bool(torch.isfinite(out).all()) or bool(out[0].any()) or \
                err > QUANT_TOLERANCE[dtype] or not same or \
                not bool(torch.isnan(poisoned[2]).all()) or \
                not torch.equal(poisoned[keep], out[keep]):
            raise AssertionError(f"int8 paged kernel edge rows: err {err}, "
                                 f"bitwise repeat {same}")
    return {"cases": cases, "sass": sass}


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
    route = fa.kernel_route(dtype, D)
    case = {"case": label, "dtype": str(dtype).split(".")[-1],
            "shape": [B, H, tq, tk, D], "causal": causal,
            "key_lengths": lengths,
            "routes": {"flash_fwd": route, "flash_bwd_dq": route,
                       "flash_bwd_dkv": route},
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
    if dtype == torch.bfloat16:
        # no atomics: a second launch on the same inputs is bitwise equal
        o2, lse2 = fa.flash_attention_fwd(q, k, v, km, causal)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, km, do, lse, delta, causal)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, km, do, lse, delta,
                                              causal)
        case["bitwise_repeat"] = {
            "o": bool(torch.equal(o, o2)), "lse": bool(torch.equal(lse, lse2)),
            "dq": bool(torch.equal(dq, dq2)), "dk": bool(torch.equal(dk, dk2)),
            "dv": bool(torch.equal(dv, dv2))}
        failures += [f"{n} not bitwise equal over two launches"
                     for n, same in case["bitwise_repeat"].items() if not same]
        del o2, lse2, dq2, dk2, dv2
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
        ms = median_ms(kern, device)
        timed[name] = {"ms": ms, "route": case["routes"][name],
                       "plain_ms": median_ms(plain, device, iters=10),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_terms_ms": terms,
                       # the matmul flops flash_bound counts, over the
                       # kernel's time
                       "tflops": terms["flops_ms"] / ms
                       * PEAK_FLOPS[dtype] / 1e12}
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
    the edge cases at T <= 2048: the tensor-core kernels' other head
    dims (32, the zoo default's, and 128), a bf16 head dim off that
    route (40, the CUDA-core kernels), and the ragged tails in bf16."""
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
        flash_case("causal_d32_T2048_bf16", (TRAIN_B, HEADS, 2048, 2048, 32),
                   torch.bfloat16, True, device, exp_rate, seed=7),
        flash_case("causal_d128_T2048_bf16",
                   (TRAIN_B, HEADS, 2048, 2048, 128), torch.bfloat16, True,
                   device, exp_rate, seed=8),
        flash_case("off_route_d40_bf16", (TRAIN_B, HEADS, 2048, 2048, 40),
                   torch.bfloat16, True, device, exp_rate, seed=9),
        flash_case("ragged_t_bf16", (2, HEADS, 1999, 1999, w),
                   torch.bfloat16, True, device, exp_rate, seed=10),
        flash_case("one_tile_t40_bf16", (2, HEADS, 40, 40, w),
                   torch.bfloat16, True, device, exp_rate, seed=11),
    ]
    return cases


def flash_sass():
    """The flash library's SASS (``cuobjdump -sass``): the tensor-core
    kernels' functions (forward, dq, dk/dv) must hold HMMA.16816.F32.BF16
    (mma.sync m16n8k16, bf16 in, f32 out) and the CUDA-core ones none.
    Returns {function: HMMA count} by kernel template."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    counts, tool = sass_hmma(fa._LIBRARY)
    by_kernel = {}
    for name in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel", "flash_fwd_mma_kernel",
                 "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel"):
        by_kernel[name] = {f: c for f, c in counts.items()
                           if f"{len(name)}{name}I" in f}
    rec = {"tool": tool, "hmma_16816_f32_bf16": by_kernel}
    log("flash sass:", json.dumps(rec))
    for name, fns in by_kernel.items():
        tc = "_mma_" in name
        if not fns or any((c == 0) if tc else (c != 0) for c in fns.values()):
            raise AssertionError(f"flash sass: {name} "
                                 f"{'lacks' if tc else 'has'} "
                                 f"HMMA.16816.F32.BF16: {fns}")
    return rec


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
    engine = replay_calls(GenerationEngine(
        net, VOCAB, slots=SLOTS, paging=PagedKVConfig(page_size=PAGE),
        device=device))
    requests = serve_requests(rng)
    t0 = time.perf_counter()
    engine.warmup(max_prompt_len=300)      # it captures the decode graph
    warm_s = time.perf_counter() - t0
    engine.ttft_s.clear()
    engine.tpot_s.clear()
    d0, hits0 = engine.dispatches, engine.prefix_cache.hits

    def run():
        engine.start()
        t0 = time.perf_counter()
        handles = [engine.submit(p, steps=NEW_TOKENS,
                                 rng=np.random.default_rng(i), **kw)
                   for i, (p, kw) in enumerate(requests)]
        outs = [h.result(timeout=600) for h in handles]
        dt = time.perf_counter() - t0
        engine.shutdown()
        return handles, outs, dt
    (handles, outs, dt), c = counted(engine, run)
    dispatches = engine.dispatches - d0
    launches = c["launches"]["paged_attention"]
    reasons = [h.finish_reason for h in handles]
    generated = sum(len(o) - len(p) for o, (p, _) in zip(outs, requests))
    if reasons != ["length"] * N_REQUESTS or \
            generated != N_REQUESTS * NEW_TOKENS:
        raise AssertionError(f"serve: reasons {reasons}, {generated} tokens")
    if not all(0 <= t < VOCAB for o in outs for t in o):
        raise AssertionError("serve: token id out of range")
    # the trace: every dispatch one graph launch, whose replay runs the
    # paged kernel once a layer
    if dispatches == 0 or not trace_holds(
            {"paged_attention": launches},
            {"paged_attention": dispatches * LAYERS}) or \
            not trace_holds({"graphs": c["graph_launches"]},
                            {"graphs": dispatches}) or \
            c["replays"] != dispatches or c["captures"] or \
            engine.graph_captures != 1:
        raise AssertionError(f"serve: {launches} paged kernel launches "
                             f"in the trace for {dispatches} decode "
                             f"dispatches x {LAYERS} layers ({c}); "
                             f"captures {engine.graph_captures}")
    rec = {"requests": N_REQUESTS, "new_tokens": NEW_TOKENS,
           "prompt_tokens": [len(p) for p, _ in requests],
           "generated_tokens": generated, "wall_s": dt,
           "tokens_per_s": generated / dt, "timed_under_trace": True,
           "ttft_p50_ms": 1e3 * float(np.median([h.ttft_s for h in handles])),
           "tpot_p50_ms": 1e3 * float(np.median(engine.tpot_s)),
           "decode_dispatches": dispatches,
           "decode_dispatch_mean_ms":
               1e3 * engine.dispatch_s_total / engine.dispatches,
           "paged_attention_launches": launches,
           "launches_from": "the run's trace",
           "replays": c["replays"], "graph_launches": c["graph_launches"],
           "trace_read_s": c["trace_read_s"],
           "opening_spins_recorded": c["opening_spins_recorded"],
           "launches": c["launches"], "wrapper_launches": c["wrapper"],
           "graph_captures": engine.graph_captures,
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
    with the most device time, and the share of it in the paged kernels
    (the int8 one's apart). ``kv_dtype`` is the pool's ("int8" in the
    serve int8 phase). Launches are the trace's records (``traced``),
    device time ``key_averages()``'s."""
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
                      steps=5 * steps + 16, top_k=1)
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
            # the decode graph holds what was captured: capture the swap
            # (one untimed step), time its replays
            engine._drop_graphs()
            engine.step()
            timed[label] = step_ms(engine, steps)
        finally:
            table.update(old)
            engine._drop_graphs()
    engine.step()               # the shipped graph again
    timed["shipped"].append(step_ms(engine, steps))
    if not engine.is_healthy() or \
            sum(r is not None for r in engine._slots) != SLOTS:
        raise AssertionError(f"profile: the engine stopped decoding "
                             f"({engine._broken!r})")
    with traced(cpu=True) as t:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.shutdown()
    kernels = [e for e in t.prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and "spin_kernel" not in e.key]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy_us = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    # the replays' paged kernels in the trace: one a layer a step
    rows = {r: n / steps for r, n in t.rows.items()}
    key = "paged_attention_quant" if kv_dtype == "int8" \
        else "paged_attention"
    if not trace_holds(t.rows, {key: LAYERS * steps}):
        raise AssertionError(f"profile: {rows} a step in the trace")
    return {"steps": steps, "step_ms_unprofiled": timed,
            "row_launches_per_step": rows,
            "step_ms": 1e3 * wall / steps,
            "device_busy_share": busy_us / (wall * 1e6),
            "kernel_launches_per_step": t.kernels / steps,
            "paged_kernel_share_of_device_time": (
                sum(t for k, t in dev_us.items()
                    if "paged_decode" in k) / busy_us
                if busy_us else None),
            # the int8 kernel's alone (the int8 pool's decode)
            "paged_quant_kernel_share_of_device_time": (
                sum(t for k, t in dev_us.items()
                    if "paged_decode_quant" in k) / busy_us
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


def serve_turn(engine, requests, keep_outs=False, trace=False):
    """Serve ``requests`` through a warmed engine's background loop;
    returns the turn's numbers (tokens/s, the decode dispatches' mean
    ms, TTFT and TPOT p50, peak device memory), its replays and graphs
    (and, with ``keep_outs``, the streams under "outs"); with ``trace``
    the run is ``counted`` (its launches, the serving rows' from its
    trace, whose records its times then pay for: a timed turn is not
    traced)."""
    engine.ttft_s.clear()
    engine.tpot_s.clear()
    d0, s0 = engine.dispatches, engine.dispatch_s_total
    c0 = engine.graph_captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        engine.start()
        t0 = time.perf_counter()
        handles = [engine.submit(p, steps=NEW_TOKENS,
                                 rng=np.random.default_rng(i), **kw)
                   for i, (p, kw) in enumerate(requests)]
        outs = [h.result(timeout=600) for h in handles]
        dt = time.perf_counter() - t0
        widths.extend(sorted(engine._graphs))   # shutdown drops them
        engine.shutdown()
        return handles, outs, dt
    widths = []
    r0 = engine.replay_calls
    if trace:
        (handles, outs, dt), c = counted(engine, run)
    else:
        handles, outs, dt = run()
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
            "traced": trace,
            **({"launches": c["launches"], "wrapper_launches": c["wrapper"],
                "graph_launches": c["graph_launches"],
                "trace_read_s": c["trace_read_s"],
                "opening_spins_recorded": c["opening_spins_recorded"]}
               if trace else {}),
            "replays": engine.replay_calls - r0,
            "graph_widths": widths,
            "captures": engine.graph_captures - c0,
            **({"outs": outs} if keep_outs else {})}


def serve_int8(device, calibrate=False):
    """Phase 4's configuration with ``kv_dtype="int8"``: the same
    requests through the int8 engine and the bf16 engine in turns (int8,
    bf16, bf16, int8), then a traced int8 turn, in whose trace every
    decode dispatch launches the int8 kernel once per layer and row 15's
    kernel never; the pages the bf16
    pool's byte budget buys under int8; ``kv_dtype="auto"`` resolving as
    a temporary store's verdict implies (the turns' measured verdict,
    another card's entry, a synthetic win). With ``calibrate``
    (``--calibrate``; off by default, so the default run writes
    nothing) the turns' verdict (ms a token, int8
    against bf16) is also recorded into the store at
    ``tuning/crossover.default_path()``, and a fresh load of that file
    must make ``kv_dtype="auto"`` resolve as the verdict says."""
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
    counted_turns = {}
    # the timed turns, then a traced int8 turn for its launches (the bf16
    # pool's are the serve phase's traced run)
    for i, kv in enumerate(("int8", "bf16", "bf16", "int8", "int8")):
        trace = i >= 4
        eng = engines[kv] = replay_calls(GenerationEngine(
            net, VOCAB, slots=SLOTS, device=device,
            paging=PagedKVConfig(page_size=PAGE, kv_dtype=kv)))
        eng.warmup(max_prompt_len=300)
        rec = serve_turn(eng, requests, trace=trace)
        n = rec["decode_dispatches"]
        if n == 0 or rec["captures"] or rec["graph_widths"] != [1] or \
                rec["replays"] != n:
            seen = {k: rec[k] for k in ("captures", "graph_widths",
                                        "replays", "decode_dispatches")}
            raise AssertionError(f"serve int8: {kv} turn {seen}")
        if trace:
            want = {"paged_attention_quant": n * LAYERS,
                    "paged_attention": 0}
            got = {k: rec["launches"][k] for k in want}
            if not trace_holds({**got, "graphs": rec["graph_launches"]},
                               {**want, "graphs": n}):
                raise AssertionError(
                    f"serve int8: {kv} turn's trace holds {got} and "
                    f"{rec['graph_launches']} graph launches, want {want} "
                    f"and {n}")
            counted_turns[kv] = rec
        else:
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
    persisted = None
    if calibrate:
        from deeplearning4j_tpu_torch.tuning import record_quant_verdict
        from deeplearning4j_tpu_torch.tuning.crossover import default_path
        entry = record_quant_verdict(key, med["int8"]["tokens_per_s"],
                                     med["bf16"]["tokens_per_s"],
                                     device=device)
        path = default_path()
        reset_default_store(KernelCrossoverStore.load(path))
        try:
            eng = GenerationEngine(net, VOCAB, slots=SLOTS, device=device,
                                   paging=PagedKVConfig(page_size=PAGE,
                                                        kv_dtype="auto"))
        finally:
            reset_default_store(None)
        want = "int8" if winner(entry) == "kernel" else "bf16"
        persisted = {"path": path, "entry": entry, "kv_dtype": eng._kv_dtype,
                     "want": want}
        log("serve int8 persisted verdict:", json.dumps(persisted))
        if eng._kv_dtype != want:
            raise AssertionError(f"the persisted verdict resolved "
                                 f"{eng._kv_dtype}, want {want}")
        del eng
    del engines, e16, e8
    torch.cuda.empty_cache()
    rec = {"turns": turns, "counted_turns": counted_turns, "median": med,
           "pages": pages, "auto": auto, "quant_key": key,
           "persisted": persisted,
           "launches": counted_turns["int8"]["launches"],
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


def timed_fit(net, x, y):
    """Wall seconds of one fit step that ends in a host read of its
    loss, and the loss."""
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=TRAIN_B)
    loss = net.score_value
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss


def sentinel_turns(net, x, y):
    """The sentinel's cost: fit steps with the policy "off" and "skip"
    in turns (SENTINEL_TURNS), each step's ms by policy."""
    ms = {p: [] for p in set(SENTINEL_TURNS)}
    try:
        for policy in SENTINEL_TURNS:
            net.nonfinite_policy = policy
            for _ in range(SENTINEL_TURN_STEPS):
                ms[policy].append(1e3 * timed_fit(net, x, y)[0])
    finally:
        net.nonfinite_policy = None
    return {"turns": list(SENTINEL_TURNS), "steps_per_turn":
            SENTINEL_TURN_STEPS, "step_ms": ms,
            "step_ms_median": {p: float(np.median(t)) for p, t in
                               ms.items()}}


def nan_step(net, x, y):
    """One fit step on the batch with one NaN planted in its features,
    under the default policy: the parameters, Adam's state (t included)
    and the layer state must stay bit-equal on the card, and the
    sentinel must count one bad, skipped step."""
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    bad = x.copy()
    bad[1, 7, TRAIN_T // 2] = np.nan
    acct = net._sentinel_accounting
    counts0 = (acct.bad_steps, acct.skipped_updates, acct.total_steps)
    trees = (net.params, net.updater_state, net.state)
    before = [[t.clone() for t in tree_leaves(tree)] for tree in trees]
    net.fit(bad, y, batch_size=TRAIN_B)
    loss = net.score_value
    after = [tree_leaves(tree) for tree in (net.params, net.updater_state,
                                            net.state)]
    equal = {name: len(a) == len(b) and all(
        torch.equal(u, w) for u, w in zip(a, b))
        for name, a, b in zip(("params", "updater_state", "state"), after,
                              before)}
    rec = {"loss": loss, "bit_equal": equal,
           "adam_t": int(net.updater_state["t"]),
           "bad_steps": acct.bad_steps - counts0[0],
           "skipped_updates": acct.skipped_updates - counts0[1],
           "steps": acct.total_steps - counts0[2]}
    if np.isfinite(loss) or not all(equal.values()) or \
            (rec["bad_steps"], rec["skipped_updates"], rec["steps"]) != \
            (1, 1, 1):
        raise AssertionError(f"train: the NaN step was not skipped: {rec}")
    return rec


def train(device, rng):
    """bench_all.py's transformer_train_T8192 through ``net.fit``: one
    warm-up step, then TRAIN_STEPS timed steps on one fixed batch, with
    every kernel count set to 0 just before them and read just after.
    Then the sentinel's policy "off" and "skip" in turns, and one step
    on the batch with a NaN planted, which must change nothing."""
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
        s, loss = timed_fit(net, x, y)     # a host read of the loss
        step_s.append(s)
        losses.append(loss)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    turns = sentinel_turns(net, x, y)
    nan = nan_step(net, x, y)
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
           "sentinel_turns": turns, "nan_step": nan,
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


def loss_grads(net, x, y):
    """The loss and its gradient at the net's parameters, leaf by leaf
    (``"vertex/name"``), by autograd through the training forward, as a
    fit step takes it before the updater."""
    params = {v: {n: t.detach().requires_grad_() for n, t in p.items()}
              for v, p in net.params.items()}
    inputs = {net.conf.network_inputs[0]: net._tensor(x)}
    labels = {net.conf.network_outputs[0]: net._tensor(y)}
    loss, _ = net._loss(params, inputs, labels)
    leaves = [(v, n) for v, p in params.items() for n in p]
    grads = torch.autograd.grad(loss, [params[v][n] for v, n in leaves],
                                allow_unused=True)
    return float(loss.detach()), {f"{v}/{n}": g.float() for (v, n), g in
                         zip(leaves, grads) if g is not None}


def grad_rel(got, want):
    """Each leaf's ||got - want|| over ||want||; an attention key bias
    (exact gradient zero: softmax ignores a shift shared by every key)
    over its layer's key weights' ||want|| instead."""
    out = {}
    for leaf, w in want.items():
        ref = want[leaf[:-2] + "Wk"] if leaf.endswith("/bk") else w
        out[leaf] = float(torch.linalg.vector_norm(got[leaf] - w)
                          / torch.linalg.vector_norm(ref).clamp_min(1e-30))
    return out


def dkv_without_delta(q, k, v, km, do, lse, delta, causal=False):
    """A planted fault: the plain dk/dv with ds = p dP scale (the delta
    term dropped)."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    return fa.flash_attention_bwd_dkv_plain(q, k, v, km, do, lse,
                                            torch.zeros_like(delta), causal)


def dkv_unrounded_p(q, k, v, km, do, lse, delta, causal=False):
    """A planted fault: the plain dk/dv with dv from the unrounded f32 p
    (no bf16 rounding point before p^T.dO)."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    dk, _ = fa.flash_attention_bwd_dkv_plain(q, k, v, km, do, lse, delta,
                                             causal)
    p = fa._probs(q, k, km, lse, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.to(p.dtype))
    return dk, dv.to(v.dtype)


def fwd_unrounded_p(q, k, v, km, causal=False):
    """A planted fault: the plain forward with p left unrounded before
    P.V (f32 p times the widened V), o rounded as a kernel stores it."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    o, lse = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                          km, causal)
    return o.to(q.dtype), lse


def fwd_on_path(args, got):
    """A forward's (o, lse) on the training path's own arguments against
    the plain version's on the same arguments, by phase 3b's measures:
    o's row and tile agreement, lse's largest error, and o's distance
    (tile) from the forward without its rounding point. Returns (record,
    failures)."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    o, lse = got
    ref_o, ref_lse = fa.flash_attention_fwd_plain(*args)
    row_rel, tile_rel = fa.agreement(o, ref_o)
    rec = {"row_rel": row_rel, "tile_rel": tile_rel,
           "lse_max_abs_err": max_err(lse, ref_lse),
           "o_from_unrounded": fa.agreement(o, fwd_unrounded_p(*args)[0])[1]}
    failures = [n for n, bad in (
        ("o row", row_rel > FLASH_ROW[torch.bfloat16]),
        ("o tile", tile_rel > FLASH_TILE[torch.bfloat16, "o"]),
        ("lse", rec["lse_max_abs_err"] > FLASH_LSE),
        ("o is the unrounded forward",
         rec["o_from_unrounded"] < FLASH_UNROUNDED)) if bad]
    return rec, failures


def train_reference_bf16(device, T=TRAIN_BF16_T, B=TRAIN_B):
    """bf16, 2 layers at full width, T=2048: one backward of the loss
    from the same parameters and batch. The forward, dq and dk/dv
    kernels' outputs on the path's own tensors against the plain
    versions on the same arguments, by phase 3b's row, tile and lse
    limits, which the forward with p unrounded before P.V and dv from
    the unrounded p (planted in the plain versions) fail. Then leaf by
    leaf (grad_rel): the kernels against the plain dq and dk/dv swapped in
    (the forward kernel in both) within TRAIN_BF16_GRAD_REL, a limit
    that ds without its delta term (planted in the swapped-in plain
    dk/dv) fails; and against all three plain versions swapped in, as
    phase 8 swaps them, within TRAIN_BF16_GRAD_REL_ALL. dv from the
    unrounded p is measured leaf by leaf too, held to nothing there."""
    from deeplearning4j_tpu_torch.nn.layers import flash_attention as fa
    net = train_model(2, T, seed=13).init(device=device)
    net.conf.dtype = "bfloat16"
    x, y = one_hot_batch(np.random.default_rng(17), B, TRAIN_VOCAB, T)
    backward = {"flash_attention_bwd_dq": fa.flash_attention_bwd_dq_plain,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv_plain}
    calls = []

    def recorded(fn):
        def call(*args):
            out = fn(*args)
            calls.append((fn.__name__, args, out))
            return out
        return call
    swaps = {"kernels": {n: recorded(vars(fa)[n])
                         for n in (*backward, "flash_attention_fwd")},
             "plain_backward": backward,
             "plain": {**backward,
                       "flash_attention_fwd": fa.flash_attention_fwd_plain},
             "no_delta": {**backward,
                          "flash_attention_bwd_dkv": dkv_without_delta},
             "unrounded_p": {**backward,
                             "flash_attention_bwd_dkv": dkv_unrounded_p}}
    runs = {}
    for label, swap in swaps.items():
        old = {k: vars(fa)[k] for k in swap}
        zero_counts()
        vars(fa).update(swap)
        try:
            loss, grads = loss_grads(net, x, y)
        finally:
            vars(fa).update(old)
        runs[label] = (loss, grads, read_counts())
    # the kernels' outputs on the training path's own tensors (the
    # forwards, then layer 1's backward first), against the plain
    # versions on the same arguments by phase 3b's measures; the
    # unrounded-p faults on the same arguments
    on_path, fault_on_path, fwd_path, fwd_fault = [], [], [], []
    with torch.no_grad():
        for name, args, out in calls:
            if name == "flash_attention_fwd":
                fwd_path.append(fwd_on_path(args, out))
                fwd_fault.append(fwd_on_path(args, fwd_unrounded_p(*args)))
                continue
            plain = vars(fa)[name + "_plain"](*args)
            if name.endswith("dq"):
                pairs = [("dq", out, plain)]
            else:
                pairs = [("dk", out[0], plain[0]), ("dv", out[1], plain[1])]
                fault_on_path.append(fa.agreement(
                    dkv_unrounded_p(*args)[1], plain[1])[1])
            for n, got, want in pairs:
                row_rel, tile_rel = fa.agreement(got, want)
                on_path.append({"output": n, "row_rel": row_rel,
                                "tile_rel": tile_rel})
    del calls
    kernels = runs["kernels"][1]
    rel = {label: grad_rel(runs[label][1], runs["plain_backward"][1])
           for label in ("kernels", "no_delta", "unrounded_p")}
    rel["kernels_against_all_plain"] = grad_rel(kernels, runs["plain"][1])
    worst = {label: max(r.values()) for label, r in rel.items()}
    counts = {label: {n: runs[label][2][n] for n in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
              for label in runs}
    rec = {"dtype": "bfloat16", "layers": 2, "width": WIDTH, "T": T,
           "batch": B, "route": fa.kernel_route(torch.bfloat16,
                                                WIDTH // HEADS),
           "losses": {label: r[0] for label, r in runs.items()},
           "limit": TRAIN_BF16_GRAD_REL,
           "limit_against_all_plain": TRAIN_BF16_GRAD_REL_ALL,
           "worst_leaf_rel": worst,
           "forward_on_path": [r for r, _ in fwd_path],
           "forward_unrounded_p_on_path": [r for r, _ in fwd_fault],
           "kernels_on_path": on_path,
           "unrounded_p_dv_on_path_tile_rel": fault_on_path,
           **{f"{label}_leaf_rel": r for label, r in rel.items()},
           "launches": counts}
    log("train reference bf16:", json.dumps(rec))
    failures = [f"{a['output']} on the path" for a in on_path
                if a["row_rel"] > FLASH_ROW[torch.bfloat16]
                or a["tile_rel"] > FLASH_TILE[torch.bfloat16, "grad"]]
    failures += [f"forward on the path: {f}" for _, fs in fwd_path
                 for f in fs]
    if len(on_path) != 6 or len(fwd_path) != 2:
        failures.append("kernel calls recorded")
    if not all(fs for _, fs in fwd_fault):
        failures.append("the forward's limits pass p unrounded before P.V")
    if not min(fault_on_path) > FLASH_TILE[torch.bfloat16, "grad"]:
        failures.append("the tile limit passes dv from the unrounded p")
    if worst["kernels"] > TRAIN_BF16_GRAD_REL:
        failures.append("kernels against the plain backward")
    if worst["kernels_against_all_plain"] > TRAIN_BF16_GRAD_REL_ALL:
        failures.append("kernels against all plain versions")
    if not worst["no_delta"] > TRAIN_BF16_GRAD_REL:
        failures.append("the limit passes the dropped delta term")
    fwd_only = {"flash_fwd": 2, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want = {"kernels": {n: 2 for n in fwd_only}, "plain_backward": fwd_only,
            "plain": {n: 0 for n in fwd_only}, "no_delta": fwd_only,
            "unrounded_p": fwd_only}
    if counts != want:
        failures.append("launches")
    if not all(np.isfinite(r[0]) for r in runs.values()):
        failures.append("loss not finite")
    if failures:
        raise AssertionError(f"train reference bf16: {failures}: {rec}")
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
    # NaN and +-inf planted in y (one inf in the sc = 0 channel): NaN
    # where the plain version gives NaN, every other element bit-equal
    "stem_pool_nonfinite": ("stem_pool", dict(h=112, w=112, k=64,
                                              nonfinite=True)),
}


#: the ragged cases (B = 3): C and K no multiple of 8, M no multiple of
#: a pixel block, 3x3 patches that cross images, a stride-2 1x1
CNN_RAGGED = {
    "ragged_1x1": ("conv1x1", dict(h=9, w=13, c=20, k=36, stride=1,
                                   act="relu")),
    "ragged_1x1_s2": ("conv1x1", dict(h=10, w=14, c=20, k=36, stride=2,
                                      act="identity")),
    "ragged_3x3": ("conv3x3", dict(h=9, w=13, c=20, k=36, act="relu")),
    # the stem at an odd image (the last patches and the s2d halo's last
    # rows cut by the image) and a small one at K = 36 (masked columns,
    # element stores), at C = 1 and 4 (the tensor-core route's narrowest
    # and widest input)
    "ragged_stem_223x225_c1": ("stem_conv", dict(h=223, w=225, c=1, k=64)),
    "ragged_stem_223x225_c4": ("stem_conv", dict(h=223, w=225, c=4, k=64)),
    "ragged_stem_15x17_c1": ("stem_conv", dict(h=15, w=17, c=1, k=36)),
    "ragged_stem_15x17_c4": ("stem_conv", dict(h=15, w=17, c=4, k=36)),
    # the pool at an odd y (the last windows cut by the image) and a small
    # one, at K = 36: bf16 the element route, f32 the 16-byte route with a
    # short last chunk; K = 34 takes f32 onto the element route too
    "ragged_pool_111x113": ("stem_pool", dict(h=111, w=113, k=36)),
    "ragged_pool_8x9": ("stem_pool", dict(h=8, w=9, k=36)),
    "ragged_pool_9x13_k34": ("stem_pool", dict(h=9, w=13, k=34)),
}
CNN_RAGGED_B = 3
#: the stem conv's planted faults (bf16): "shifted_tap", tap (1, 1)'s
#: window read one s2d pixel to the right; "unrounded_sums", the sums taken
#: over the f32 accumulator, not the stored y. The first fails the output
#: limits at any shape. The second moves a channel's Σy by the rounding's
#: random walk, about 2^-9 / sqrt(3 n) of Σ|y| for n pixels a channel, so
#: CONV_SUMS (1e-5) tells it only where n is small: it is held up to
#: STEM_SUMS_TOLD pixels a channel (the 15 x 17 cases, n = 216) and
#: recorded beyond (n = 1.6 M at B = 128: ~1e-6, untellable)
STEM_CONV_FAULTS = ("shifted_tap", "unrounded_sums")
STEM_SUMS_TOLD = 5000
#: NaN, +inf and -inf planted in the nonfinite pool case's y (a third
#: each)
POOL_NONFINITE = 96
#: the forward pool's planted faults: "max_only", the window's raw
#: maximum alone (as if sc were never negative); "nan_dropped", fmaxf and
#: fminf, which return the other operand where one is NaN. The exact
#: comparison must fail the first in every case (each has channels with
#: sc < 0) and the second in the nonfinite case
STEM_POOL_FAULTS = ("max_only", "nan_dropped")


def cnn_inputs(kernel, geo, n, dtype, device, seed, gen="cpu"):
    """Seeded inputs at a case's shape: x (NHWC), and the prologue's
    (sc, bb) and the weight where the kernel takes them. A relu
    prologue normalizes a raw conv output (per-channel mean and scale
    drawn) and zeroes about half of it; an identity prologue reads a
    post-relu block input; weights are He-normal. Drawn on ``gen``
    (the card's generator for the sweep's large shapes)."""
    g = torch.Generator(device=gen).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=gen)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=gen)

    h, w = geo["h"], geo["w"]
    if kernel == "stem_pool":
        # sc of both signs, one channel 0 (the BN scale gamma / sigma
        # takes gamma's sign)
        k = geo["k"]
        y = randn(n, h, w, k)
        sc = 0.5 + rand(k)
        sc[1::3] *= -1.0
        sc[2 % k] = 0.0
        bb = 0.3 * randn(k)
        if geo.get("nonfinite"):
            flat = y.view(-1)
            idx = torch.randint(0, flat.numel(), (POOL_NONFINITE,),
                                generator=g, device=gen)
            third = POOL_NONFINITE // 3
            flat[idx[:third]] = float("nan")
            flat[idx[third:2 * third]] = float("inf")
            flat[idx[2 * third:]] = -float("inf")
            y[0, 1, 1, 2 % k] = float("inf")
        return {"y": y.to(device, dtype), "sc": sc.to(device),
                "bb": bb.to(device)}
    c, k = geo["c"], geo["k"]
    if kernel == "stem_conv":
        w7 = randn(k, c, 7, 7) * (2.0 / (49 * c)) ** 0.5
        return {"x": randn(n, h, w, c).to(device, dtype),
                "w7": w7.to(device, dtype)}
    taps = 9 if kernel == "conv3x3" else 1
    if geo["act"] == "relu":
        mean, std = 0.3 * randn(c), 0.5 + rand(c)
        x = mean + std * randn(n, h, w, c)
        sc = (0.5 + rand(c)) / std
        bb = 0.2 * randn(c) - mean * sc
    else:
        x = torch.clamp_min(randn(n, h, w, c), 0.0)
        sc, bb = torch.ones(c, device=gen), torch.zeros(c, device=gen)
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


def cnn_compare(got, ref, dtype):
    """A conv kernel's (o, Σo, Σo²) against the plain version's: (the
    agreement's record, the failures)."""
    (o, s1, s2), (ro, rs1, rs2) = got, ref
    failures = []
    if not all(bool(torch.isfinite(t).all()) for t in (o, s1, s2)):
        failures.append("not finite")
    row_rel, tile_rel = conv_agreement(o, ro)
    # the epilogue's sums against torch's sums of the kernel's own
    # stored output (the plain version's output differs by the flips,
    # and so do its sums)
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import _stats
    ts1, ts2 = _stats(o)
    absum = o.float().reshape(-1, o.shape[-1]).abs().sum(0)
    sums_rel = max(float(((s1 - ts1).abs() / absum.clamp_min(1e-30)).max()),
                   float(((s2 - ts2).abs() / ts2.abs().clamp_min(1e-30))
                         .max()))
    rec = {"sums_rel_vs_plain": float(
               ((s1 - rs1).abs() / absum.clamp_min(1e-30)).max()),
           "max_abs_err": float((o.float() - ro.float()).abs().max()),
           "row_rel": row_rel, "tile_rel": tile_rel, "sums_rel": sums_rel,
           "limits": {"row_rel": CONV_ROW[dtype],
                      "tile_rel": CONV_TILE[dtype], "sums_rel": CONV_SUMS}}
    if row_rel > CONV_ROW[dtype] or tile_rel > CONV_TILE[dtype]:
        failures.append("output")
    if sums_rel > CONV_SUMS:
        failures.append("sums")
    return rec, failures


def stem_conv_fault(x, ws, fault):
    """The plain stem conv (the s2d im2col in f32, one f32 matmul) with a
    planted fault (STEM_CONV_FAULTS): (y, Σ, Σ²)."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import _stats
    n, h, wd, _ = x.shape
    g = stem.stem_geometry(h, wd)
    ho, wo = g["ho"], g["wo"]
    sd = stem._s2d_image(x.float(), g)
    cols = []
    for i in range(4):
        for j in range(4):
            j0 = j + (fault == "shifted_tap" and (i, j) == (1, 1))
            cols.append(sd[:, i:i + ho, j0:j0 + wo, :].reshape(-1, sd.shape[3]))
    acc = torch.cat(cols, dim=1).to(ws.dtype).float() @ ws.float()
    y = acc.to(x.dtype).reshape(n, ho, wo, ws.shape[1])
    if fault == "unrounded_sums":
        return y, acc.sum(0), (acc * acc).sum(0)
    return (y, *_stats(y))


def stem_conv_launches():
    """The stem conv's device kernels started so far (the CUDA-core GEMM,
    the tensor-core pass), as its launchers count them."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import stem
    out = (ctypes.c_int * 2)()
    stem._LIBRARY.load().dl4j_stem_conv_kernel_launches(out)
    return list(out)


def stem_conv_record(a, geo, n, dtype, kern, got, device):
    """The stem conv case's route: the route stem_conv_route picks, the
    device kernel one call starts (which must be that route's), its plan
    (the tensor cores), and in bf16 the planted faults against the
    kernel's output (the failures the limits must show, where held).
    Returns (the record, the failures)."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    from deeplearning4j_tpu_torch.nn.layers.bottleneck import _sm_count
    rec, failures = {"route": stem.stem_conv_route(dtype, geo["c"])}, []
    before = stem_conv_launches()
    kern()
    torch.cuda.synchronize()
    ran = [x - y for x, y in zip(stem_conv_launches(), before)]
    rec["device_kernels"] = {"conv_gemm_kernel": ran[0],
                             "conv_tc_kernel": ran[1]}
    if ran != ([0, 1] if rec["route"] == "tensor_cores" else [1, 0]):
        failures.append(f"route {rec['route']} launched {ran}")
    if rec["route"] == "tensor_cores":
        rec["plan"] = stem._stem_conv_plan(
            n, geo["h"], geo["w"], geo["k"], _sm_count(device))._asdict()
    if dtype == torch.bfloat16:
        ws = stem.stem_weight_s2d(a["w7"])
        ho, wo = (geo["h"] - 1) // 2 + 1, (geo["w"] - 1) // 2 + 1
        rec["planted"] = {}
        for fault in STEM_CONV_FAULTS:
            frec, ffail = cnn_compare(stem_conv_fault(a["x"], ws, fault),
                                      got, dtype)
            held = fault == "shifted_tap" or n * ho * wo <= STEM_SUMS_TOLD
            rec["planted"][fault] = {
                **{k: frec[k] for k in ("row_rel", "tile_rel", "sums_rel")},
                "failures": ffail, "held": held}
            if held and not ffail:
                failures.append(f"the limits do not tell {fault}")
    return rec, failures


def same_bits(a, b):
    """``a`` and ``b`` equal bit for bit (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        it = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(it), b.view(it)
    return torch.equal(a, b)


def pool_exact(got, ref):
    """The forward pool's exact comparison: NaN at the same elements,
    every other element bit-equal. Returns (the record, the failures)."""
    gn, rn = torch.isnan(got.float()), torch.isnan(ref.float())
    it = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    differ = (got.view(it) != ref.view(it)) & ~rn
    err = torch.where(gn | rn | (got == ref), 0.0,
                      (got.float() - ref.float()).abs())
    rec = {"nan_kernel": int(gn.sum()), "nan_plain": int(rn.sum()),
           "nan_positions_equal": bool(torch.equal(gn, rn)),
           "bits_differ": int(differ.sum()),
           "max_abs_err": float(err.max()) if err.numel() else 0.0,
           "limits": {"bits_differ": 0, "nan_positions_equal": True}}
    failures = []
    if not rec["nan_positions_equal"]:
        failures.append("NaN positions")
    if rec["bits_differ"]:
        failures.append("bits")
    return rec, failures


def stem_fwd_pool_fault(y, sc, bb, fault):
    """The forward pool's arithmetic in torch, without its walk (the raw
    window's maximum and minimum over padding that neither takes, then
    relu(max(z(hi), z(lo))), z(v) = v sc + bb in f32), with a planted
    fault (STEM_POOL_FAULTS)."""
    _, ho, wo, _ = y.shape
    po, pw = (ho - 1) // 2 + 1, (wo - 1) // 2 + 1
    big, small = (torch.fmax, torch.fmin) if fault == "nan_dropped" else \
        (torch.maximum, torch.minimum)
    ext = []
    for pad, red in ((-float("inf"), big), (float("inf"), small)):
        zp = torch.nn.functional.pad(y.float(), (0, 0, 1, 1, 1, 1),
                                     value=pad)
        m = None
        for i in range(3):
            for j in range(3):
                w = zp[:, i:i + 2 * po - 1:2, j:j + 2 * pw - 1:2]
                m = w if m is None else red(m, w)
        ext.append(m)
    z1, z2 = ext[0] * sc + bb, ext[1] * sc + bb
    z = z1 if fault == "max_only" else big(z1, z2)
    return big(z, torch.zeros((), device=y.device)).to(y.dtype)


def stem_pool_launches():
    """The forward pool's device kernels started so far (the 16-byte
    route, the element route), as its launcher counts them."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    out = (ctypes.c_int * 2)()
    stem._LIBRARY.load().dl4j_stem_pool_kernel_launches(out)
    return list(out)


def stem_pool_record(a, geo, n, dtype, kern, got):
    """The forward pool case's route: the plan stem.py mirrors against
    the C launcher's, the device kernel one call starts (which must be
    the plan's route), and the planted faults against the kernel's
    output (STEM_POOL_FAULTS: each must fail the exact comparison where
    it can show). Returns (the record, the failures)."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    y, sc, bb = a["y"], a["sc"], a["bb"]
    h, w, k = geo["h"], geo["w"], geo["k"]
    plan = stem._stem_fwd_pool_plan(n, h, w, k, y.element_size(),
                                    y.data_ptr() % 16 == 0 and
                                    got.data_ptr() % 16 == 0)
    c_out = (ctypes.c_int * 5)()
    err = stem._LIBRARY.load().dl4j_stem_pool_plan(n, h, w, k, plan.vec,
                                                   c_out)
    rec = {"route": plan.route, "plan": plan._asdict(),
           "c_plan": list(c_out)}
    failures = []
    if err or rec["c_plan"] != [*plan.grid, plan.strips, plan.quads,
                                plan.rows]:
        failures.append(f"the C plan {rec['c_plan']} (error {err}) is not "
                        f"stem.py's {plan}")
    before = stem_pool_launches()
    kern()
    torch.cuda.synchronize()
    ran = [x - y_ for x, y_ in zip(stem_pool_launches(), before)]
    rec["device_kernels"] = {"vector": ran[0], "element": ran[1]}
    if ran != ([1, 0] if plan.route == "vector" else [0, 1]):
        failures.append(f"route {plan.route} launched {ran}")
    rec["planted"] = {}
    for fault in STEM_POOL_FAULTS:
        frec, ffail = pool_exact(stem_fwd_pool_fault(y, sc, bb, fault), got)
        held = fault == "max_only" or bool(geo.get("nonfinite"))
        rec["planted"][fault] = {
            **{x: frec[x] for x in ("nan_kernel", "nan_positions_equal",
                                    "bits_differ")},
            "failures": ffail, "held": held}
        if held and not ffail:
            failures.append(f"the exact comparison does not tell {fault}")
    return rec, failures


#: the kernel libraries of another checkout (``--parent``), built once
_PARENT_LIBS = {}
#: the parent tree's stem library: its bf16 conv and its two pools
_POOL_C_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
PARENT_STEM_FUNCTIONS = {
    "dl4j_stem_conv_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 +
                           [ctypes.c_void_p],
    "dl4j_conv_row_tile": [],
    "dl4j_stem_pool_bf16": _POOL_C_ARGS, "dl4j_stem_pool_f32": _POOL_C_ARGS}


def parent_source_library(name, src, functions):
    """A CudaLibrary ``name`` of the parent checkout's source ``src`` (a
    Path) with ``functions`` {symbol: argtypes}. Every header beside the
    source enters the library's digest, so a build left from another
    parent tree is not taken for this one's."""
    from deeplearning4j_tpu_torch.cuda_library import CudaLibrary
    return CudaLibrary(name, [str(src)], functions,
                       headers=[str(h) for h in
                                sorted(src.parent.glob("*.cuh"))])


def parent_library(parent, name, source, functions):
    """The kernel library ``name`` of the checkout ``parent`` (the parent
    commit's tree), built from its own source (``source``, under its
    package; the headers it includes are its own) beside this one's,
    with ``functions`` {symbol: argtypes}; loaded."""
    if name not in _PARENT_LIBS:
        from pathlib import Path
        src = Path(parent).resolve() / "deeplearning4j_tpu_torch" / source
        _PARENT_LIBS[name] = parent_source_library(f"{name}_parent", src,
                                                   functions)
    return _PARENT_LIBS[name].load()


#: this tree's kernel libraries built from another checkout's sources
#: (``--parent``): by library name, the source under the package
PARENT_SWAP_SOURCES = {
    "bottleneck": "nn/layers/csrc/bottleneck.cu",
    "bottleneck_bwd": "nn/layers/csrc/bottleneck_bwd.cu",
    "fused": "nn/layers/csrc/fused.cu",
    "stem_bwd": "nn/layers/csrc/stem_bwd.cu"}


def parent_swap_library(parent, library):
    """``library`` (a CudaLibrary of this tree) built from the parent
    checkout's source of the same name, with this tree's C interface
    (the parent's kernels changed in their device code only)."""
    from pathlib import Path
    name = f"{library.name}_parent"
    if name not in _PARENT_LIBS:
        src = Path(parent).resolve() / "deeplearning4j_tpu_torch" / \
            PARENT_SWAP_SOURCES[library.name]
        _PARENT_LIBS[name] = parent_source_library(name, src,
                                                   library.functions)
    return _PARENT_LIBS[name]


def build_parent_libraries(parent):
    """Every parent library the phases may swap in, one nvcc each, all
    started together (the first use would otherwise build each in
    turn)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import fused, stem
    libs = [parent_swap_library(parent, lib) for lib in (
        bn._LIBRARY, bn._BWD_LIBRARY, fused._LIBRARY, stem._BWD_LIBRARY)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs]:
            f.result()
    return time.perf_counter() - t0


class parent_kernels:
    """A context in which ``kernels`` (CudaKernels of one library of this
    tree) launch the parent checkout's build of that library through this
    tree's wrappers, so the parent's kernel runs on exactly the
    arguments this tree's would; the kernels' launch counts are left as
    they were."""

    def __init__(self, parent, kernels):
        self.kernels = kernels
        self.lib = parent_swap_library(parent, kernels[0].library)

    def __enter__(self):
        self.saved = [(k.library, k.launches) for k in self.kernels]
        for k in self.kernels:
            k.library = self.lib
        return self.lib

    def __exit__(self, *exc):
        for k, (lib, launches) in zip(self.kernels, self.saved):
            k.library, k.launches = lib, launches
        return False


def parent_swap_turns(parent, kernels, kern, device):
    """The parent checkout's kernel (through this tree's wrapper, see
    :class:`parent_kernels`) and this tree's, timed in turns on the same
    call ``kern``."""
    def old():
        with parent_kernels(parent, kernels):
            return kern()
    old()
    torch.cuda.synchronize()
    rec = in_turns(old, kern, device)
    rec["kernel_over_parent"] = (sum(rec["kernel_ms_turns"])
                                 / sum(rec["parent_ms"]))
    return rec


def in_turns(old, kern, device, iters=30):
    """The parent checkout's call (``old``) and this one's (``kern``)
    timed in turns (parent, kernel, kernel, parent)."""
    turns = [median_ms(old, device, iters), median_ms(kern, device, iters),
             median_ms(kern, device, iters), median_ms(old, device, iters)]
    return {"parent_ms": [turns[0], turns[3]],
            "kernel_ms_turns": turns[1:3]}


def parent_stem_turns(parent, a, ref_y, kern, device):
    """The parent checkout's bf16 stem conv (the CUDA-core implicit GEMM
    of conv_gemm.cuh) on the same inputs: its output against the plain
    version's, and its time in turns with this one's."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    lib = parent_library(parent, "stem", "nn/layers/csrc/stem.cu",
                         PARENT_STEM_FUNCTIONS)
    x, ws = a["x"], stem.stem_weight_s2d(a["w7"])
    n, h, wd, c = x.shape
    k = ws.shape[1]
    g = stem.stem_geometry(h, wd)
    y = torch.empty((n, g["ho"], g["wo"], k), dtype=x.dtype, device=device)
    tiles = -(-(n * g["ho"] * g["wo"]) // lib.dl4j_conv_row_tile())
    part = torch.empty((2, k, tiles), dtype=torch.float32, device=device)
    sums = torch.zeros((2, k), dtype=torch.float32, device=device)

    def old():
        err = lib.dl4j_stem_conv_bf16(
            x.data_ptr(), ws.data_ptr(), y.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(), n,
            h, wd, c, k, tiles, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's stem conv: CUDA error {err}")

    old()
    torch.cuda.synchronize()
    return {**in_turns(old, kern, device),
            "parent_max_abs_err": float((y.float() - ref_y.float()).abs()
                                        .max())}


def parent_pool_turns(parent, a, ref, kern, device, nonfinite):
    """The parent checkout's forward pool on the same inputs, against the
    plain version's output exactly; in the nonfinite case its NaN count
    beside the plain version's (the fault a NaN-dropping pool shows),
    else its time in turns with this one's."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    lib = parent_library(parent, "stem", "nn/layers/csrc/stem.cu",
                         PARENT_STEM_FUNCTIONS)
    y, sc, bb = a["y"], a["sc"], a["bb"]
    n, ho, wo, k = y.shape
    out = torch.empty_like(ref)
    fn = getattr(lib, "dl4j_stem_pool_bf16" if y.dtype == torch.bfloat16
                 else "dl4j_stem_pool_f32")

    def old():
        err = fn(y.data_ptr(), sc.data_ptr(), bb.data_ptr(), out.data_ptr(),
                 n, ho, wo, k, stem._stream(y))
        if err:
            raise RuntimeError(f"the parent's stem pool: CUDA error {err}")

    old()
    torch.cuda.synchronize()
    exact, fails = pool_exact(out, ref)
    rec = {"parent_exact": {**exact, "failures": fails}}
    if nonfinite:
        rec["fault_observed"] = {"parent_nan": exact["nan_kernel"],
                                 "plain_nan": exact["nan_plain"]}
    else:
        rec.update(in_turns(old, kern, device))
    return rec


#: the main path's cases whose kernels are timed in turns with the
#: parent checkout's (``--parent``): rows 1 and 2 (the s2 conv_c and 3x3),
#: 3 and 4 (their backward stages), 9 (the stem pool backward); rows 5
#: and 6 at every stage of the fused phase
PARENT_TURN_CASES = ("s2_conv_c", "s2_conv_b", "s2_c_bwd", "s2_b_bwd",
                     "stem_bwd_pool")


def cnn_case(name, dtype, n, device, seed, cases=None, parent=None):
    """One case: the kernel against its plain version on the same
    inputs, in bf16 two launches bitwise equal, and the kernel's, plain
    version's and library call's times beside the bound; for the stem
    conv its route and planted faults (stem_conv_record) and, with a
    parent checkout, the parent's kernel in turns at the main shape."""
    kernel, geo = (cases or CNN_CASES)[name]
    a = cnn_inputs(kernel, geo, n, dtype, device, seed)
    kern, plain, library, unrounded = cnn_fns(kernel, geo, a)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    case = {"case": name, "kernel": kernel, "dtype": str(dtype).split(".")[-1],
            "batch": n, **geo}
    failures = []
    if dtype == torch.bfloat16 or kernel == "stem_pool":
        again = kern()
        case["bitwise_repeat"] = all(
            same_bits(x, y) for x, y in zip(
                *(r if isinstance(r, tuple) else (r,) for r in (got, again))))
        if not case["bitwise_repeat"]:
            failures.append("two launches differ")
        del again
    if kernel == "stem_pool":
        rec, fails = pool_exact(got, ref)
        case.update(rec)
        failures += fails
        # planted NaN and inf make non-finite outputs, held by the exact
        # comparison
        finite = bool(geo.get("nonfinite")) or bool(torch.isfinite(got).all())
        prec, pfails = stem_pool_record(a, geo, n, dtype, kern, got)
        case.update(prec)
        failures += pfails
    else:
        rec, fails = cnn_compare(got, ref, dtype)
        case.update(rec)
        failures += fails
        finite = "not finite" not in fails
        ro = ref[0]
        if kernel == "stem_conv":
            srec, sfails = stem_conv_record(a, geo, n, dtype, kern, got,
                                            device)
            case.update(srec)
            failures += sfails
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
    del got
    bound_ms, bound_by = cnn_bound(kernel, geo, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    if parent and kernel == "stem_conv" and dtype == torch.bfloat16 and \
            cases is None:
        case["parent"] = parent_stem_turns(parent, a, ref[0], kern, device)
    if parent and name in PARENT_TURN_CASES and cases is None:
        from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
        case["parent"] = parent_swap_turns(
            parent, [bn.CONV1X1, bn.CONV3X3], kern, device)
    if parent and kernel == "stem_pool" and cases is None:
        case["parent"] = parent_pool_turns(parent, a, ref, kern, device,
                                           bool(geo.get("nonfinite")))
    del ref
    log("cnn", json.dumps(case))
    del a, kern, plain, library, unrounded
    torch.cuda.empty_cache()
    return case


def check_tile_guard(device):
    """Each conv launcher refuses partial sums one pixel block short of
    its grid (a CUDA error, no launch) instead of writing past them: the
    bf16 and f32 1x1, and the bf16 3x3 at 56x56, whose patches (28) are
    more than its 128-pixel row tiles (25)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    one = torch.ones(64, device=device)
    for kernel, taps, dtype, (n, hw) in (
            (bn.CONV1X1, 1, torch.bfloat16, (2, 16)),
            (bn.CONV1X1, 1, torch.float32, (2, 16)),
            (bn.CONV3X3, 9, torch.bfloat16, (1, 56))):
        x = torch.zeros((n, hw, hw, 64), dtype=dtype, device=device)
        w = torch.zeros((64, 64) if taps == 1 else (9, 64, 64), dtype=dtype,
                        device=device)
        out, part, tiles, sums = bn._conv_outputs(x, n, hw, hw, 64, 1, taps)
        if taps == 9:
            assert tiles > -(-(n * hw * hw) // 128), tiles
        before = kernel.launches
        try:
            kernel.launch(x.dtype, x.data_ptr(), one.data_ptr(),
                          one.data_ptr(), w.data_ptr(), out.data_ptr(),
                          part[0].data_ptr(), part[1].data_ptr(),
                          sums[0].data_ptr(), sums[1].data_ptr(), n, hw, hw,
                          64, 64, *((1,) if taps == 1 else ()), 0, tiles - 1,
                          bn._stream(x))
        except RuntimeError as e:
            assert kernel.launches == before, "a refused launch counted"
            log(f"cnn tile guard: {kernel.name} {dtype} {tiles - 1} of "
                f"{tiles} tiles refused ({e})")
            continue
        raise AssertionError(f"{kernel.name} {dtype} took partial sums one "
                             f"tile short")


def sass_hmma(library):
    """{function: its HMMA.16816.F32.BF16 count} in ``library``'s SASS
    (``cuobjdump -sass``), and the tool's path."""
    from pathlib import Path

    from deeplearning4j_tpu_torch.cuda_library import nvcc_path
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library.path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA.16816.F32.BF16" in line:
            counts[fn] += 1
    return counts, str(tool)


def ptxas_usage(library, name):
    """{function: its ptxas -v line pair (spills; registers)} of the
    entry functions of ``library`` whose name holds ``name``."""
    usage, fn = {}, None
    for line in library.build_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if name in line else None
        elif fn is not None and ("spill" in line or "registers" in line):
            usage.setdefault(fn, []).append(line.strip())
    return usage


def ptxas_registers(lines):
    """The register count in a function's ptxas -v lines, or None."""
    for line in lines:
        m = re.search(r"Used (\d+) registers", line)
        if m:
            return int(m.group(1))
    return None


def spilling(ptxas):
    """The functions of a ptxas_usage record that spill."""
    return [f"{f} spills" for f, lines in ptxas.items()
            if any("spill" in x and " 0 bytes spill stores" not in x
                   for x in lines)]


def tc_key(fn):
    """A backward tensor-core function of conv_bwd_tc.cuh (or, in a
    parent tree, of bottleneck_bwd.cu) by its mangled name: (its name,
    its template ints), or None for any other function."""
    m = re.search(r"\d+(dz_tc_kernel|dw_tc_kernel)I((?:Li\d+E)+)E", fn)
    if not m:
        return None
    return m.group(1), tuple(int(x) for x in re.findall(r"Li(\d+)E",
                                                        m.group(2)))


#: the bf16 forward's tensor-core kernel (conv_fwd_tc.cuh, shared by the
#: bottleneck and the fused op) and the f32 forwards' CUDA-core ones, by
#: their mangled names
CONV_TC_KERNEL, CONV_CUDA_CORE_KERNEL = "13fwd_tc_kernel", "16conv_gemm_kernel"
FUSED_CUDA_CORE_KERNEL = "16fused_fwd_kernel"
#: HMMA.16816.F32.BF16 in each fully unrolled chunk of fwd_tc_kernel: 9
#: taps x one k16 step (the 3x3), 4 k16 steps (the 1x1), 16 products each
CONV_TC_HMMA = {9: 144, 1: 64}


def tc_sass(library, tc_name, cuda_core_name, want=None):
    """``library``'s SASS: the functions named ``tc_name`` (the tensor
    cores) hold HMMA.16816.F32.BF16 (``want(function)`` of them where
    given), those named ``cuda_core_name`` none. Returns (the record, the
    list of what disagrees)."""
    counts, tool = sass_hmma(library)
    tc = {f: c for f, c in counts.items() if tc_name in f}
    cuda_cores = {f: c for f, c in counts.items() if cuda_core_name in f}
    bad = [f for f, c in tc.items()
           if c == 0 or (want is not None and c != want(f))]
    bad += [f for f, c in cuda_cores.items() if c != 0]
    if not tc or not cuda_cores:
        bad.append("no tensor-core or no CUDA-core function found")
    rec = {"tool": str(tool), "hmma_16816_f32_bf16": {
               tc_name: tc, cuda_core_name: cuda_cores},
           "ptxas": ptxas_usage(library, tc_name.lstrip("0123456789"))}
    return rec, bad


def conv_sass():
    """The bottleneck library's SASS: each bf16 forward function (the
    tensor cores) holds 144 HMMA.16816.F32.BF16 (the 3x3) or 64 (the
    1x1), and the f32 ones (the CUDA cores) none; with each function's
    registers and spills as ptxas reported them."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    rec, bad = tc_sass(bn._LIBRARY, CONV_TC_KERNEL, CONV_CUDA_CORE_KERNEL,
                       lambda f: CONV_TC_HMMA[9 if "ILi9E" in f else 1])
    log("cnn sass:", json.dumps(rec))
    if bad:
        raise AssertionError(f"cnn sass: HMMA.16816.F32.BF16 counts off in "
                             f"{bad}: {rec['hmma_16816_f32_bf16']}")
    return rec


def resnet_fwd_convs():
    """Every distinct bottleneck forward conv of a ResNet50 forward at
    224x224: name: (kernel, geometry, launches a forward). Per stage
    (resolution, width, output width, blocks, stride): conv_a of the
    first block (the block input, strided from s3 on) and of the later
    ones, the 3x3 conv_b and conv_c in every block, the conv shortcut."""
    out, cin, hin = {}, 64, 56
    for name, hw, mid, cout, blocks, s in (("s2", 56, 64, 256, 3, 1),
                                           ("s3", 28, 128, 512, 4, 2),
                                           ("s4", 14, 256, 1024, 6, 2),
                                           ("s5", 7, 512, 2048, 3, 2)):
        out[f"{name}_a0"] = ("conv1x1", dict(h=hin, w=hin, c=cin, k=mid,
                                             stride=s, act="identity"), 1)
        out[f"{name}_a"] = ("conv1x1", dict(h=hw, w=hw, c=cout, k=mid,
                                            stride=1, act="identity"),
                            blocks - 1)
        out[f"{name}_b"] = ("conv3x3", dict(h=hw, w=hw, c=mid, k=mid,
                                            act="relu"), blocks)
        out[f"{name}_c"] = ("conv1x1", dict(h=hw, w=hw, c=mid, k=cout,
                                            stride=1, act="relu"), blocks)
        out[f"{name}_sc"] = ("conv1x1", dict(h=hin, w=hin, c=cin, k=cout,
                                             stride=s, act="identity"), 1)
        cin, hin = cout, hw
    return out


def fwd_sweep(device, smi):
    """Every distinct forward conv of a ResNet50 forward at B=128, bf16:
    the kernel against its plain version once (the limits of the cases),
    its time and the library call's beside the bound, its shared memory,
    and the totals a forward weighted by each conv's launches."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    convs = resnet_fwd_convs()
    for name in ("conv1x1", "conv3x3"):
        per_fwd = sum(cv[2] for cv in convs.values() if cv[0] == name)
        assert per_fwd == RESNET_LAUNCHES[name], (name, per_fwd)
    rows, failed = [], []
    totals = {"conv1x1": [0.0, 0.0, 0.0], "conv3x3": [0.0, 0.0, 0.0]}
    dtype = torch.bfloat16
    lib = bn._LIBRARY.load()
    for i, (name, (kernel, geo, per_fwd)) in enumerate(convs.items()):
        a = cnn_inputs(kernel, geo, RESNET_B, dtype, device, seed=80 + i,
                       gen=device)
        kern, plain, library, _ = cnn_fns(kernel, geo, a)
        rec, failures = cnn_compare(kern(), plain(), dtype)
        bound_ms, bound_by = cnn_bound(kernel, geo, RESNET_B, dtype)
        taps = 9 if kernel == "conv3x3" else 1
        stride = geo.get("stride", 1)
        row = {"conv": name, "kernel": kernel, **geo,
               "launches_per_forward": per_fwd, **rec,
               "smem_bytes": lib.dl4j_conv_tc_smem(
                   RESNET_B, geo["h"], geo["w"], geo["k"], stride, taps),
               "plan": bn._fwd_tc_plan(RESNET_B, geo["h"], geo["w"],
                                       geo["k"], stride, taps,
                                       bn._sm_count(device))._asdict(),
               "ms": median_ms(kern, device),
               "library_ms": median_ms(library, device),
               "bound_ms": bound_ms, "bound_by": bound_by}
        for j, key in enumerate(("ms", "library_ms", "bound_ms")):
            totals[kernel][j] += per_fwd * row[key]
        log("cnn fwd sweep", json.dumps(row))
        if failures:
            failed.append((name, failures))
        rows.append(row)
        del a, kern, plain, library
        torch.cuda.empty_cache()
    fwd = {kernel: dict(zip(("kernel_ms", "library_ms", "bound_ms"), t))
           for kernel, t in totals.items()}
    fwd["all"] = {key: sum(fwd[k][key] for k in totals)
                  for key in ("kernel_ms", "library_ms", "bound_ms")}
    log("cnn fwd sweep per forward (launch-weighted, B=128, bf16):",
        json.dumps({**fwd, "card": smi}))
    if failed:
        raise AssertionError(f"forward sweep disagrees: {failed}")
    return {"convs": rows, "per_forward": fwd}


def stem_conv_sass():
    """The stem library's SASS: the bf16 tensor-core conv function holds
    HMMA.16816.F32.BF16 and the CUDA-core implicit GEMMs none; the
    tensor-core function's registers, spills (none may spill) and
    dynamic shared memory."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    rec, bad = tc_sass(stem._LIBRARY, "14conv_tc_kernel",
                       "16conv_gemm_kernel")
    rec["smem_bytes"] = stem._LIBRARY.load().dl4j_stem_conv_tc_smem()
    # the forward pool's functions (both routes, both dtypes): registers,
    # shared memory (none) and spills (none may spill)
    rec["fwd_pool_ptxas"] = ptxas_usage(stem._LIBRARY, "fwd_pool_kernel")
    if len(rec["fwd_pool_ptxas"]) != 4:
        bad.append(f"{len(rec['fwd_pool_ptxas'])} fwd_pool functions, not 4")
    bad += spilling(rec["ptxas"]) + spilling(rec["fwd_pool_ptxas"])
    log("stem conv sass:", json.dumps(rec))
    if bad:
        raise AssertionError(f"stem conv sass: HMMA.16816.F32.BF16 counts "
                             f"off or spills in {bad}: "
                             f"{rec['hmma_16816_f32_bf16']}")
    return rec


#: the sites of ROADMAP C4 (a relu or window maximum that dropped NaN)
#: held by the NaN bar, by the kernel through which each case reaches
#: them: the bottleneck forward's relu prologue (conv_mma.cuh z8 in
#: bf16, conv_gemm.cuh in f32), the fused forward's (z8 / conv_gemm.cuh),
#: the fused backward's recomputed z of its dW pass (z8 / fused.cu), the
#: bottleneck backward's recomputed prologue (z8 / bottleneck_bwd.cu) and
#: the stem pool backward's relu and window maxima (stem_bwd.cu: bf16
#: pairs, f32)
NAN_SITES = ("conv1x1", "conv3x3", "fused", "fused_bwd", "bwd1x1", "bwd3x3",
             "stem_bwd_pool")
#: the outputs the NaN bar holds as sums
NAN_SUM_NAMES = ("sum", "sum_sq", "sums", "dsc", "dbb", "db")
#: the NaN bar's limit on the finite sums (f32 sums in another order, of
#: the same stored values), relative to the tensor's largest |value|
NAN_SUMS_REL = 1e-4


def nan_negative(t, pos, sc, bb):
    """``t`` with the element at ``pos`` (NaN) replaced by a value whose
    prologue ``t sc + bb`` is negative: what a NaN-dropping relu makes
    of the NaN."""
    c = pos[-1]
    out = t.clone()
    out[pos] = (-abs(float(bb[c])) - 1.0) / float(sc[c])
    return out


def nan_case(site, dtype, device):
    """One NaN case of ``site``: (kernel call, plain call, the plain
    version on the NaN-dropped input, output names, the site's
    CudaKernels). One NaN is planted in the input the site's prologue or
    window maximum reads: x (the forward convs, 2 x 8 x 8 x 64), y2 (the
    fused forward and backward, 128 x 64 to 64), yprev (the backward
    stages, 2 x 8 x 8 x 64 to 64) or y (the stem pool backward, 2 x 8 x
    8 x 64, the NaN inside two windows' overlap)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import fused, stem
    g = torch.Generator().manual_seed(11 + NAN_SITES.index(site))
    c = k = 64
    if site in ("conv1x1", "conv3x3", "fused", "fused_bwd"):
        x = torch.randn((2, 8, 8, c), generator=g)
        pos = (1, 3, 4, 5)
        x[pos] = float("nan")
        sc = 0.5 + torch.rand(c, generator=g)
        bb = torch.randn(c, generator=g)
        taps = 9 if site == "conv3x3" else 1
        w = torch.randn((9, c, k) if taps == 9 else (c, k), generator=g) \
            / (taps * c) ** 0.5
        xd, dropped_x = x.to(device, dtype), nan_negative(x, pos, sc, bb) \
            .to(device, dtype)
        scd, bbd, wd = sc.to(device), bb.to(device), w.to(device, dtype)
        if site == "fused":
            b = (0.1 * torch.randn(k, generator=g)).to(device)
            y2, y2d = xd.reshape(-1, c), dropped_x.reshape(-1, c)
            return (lambda: (fused.fused_matmul(y2, scd, bbd, wd, b),),
                    lambda: (fused.fused_matmul_plain(y2, scd, bbd, wd, b),),
                    lambda: (fused.fused_matmul_plain(y2d, scd, bbd, wd,
                                                      b),),
                    ("out",), [fused.FUSED_FWD, fused.FUSED_BWD])
        if site == "fused_bwd":
            gd = torch.randn((x.numel() // c, k), generator=g) \
                .to(device, dtype)
            y2, y2d = xd.reshape(-1, c), dropped_x.reshape(-1, c)
            return (lambda: fused.fused_matmul_bwd(y2, scd, bbd, wd, gd),
                    lambda: fused.fused_matmul_bwd_plain(y2, scd, bbd, wd,
                                                         gd),
                    lambda: fused.fused_matmul_bwd_plain(y2d, scd, bbd, wd,
                                                         gd),
                    ("dy", "dsc", "dbb", "dw", "db"),
                    [fused.FUSED_FWD, fused.FUSED_BWD])
        fn, plain = (bn.conv3x3, bn.conv3x3_plain) if taps == 9 else \
            (bn.conv1x1, bn.conv1x1_plain)
        return (lambda: fn(xd, scd, bbd, wd, act="relu"),
                lambda: plain(xd, scd, bbd, wd, act="relu"),
                lambda: plain(dropped_x, scd, bbd, wd, act="relu"),
                ("out", "sum", "sum_sq"), [bn.CONV1X1, bn.CONV3X3])
    if site in ("bwd1x1", "bwd3x3"):
        geo = dict(h=8, w=8, c=c, k=k, stride=1, act="relu")
        a = bwd_inputs(site, geo, 2, dtype, device, seed=70)
        pos = (1, 3, 2, 7)
        yprev = a["yprev"].float().cpu()
        yprev[pos] = float("nan")
        a["yprev"] = yprev.to(device, dtype)
        scp, bbp = (a["aff_p"][i].cpu() for i in (0, 1))
        dropped = dict(a, yprev=nan_negative(yprev, pos, scp, bbp)
                       .to(device, dtype))
        fn, plain = (bn.conv3x3_bwd, bn.conv3x3_bwd_plain) \
            if site == "bwd3x3" else (bn.conv1x1_bwd, bn.conv1x1_bwd_plain)

        def call(f, args):
            return lambda: f(*(args[n] for n in ("yk", "g", "yprev", "w",
                                                  "aff_k", "aff_p")),
                             act_prev="relu")
        return (call(fn, a), call(plain, a), call(plain, dropped),
                ("dz0", "dW", "sums"), [bn.BWD1X1, bn.BWD3X3])
    a = stem_bwd_inputs(2, dtype, device, seed=71,
                        geo=dict(h=16, w=16, c=3, k=k))
    pos = (1, 3, 4, 9)
    y = a["y"].float().cpu()
    y[pos] = float("nan")
    yd = y.to(device, dtype)
    aff = a["aff_p"]
    yn = nan_negative(y, pos, aff[0].cpu(), aff[1].cpu()).to(device, dtype)
    return (lambda: stem.stem_bwd_pool(yd, a["g"], aff),
            lambda: stem.stem_bwd_pool_plain(yd, a["g"], aff),
            lambda: stem.stem_bwd_pool_plain(yn, a["g"], aff),
            ("dz0", "sums"),
            [stem.STEM_BWD_POOL, stem.STEM_BWD_DW, stem.STEM_BWD_DX])


def nan_check(got, ref, dtype, names):
    """The NaN bar: each output's NaN at exactly the plain version's
    elements; the finite elements within the phase's limits (an output
    or dW by rows and 64-row tiles as its cases, the sums within
    NAN_SUMS_REL of their largest |value|). (record, failures)."""
    rec, failures = {}, []
    for name, g, r in zip(names, got, ref):
        gn, rn = torch.isnan(g.float()), torch.isnan(r.float())
        same = bool(torch.equal(gn, rn))
        g0 = torch.where(rn, 0.0, g.float())
        r0 = torch.where(rn, 0.0, r.float())
        entry = {"nan_kernel": int(gn.sum()), "nan_plain": int(rn.sum()),
                 "nan_positions_equal": same}
        if name in NAN_SUM_NAMES:
            scale = max(float(r0.abs().max()), 1e-30)
            entry["finite_rel"] = float((g0 - r0).abs().max()) / scale
            ok = entry["finite_rel"] <= NAN_SUMS_REL
        else:
            width = g.shape[-1]
            rr, tr = conv_agreement(g0.reshape(-1, width),
                                    r0.reshape(-1, width))
            entry.update(row_rel=rr, tile_rel=tr)
            lim = (BWD_DW_ROW[dtype], BWD_DW_TILE[dtype]) if name == "dW" \
                else (CONV_ROW[dtype], CONV_TILE[dtype])
            ok = rr <= lim[0] and tr <= lim[1]
        rec[name] = entry
        if not same:
            failures.append(f"{name}: NaN at {entry['nan_kernel']} elements, "
                            f"the plain version's at {entry['nan_plain']}")
        if not ok:
            failures.append(f"{name}: finite values off")
    return rec, failures


def nan_bar(sites, device, parent=None):
    """The NaN bar at ``sites``, bf16 and f32: the kernel's outputs
    carry NaN at exactly the plain version's elements and agree with it
    elsewhere (:func:`nan_check`). The bar is shown failing on the plain
    version run on the input with the NaN dropped (what the old fmaxf
    relu computed) and, with ``parent``, on the parent checkout's
    kernel (the NaN-dropping one) through this tree's wrapper."""
    rows, failures = [], []
    for site in sites:
        for dtype in (torch.bfloat16, torch.float32):
            kern, plain, dropped, names, kernels = nan_case(site, dtype,
                                                            device)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            row = {"site": site, "dtype": str(dtype).split(".")[-1]}
            row["kernel"], fails = nan_check(got, ref, dtype, names)
            failures += [f"{site} {row['dtype']} {f}" for f in fails]
            row["bar_holds"] = not fails
            row["dropped"], dfails = nan_check(dropped(), ref, dtype, names)
            row["bar_fails_dropped"] = bool(dfails)
            if not dfails:
                failures.append(f"{site} {row['dtype']}: the bar does not "
                                "tell a NaN-dropping relu")
            if parent:
                with parent_kernels(parent, kernels):
                    pgot = kern()
                torch.cuda.synchronize()
                row["parent"], pfails = nan_check(pgot, ref, dtype, names)
                row["bar_fails_parent"] = bool(pfails)
                if not pfails:
                    failures.append(f"{site} {row['dtype']}: the parent's "
                                    "kernel passes the bar")
            rows.append(row)
            del got, ref
    log("nan bar:", json.dumps(rows))
    if failures:
        raise AssertionError(f"nan bar: {failures}")
    return rows


def check_cnn_kernels(device, smi, parent=None):
    """The SASS checks; every case in bf16 at the main path's batch (the
    stem conv and pool with the parent's kernels in turns, given one),
    then in f32 at 16; the ragged cases in both at B=3; the sweep of a
    forward's convs; the NaN bar of the bottleneck forward."""
    sass = conv_sass()
    stem_sass_rec = stem_conv_sass()
    check_tile_guard(device)
    cases = [cnn_case(name, dtype, n, device, seed=i, parent=parent)
             for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16))
             for i, name in enumerate(CNN_CASES)]
    cases += [cnn_case(name, dtype, CNN_RAGGED_B, device, seed=50 + i,
                       cases=CNN_RAGGED)
              for dtype in (torch.bfloat16, torch.float32)
              for i, name in enumerate(CNN_RAGGED)]
    return {"cases": cases, "sweep": fwd_sweep(device, smi),
            "sass": {**sass, "stem_conv": stem_sass_rec},
            "nan_bar": nan_bar(("conv1x1", "conv3x3"), device, parent)}


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
    of the inference forward under the selected plan; a sequential
    network's probabilities (``output()``)."""
    if not hasattr(net.conf, "network_outputs"):
        return net.output(x).float().cpu()
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
                or "fwd_tc_kernel" in k or "fwd_pool_kernel" in k
                or "reduce_partials" in k) / busy_us
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


def bwd_inputs(kernel, geo, n, dtype, device, seed, gen="cpu"):
    """Seeded inputs of a backward stage: y_k a raw conv output (a
    per-channel mean and scale drawn) with its BN rows aff_k (sc, bb,
    inv, mu of those statistics, m1, m2 drawn); g = dz0_k, a gradient
    masked by a relu (about half zero); yprev a raw conv output with its
    rows aff_p under a relu prologue, or a post-relu block input with
    (1, 0, 1, 0) under the identity; He-normal weights. Drawn on
    ``gen`` (the card's generator for the sweep's large shapes)."""
    g = torch.Generator(device=gen).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=gen)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=gen)

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
        one = torch.ones(c, device=gen)
        aff_p = torch.stack([one, 0 * one, one, 0 * one])
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


def bwd_compare(kernel, geo, a, got, ref, dtype):
    """The kernel's (dz0, dW, sums) against the plain version's on inputs
    ``a``: (the agreement's record, the failures)."""
    (dz, dw, sums), (rdz, rdw, rsums) = got, ref
    rec = {}
    failures = []
    finite = all(bool(torch.isfinite(t).all()) for t in (dz, dw, sums))
    if not finite:
        failures.append("not finite")
    row_rel, tile_rel = conv_agreement(dz, rdz)
    dw_row, dw_tile = conv_agreement(dw.reshape(-1, geo["k"]),
                                     rdw.reshape(-1, geo["k"]))
    rec.update(max_abs_err=float((dz.float() - rdz.float()).abs().max()),
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
        rec["sums_rel"] = bwd_sums_rel(sums, rdz, a["yprev"], a["aff_p"],
                                       rsums)
        if rec["sums_rel"] > BWD_SUMS:
            failures.append("sums")
    elif bool(sums.any()):
        failures.append("identity prologue's sums not zero")
    if geo["stride"] == 2:
        unread = dz.clone()
        unread[:, ::2, ::2, :] = 0
        rec["unread_nonzero"] = int(torch.count_nonzero(unread))
        if rec["unread_nonzero"]:
            failures.append("stride-2 rows the conv never read not zero")
    return rec, failures


def bwd_case(name, dtype, n, device, seed, cases=None, planted=True,
             parent=None):
    """One backward case: the kernel against its plain version (dz0, dW,
    sums), the zero rows of stride 2, in bf16 two launches bitwise equal
    and (``planted``) the planted faults, then the kernel's, plain
    version's and cuDNN's times beside the bound."""
    kernel, geo = (cases or BWD_CASES)[name]
    a = bwd_inputs(kernel, geo, n, dtype, device, seed)
    kern, plain, library, faults = bwd_fns(kernel, geo, a)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    case = {"case": name, "kernel": kernel,
            "dtype": str(dtype).split(".")[-1], "batch": n, **geo}
    rec, failures = bwd_compare(kernel, geo, a, got, ref, dtype)
    case.update(rec)
    (dz, dw, sums), (rdz, rdw, rsums) = got, ref
    if dtype == torch.bfloat16:
        again = kern()
        case["bitwise_repeat"] = all(torch.equal(x, y)
                                     for x, y in zip(got, again))
        if not case["bitwise_repeat"]:
            failures.append("two launches differ")
        del again
    if dtype == torch.bfloat16 and planted:
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
    if failures:
        raise AssertionError(f"{kernel} kernel disagrees with its plain "
                             f"version ({failures}): {case}")
    del dz, dw, sums, rdz, rdw, rsums, got, ref
    bound_ms, bound_by = bwd_bound(kernel, geo, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    if parent and name in PARENT_TURN_CASES and cases is None:
        from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
        case["parent"] = parent_swap_turns(
            parent, [bn.BWD1X1, bn.BWD3X3], kern, device)
    log("cnn bwd", json.dumps(case))
    del a, kern, plain, library, faults
    torch.cuda.empty_cache()
    return case


#: the ragged cases (B = 3, so M = 147): C and K no multiple of 8, M no
#: multiple of any row tile, a stride-2 1x1 and a 3x3 over 7x7 images
BWD_RAGGED = {
    "ragged_1x1_s2": ("bwd1x1", dict(h=14, w=14, c=20, k=36, stride=2,
                                     act="relu")),
    "ragged_3x3": ("bwd3x3", dict(h=7, w=7, c=20, k=36, stride=1,
                                  act="relu")),
}
BWD_RAGGED_B = 3


def resnet_bwd_stages():
    """Every distinct backward stage of a ResNet50 training step at
    224x224: name: (kernel, geometry, launches a step). Per stage
    (resolution, width, output width, blocks, stride): stage c and the
    3x3 in every block, stage a of the first block (the block input,
    strided from s3 on) and of the later ones, the conv shortcut."""
    out, cin, hin = {}, 64, 56
    for name, hw, mid, cout, blocks, s in (("s2", 56, 64, 256, 3, 1),
                                           ("s3", 28, 128, 512, 4, 2),
                                           ("s4", 14, 256, 1024, 6, 2),
                                           ("s5", 7, 512, 2048, 3, 2)):
        out[f"{name}_c"] = ("bwd1x1", dict(h=hw, w=hw, c=mid, k=cout,
                                           stride=1, act="relu"), blocks)
        out[f"{name}_b"] = ("bwd3x3", dict(h=hw, w=hw, c=mid, k=mid,
                                           stride=1, act="relu"), blocks)
        out[f"{name}_a0"] = ("bwd1x1", dict(h=hin, w=hin, c=cin, k=mid,
                                            stride=s, act="identity"), 1)
        out[f"{name}_a"] = ("bwd1x1", dict(h=hw, w=hw, c=cout, k=mid,
                                           stride=1, act="identity"),
                            blocks - 1)
        out[f"{name}_sc"] = ("bwd1x1", dict(h=hin, w=hin, c=cin, k=cout,
                                            stride=s, act="identity"), 1)
        cin, hin = cout, hw
    return out


def bwd_sweep(device, smi):
    """Every distinct backward stage of a step at B=128, bf16: the kernel
    against its plain version once (the limits of the cases), its time
    and cuDNN's beside the bound, and the totals a step weighted by each
    stage's launches."""
    stages = resnet_bwd_stages()
    for name in ("bwd1x1", "bwd3x3"):
        per_step = sum(st[2] for st in stages.values() if st[0] == name)
        assert per_step == RESNET_TRAIN_LAUNCHES[name], (name, per_step)
    rows, failed = [], []
    totals = {"bwd1x1": [0.0, 0.0, 0.0], "bwd3x3": [0.0, 0.0, 0.0]}
    dtype = torch.bfloat16
    for i, (name, (kernel, geo, per_step)) in enumerate(stages.items()):
        a = bwd_inputs(kernel, geo, RESNET_B, dtype, device, seed=60 + i,
                       gen=device)
        kern, plain, library, _ = bwd_fns(kernel, geo, a)
        rec, failures = bwd_compare(kernel, geo, a, kern(), plain(), dtype)
        bound_ms, bound_by = bwd_bound(kernel, geo, RESNET_B, dtype)
        row = {"stage": name, "kernel": kernel, **geo,
               "launches_per_step": per_step, **rec,
               "ms": median_ms(kern, device),
               "library_ms": median_ms(library, device),
               "bound_ms": bound_ms, "bound_by": bound_by}
        for j, key in enumerate(("ms", "library_ms", "bound_ms")):
            totals[kernel][j] += per_step * row[key]
        log("cnn bwd sweep", json.dumps(row))
        if failures:
            failed.append((name, failures))
        rows.append(row)
        del a, kern, plain, library
        torch.cuda.empty_cache()
    step = {kernel: dict(zip(("kernel_ms", "cudnn_ms", "bound_ms"), t))
            for kernel, t in totals.items()}
    step["all"] = {key: sum(step[k][key] for k in totals)
                   for key in ("kernel_ms", "cudnn_ms", "bound_ms")}
    log("cnn bwd sweep per step (launch-weighted, B=128, bf16):",
        json.dumps({**step, "card": smi}))
    if failed:
        raise AssertionError(f"backward sweep disagrees: {failed}")
    return {"stages": rows, "per_step": step}


#: the bottleneck backward's tensor-core stage functions whose registers
#: or spill stores differ from the parent tree's, as {function: {field:
#: (parent, this tree)}}: the HMMA counts must match the parent's and
#: the other fields must match it or this table
BWD_SASS_MOVED = {}


def bwd_sass(device, parent=None):
    """The bottleneck backward library's SASS: every bf16 tensor-core
    function (conv_bwd_tc.cuh's stage kernels, moved there from
    bottleneck_bwd.cu) holds HMMA.16816.F32.BF16, the f32 CUDA-core ones
    (dz_kernel, dw_kernel) none; with each function's registers and
    spills (the 3x3 dW pass's spill stores are known, PERF.md row 4).
    With a parent checkout, each tensor-core function's HMMA count
    equals the parent's same function's, its registers and spill stores
    too or as BWD_SASS_MOVED records, and the bf16 1x1 cases' (dz, dW,
    sums) at B=128 equal the parent kernel's bitwise (finite data: the
    NaN-propagating relu changes no finite value)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    lib = bn._BWD_LIBRARY
    counts, tool = sass_hmma(lib)
    ptx = {**ptxas_usage(lib, "dz_tc_kernel"),
           **ptxas_usage(lib, "dw_tc_kernel")}
    tc = {f: c for f, c in counts.items() if tc_key(f)}
    cuda_cores = {f: c for f, c in counts.items()
                  if ("dz_kernel" in f or "dw_kernel" in f)
                  and not tc_key(f)}
    bad = [f for f, c in tc.items() if c == 0]
    bad += [f for f, c in cuda_cores.items() if c != 0]
    if not tc or not cuda_cores:
        bad.append("no tensor-core or no CUDA-core function found")

    def spill_stores(lines):
        for line in lines:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                return int(m.group(1))
        return None

    def by_key(counts_, ptx_, stage_mode):
        out = {}
        for f, c in counts_.items():
            key = tc_key(f)
            if key is None:
                continue
            ints = key[1]
            if stage_mode:   # this tree: the trailing mode, 0 a stage
                if ints[-1] != 0:
                    continue
                ints = ints[:-1]
            out[f"{key[0]}<{', '.join(map(str, ints))}>"] = {
                "hmma": c, "registers": ptxas_registers(ptx_.get(f, [])),
                "spill_stores": spill_stores(ptx_.get(f, []))}
        return out

    rec = {"tool": tool, "hmma_16816_f32_bf16": {
               "tensor_cores": tc, "cuda_cores": cuda_cores},
           "ptxas": ptx, "stage_functions": by_key(counts, ptx, True)}
    if parent:
        plib = parent_swap_library(parent, lib)
        plib.load()
        pcounts, _ = sass_hmma(plib)
        pptx = {**ptxas_usage(plib, "dz_tc_kernel"),
                **ptxas_usage(plib, "dw_tc_kernel")}
        theirs_fns = rec["parent_stage_functions"] = by_key(pcounts, pptx,
                                                            True)
        mine_fns = rec["stage_functions"]
        moved = {}
        for f in sorted(set(theirs_fns) | set(mine_fns)):
            t, m = theirs_fns.get(f), mine_fns.get(f)
            if t is None or m is None or t["hmma"] != m["hmma"]:
                bad.append(f"{f}: HMMA counts or functions differ from the "
                           "parent's")
                continue
            d = {k: (t[k], m[k]) for k in ("registers", "spill_stores")
                 if t[k] != m[k]}
            if d:
                moved[f] = d
        rec["moved_from_parent"] = moved
        if not mine_fns or moved != {
                f: {k: tuple(v) for k, v in d.items()}
                for f, d in BWD_SASS_MOVED.items()}:
            bad.append(f"the stage functions' registers or spills moved "
                       f"from the parent's as {moved}, not as "
                       f"BWD_SASS_MOVED records")
        rec["parent_bitwise"] = {}
        for i, name in enumerate(("s2_c_bwd", "s3b0_a_bwd")):
            kernel, geo = BWD_CASES[name]
            a = bwd_inputs(kernel, geo, RESNET_B, torch.bfloat16, device,
                           seed=90 + i)

            def call():
                return bn.conv1x1_bwd(a["yk"], a["g"], a["yprev"], a["w"],
                                      a["aff_k"], a["aff_p"],
                                      act_prev=geo["act"],
                                      stride=geo["stride"])
            mine = call()
            with parent_kernels(parent, [bn.BWD1X1, bn.BWD3X3]):
                theirs = call()
            torch.cuda.synchronize()
            same = all(torch.equal(u, v) for u, v in zip(mine, theirs))
            rec["parent_bitwise"][name] = same
            if not same:
                bad.append(f"{name} differs from the parent's bits")
            del a, mine, theirs
    log("cnn bwd sass:", json.dumps(rec))
    if bad:
        raise AssertionError(f"cnn bwd sass: {bad}: {rec}")
    return rec


def check_cnn_bwd_kernels(device, smi, parent=None):
    """The library's SASS (with a parent checkout, the stage functions
    against the parent's); every backward case in bf16 at the main
    path's batch, then in f32 at 16 (with a parent checkout, the s2
    stages in turns with the parent's kernels); the ragged cases in both
    at B=3; the sweep of a step's stages; the NaN bar of the backward's
    recomputed prologue."""
    sass = bwd_sass(device, parent)
    cases = [bwd_case(name, dtype, n, device, seed=20 + i, parent=parent)
             for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16))
             for i, name in enumerate(BWD_CASES)]
    cases += [bwd_case(name, dtype, BWD_RAGGED_B, device, seed=40 + i,
                       cases=BWD_RAGGED, planted=False)
              for dtype in (torch.bfloat16, torch.float32)
              for i, name in enumerate(BWD_RAGGED)]
    return {"cases": cases, "sweep": bwd_sweep(device, smi), "sass": sass,
            "nan_bar": nan_bar(("bwd1x1", "bwd3x3"), device, parent)}


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
        conv_fwd_share=share("conv_gemm_kernel", "fwd_tc_kernel"),
        conv_bwd_share=share("dz_kernel", "dw_kernel", "dz_tc_kernel",
                             "dw_tc_kernel", "reduce_splits"))
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


def fit_turns(device, net, x, y, plans):
    """Each plan's fit steps in turns (a warm-up step, then two timed, a
    turn; TRAIN_RESNET_TURNS rounds), ``plans`` mapping a name to its
    ``set_fusion`` (level, stem): {"turns_<name>": step ms, their median,
    images/s, the turns' peak memory}."""
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
    out = {}
    for plan, ts in times.items():
        m = float(np.median(ts))
        out["turns_" + plan] = {"step_ms": [1e3 * t for t in ts],
                                "step_ms_median": 1e3 * m,
                                "images_per_s": RESNET_B / m,
                                "max_memory_allocated_bytes": peaks[plan]}
    return out


def train_steps(device, x, y, plan, steps, swaps=()):
    """A fresh full-width net from the conf seed trained ``steps`` fit
    steps on ``plan`` (an execution plan, or True: the fusion level set
    once): its start parameters, its velocity after the first step (the
    first gradient times -lr), and every step's loss."""
    net = resnet_train_net(device, torch.bfloat16)
    if plan is True:
        net.set_fusion(True)
        plan = None
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


def resnet_train_reference(device, variant="fused"):
    """f32 at B=8: two fit steps with the kernels, with the plain versions
    swapped in, on the xla plan, and with a planted fault; parameters, BN
    state and velocity by update_err. ``variant``: "fused" (the
    bottleneck plan; the fault in a block's backward), "stem" (the stem
    kernels engaged too; the fault in the stem's backward) or
    "fuse_true" (the bn -> act -> 1x1-conv plan; the fault in a group's
    backward)."""
    x, y = train_images(TRAIN_REF_B)
    if variant == "fuse_true":
        plain, fault = fused_swapped(), fuse_true_fault("no_mask")
        per_step = FUSE_TRUE_TRAIN_LAUNCHES
    elif variant == "stem":
        plain, fault = train_swapped() + stem_swapped(), stem_fault()
        per_step = RESNET_TRAIN_STEM_LAUNCHES
    else:
        plain, fault = train_swapped(), train_fault()
        per_step = RESNET_TRAIN_LAUNCHES
    runs = {}
    for label, plan, swaps in (("kernels", "fused", []),
                               ("plain", "fused", plain),
                               ("xla", "xla", []),
                               ("planted", "fused", fault)):
        net = resnet_train_net(device, torch.float32, lr=TRAIN_REF_LR)
        if variant != "fused" and plan == "fused":
            if variant == "fuse_true":
                net.set_fusion(True)
            else:
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
           "lr": TRAIN_REF_LR, "steps": TRAIN_REF_STEPS, "variant": variant,
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
    want = {n: c * TRAIN_REF_STEPS for n, c in per_step.items()}
    if {n: ref["launches"][n] for n in want} != want or \
            any(runs["plain"]["launches"][n] for n in want):
        failures.append("launches")
    name = {"fused": "resnet train reference",
            "stem": "resnet train stem reference",
            "fuse_true": "resnet fuse_true reference"}[variant]
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


#: the ragged cases (B = 3): odd images, C = 4 (RGBA: a tap's 16
#: channels all real), K = 36 (no multiple of 8: element-wise copies)
STEM_BWD_RAGGED = {"ragged_9x13": dict(h=9, w=13, c=4, k=36),
                   "ragged_15x17": dict(h=15, w=17, c=4, k=36)}
STEM_BWD_RAGGED_B = 3
#: HMMA.16816.F32.BF16 in the tensor-core dW function: 8 k16 steps (the
#: patch's rows) x 16 products
STEM_DW_TC_HMMA = 128
#: in the tensor-core dx function, by C: the body of its loop over the
#: 4 tap columns, 4 k16 steps x 24 products (three patch rows x the four
#: tap rows, two n8 fragments of outputs); at 4 C <= 8 the compiler
#: drops the second fragment's, whose outputs are never stored
STEM_DX_TC_HMMA = {1: 48, 2: 48, 3: 96, 4: 96}


def stem_bwd_inputs(n, dtype, device, seed, geo=STEM_BWD_GEO):
    """Seeded inputs of the stem's backward at ``geo`` (by default the
    training shape): x and a He-normal weight, the conv kernel's y and
    batch statistics with drawn BN gains and biases (the BN rows aff_p),
    the pooled output's gradient g; then, from the plain versions, dz0
    and the rows aff_k (m1, m2 from its sums), and dy, so that each
    kernel is held on its plain version's inputs."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    gen = torch.Generator().manual_seed(seed)
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
            "dz": dz, "aff_k": aff_k, "dy": dy, "geo": dict(geo)}


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


def stem_bwd_case(kernel, a, dtype, n, device, label=None, parent=None):
    """One stem backward kernel against its plain version on the same
    inputs: each output by rows and 64-row tiles (dz0, dy, dx as stored
    in the compute dtype, dW in f32 by its rows), the sums within
    BWD_SUMS of each channel's sum of |terms|; every bf16 kernel
    launched twice, bitwise equal (dz0 and its sums, dy and dW, dx); dy's largest difference from the plain
    version's (the same ops: 0 expected). At the training shape (no
    ``label``) in bf16 each planted fault fails the limits, and the
    kernel's, plain version's and library call's times stand beside the
    bound; a ragged case (``label``) is held to the same limits only."""
    from deeplearning4j_tpu_torch.nn.layers import stem
    kern, plain, library, faults = stem_bwd_fns(kernel, a)
    got, ref = kern(), plain()
    again = kern() if dtype == torch.bfloat16 else None
    torch.cuda.synchronize()
    geo = a["geo"]
    case = {"case": label or kernel, "kernel": kernel,
            "dtype": str(dtype).split(".")[-1], "batch": n, **geo}
    if kernel == "stem_bwd_dw":
        case["route"] = stem.stem_dw_route(dtype, geo["c"])
    elif kernel == "stem_bwd_dx":
        case["route"] = stem.stem_dx_route(dtype, geo["c"], geo["k"])
    failures = []
    if again is not None:
        pairs = [(got, again)] if kernel == "stem_bwd_dx" \
            else zip(got, again)
        case["bitwise_repeat"] = all(torch.equal(u, v) for u, v in pairs)
        if not case["bitwise_repeat"]:
            failures.append("two launches differ")
    if again is not None and kernel == "stem_bwd_dx":
        # dy one element off 16-byte alignment: the element-wise copies of
        # the halo give the same tiles, so the same bits
        dy = a["dy"]
        dyu = torch.empty(dy.numel() + 1, dtype=dy.dtype,
                          device=dy.device)[1:].view(dy.shape)
        dyu.copy_(dy)
        case["dy_unaligned_bitwise"] = torch.equal(
            stem.stem_bwd_dx(dyu, a["ws"], tuple(a["x"].shape)), got)
        if not case["dy_unaligned_bitwise"]:
            failures.append("an unaligned dy changes the result")
        del dyu
    if again is not None and label is not None and kernel == "stem_bwd_dw":
        # x one element off 16-byte alignment: the element-wise copies of
        # its rows give the same halo tiles, so the same bits
        x = a["x"]
        xu = torch.empty(x.numel() + 1, dtype=x.dtype,
                         device=x.device)[1:].view(x.shape)
        xu.copy_(x)
        case["x_unaligned_bitwise"] = all(torch.equal(u, v) for u, v in zip(
            stem.stem_bwd_dw(xu, a["y"], a["dz"], a["aff_k"]), got))
        if not case["x_unaligned_bitwise"]:
            failures.append("an unaligned x changes the result")
        del xu
    del again
    k = geo["k"]
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
    if kernel == "stem_bwd_dw":
        log(f"stem bwd_dw {case['case']} {case['dtype']}: dy's largest "
            f"difference from the plain version's "
            f"{case['dy']['max_abs_err']!r} (route {case['route']})")
    elif kernel == "stem_bwd_dx":
        log(f"stem bwd_dx {case['case']} {case['dtype']}: route "
            f"{case['route']}, dx tiles {case['dx']['tile_rel']!r}")
    if dtype == torch.bfloat16 and label is None:
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
    if label is not None:
        del kern, plain, library, faults
        return case
    bound_ms, bound_by = stem_bwd_bound(kernel, n, dtype)
    case.update(ms=median_ms(kern, device),
                plain_ms=median_ms(plain, device, iters=10),
                library_ms=median_ms(library, device),
                bound_ms=bound_ms, bound_by=bound_by)
    if parent and kernel in PARENT_TURN_CASES:
        case["parent"] = parent_swap_turns(
            parent, [stem.STEM_BWD_POOL, stem.STEM_BWD_DW, stem.STEM_BWD_DX],
            kern, device)
    log("stem bwd", json.dumps(case))
    del kern, plain, library, faults
    torch.cuda.empty_cache()
    return case


def stem_sass():
    """The stem backward library's SASS: the tensor-core dW function
    holds STEM_DW_TC_HMMA HMMA.16816.F32.BF16 and the dx ones (one per
    C) STEM_DX_TC_HMMA, the CUDA-core dW GEMM and dx pass none; their
    registers and spills from ptxas -v (none may spill) and their
    dynamic shared memory. The pool backward's functions (by dtype and
    route; the CUDA cores) with their registers, spills and dynamic
    shared memory, recorded."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import stem
    lib = stem._BWD_LIBRARY.load()
    pool_smem = (ctypes.c_int * 2)()
    lib.dl4j_stem_bwd_pool_smem(pool_smem)
    recs, bad = {}, []
    for grad, want, smem in (
            ("dw", lambda f: STEM_DW_TC_HMMA, lib.dl4j_stem_bwd_dw_tc_smem),
            ("dx", lambda f: STEM_DX_TC_HMMA[int(f.split("ILi")[1][0])],
             lib.dl4j_stem_bwd_dx_tc_smem)):
        rec, off = tc_sass(stem._BWD_LIBRARY, f"12{grad}_tc_kernel",
                           f"9{grad}_kernel", want)
        rec["smem_bytes"] = smem()
        recs[grad] = rec
        bad += off
        bad += [f"{f} spills" for f, lines in rec["ptxas"].items()
                if any("spill" in x and " 0 bytes spill stores" not in x
                       for x in lines)]
    recs["pool"] = {"ptxas": ptxas_usage(stem._BWD_LIBRARY,
                                         "bwd_pool_kernel"),
                    "smem_bytes": {"float32": pool_smem[0],
                                   "bfloat16": pool_smem[1]}}
    log("stem sass:", json.dumps(recs))
    if bad:
        counts = [r["hmma_16816_f32_bf16"] for r in recs.values()
                  if "hmma_16816_f32_bf16" in r]
        raise AssertionError(f"stem sass: HMMA.16816.F32.BF16 counts off "
                             f"or spills in {bad}: {counts}")
    return recs


#: the device kernels of one stem_bwd_dw / stem_bwd_dx call on each
#: route, as the library's launchers count them (dl4j_stem_bwd_dw_ /
#: dx_kernel_launches): dW the tensor-core pass and its split reduction,
#: or the dy pass, the CUDA-core GEMM and the reduction; dx the
#: tensor-core pass or the CUDA-core one
STEM_GRAD_KERNELS = {"dw": ("dy_kernel", "dw_kernel", "dw_tc_kernel",
                            "reduce_splits_kernel"),
                     "dx": ("dx_kernel", "dx_tc_kernel")}
STEM_GRAD_LAUNCHES = {
    "dw": {"tensor_cores": (0, 0, 1, 1), "cuda_cores": (1, 1, 0, 1)},
    "dx": {"tensor_cores": (0, 1), "cuda_cores": (1, 0)}}


def stem_grad_launches(a, grad):
    """The device kernels one stem_bwd_dw (``grad`` "dw") or stem_bwd_dx
    ("dx") call started, by the library's own counts, against its
    route's STEM_GRAD_LAUNCHES."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import stem
    lib = stem._BWD_LIBRARY.load()
    x, dy = a["x"], a["dy"]
    names = STEM_GRAD_KERNELS[grad]
    read = getattr(lib, f"dl4j_stem_bwd_{grad}_kernel_launches")

    def counts():
        c = (ctypes.c_int * len(names))()
        read(c)
        return list(c)

    before = counts()
    if grad == "dw":
        route = stem.stem_dw_route(x.dtype, x.shape[3])
        stem.stem_bwd_dw(x, a["y"], a["dz"], a["aff_k"])
    else:
        route = stem.stem_dx_route(dy.dtype, x.shape[3], dy.shape[3])
        stem.stem_bwd_dx(dy, a["ws"], tuple(x.shape))
    torch.cuda.synchronize()
    got = {n: v - b for n, v, b in zip(names, counts(), before)}
    want = dict(zip(names, STEM_GRAD_LAUNCHES[grad][route]))
    rec = {"route": route, "dtype": str(x.dtype).split(".")[-1],
           "device_kernels": got}
    log(f"stem bwd_{grad} launches:", json.dumps(rec))
    if got != want:
        raise AssertionError(f"stem_bwd_{grad} on {route} launched {got}, "
                             f"expected {want}")
    return rec


def check_stem_dx_guard(device):
    """The tensor-core dx launcher refuses what its tiles do not hold
    (K = 65, C = 5: a CUDA error, no launch) instead of reading or
    writing past them; it has no partials."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    bf = torch.bfloat16
    refused = []
    for c, k in ((3, 65), (5, 64)):
        dy = torch.zeros((2, 16, 16, k), dtype=bf, device=device)
        w = torch.zeros((64 * c, k), dtype=bf, device=device)
        dx = torch.empty((2, 32, 32, c), dtype=bf, device=device)
        before = stem.STEM_BWD_DX.launches
        try:
            stem.STEM_BWD_DX.launch(
                (bf, stem.TENSOR_CORES), dy.data_ptr(), w.data_ptr(),
                dx.data_ptr(), 2, 32, 32, c, k, bn._stream(dy))
        except RuntimeError as e:
            assert stem.STEM_BWD_DX.launches == before, \
                "a refused launch counted"
            refused.append({"c": c, "k": k, "error": str(e)})
            continue
        raise AssertionError(f"stem_bwd_dx's tensor-core pass took C {c}, "
                             f"K {k}")
    log("stem dx guard:", json.dumps(refused))
    return refused


def check_stem_dw_guard(device):
    """The tensor-core dW launcher refuses partials one grid row short
    (a CUDA error, no launch) instead of writing past them."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import stem
    n, h, w, c, k = 2, 32, 32, 3, 64
    bf = torch.bfloat16
    x = torch.zeros((n, h, w, c), dtype=bf, device=device)
    y = torch.zeros((n, 16, 16, k), dtype=bf, device=device)
    aff = torch.zeros((6, k), device=device)
    dy = torch.empty_like(y)
    dw = torch.empty((64 * c, k), device=device)
    tiles = stem._stem_dw_plan(n, h, w, k, bn._sm_count(device)).tiles
    part = torch.empty((tiles, 64 * c, k), device=device)
    before = stem.STEM_BWD_DW.launches
    try:
        stem.STEM_BWD_DW.launch(
            (bf, stem.TENSOR_CORES), x.data_ptr(), y.data_ptr(),
            y.data_ptr(), aff.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            part.data_ptr(), n, h, w, c, k, tiles - 1, bn._stream(x))
    except RuntimeError as e:
        assert stem.STEM_BWD_DW.launches == before, "a refused launch counted"
        log(f"stem dw guard: {tiles - 1} of {tiles} partial rows refused "
            f"({e})")
        return {"tiles": tiles, "refused": tiles - 1}
    raise AssertionError("stem_bwd_dw took partials one grid row short")


def check_stem_bwd_kernels(device, parent=None):
    """The SASS check; the three stem backward kernels in bf16 at the
    main path's batch, then in f32 at 16 (with a parent checkout, the
    pool backward in turns with the parent's); the dW route's device
    kernels in both; the short-partials guard; the ragged cases in both
    at B=3; the NaN bar of the pool backward."""
    sass = stem_sass()
    cases, launches, dx_launches = [], [], []
    for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16)):
        a = stem_bwd_inputs(n, dtype, device, seed=40)
        for kernel in ("stem_bwd_pool", "stem_bwd_dw", "stem_bwd_dx"):
            cases.append(stem_bwd_case(kernel, a, dtype, n, device,
                                       parent=parent))
        launches.append(stem_grad_launches(a, "dw"))
        dx_launches.append(stem_grad_launches(a, "dx"))
        del a
        torch.cuda.empty_cache()
    guard = check_stem_dw_guard(device)
    dx_guard = check_stem_dx_guard(device)
    for i, (label, geo) in enumerate(STEM_BWD_RAGGED.items()):
        for dtype in (torch.bfloat16, torch.float32):
            a = stem_bwd_inputs(STEM_BWD_RAGGED_B, dtype, device,
                                seed=60 + i, geo=geo)
            for kernel in ("stem_bwd_pool", "stem_bwd_dw", "stem_bwd_dx"):
                cases.append(stem_bwd_case(kernel, a, dtype,
                                           STEM_BWD_RAGGED_B, device,
                                           label=label))
    return {"cases": cases, "sass": sass, "dw_launches": launches,
            "dw_guard": guard, "dx_launches": dx_launches,
            "dx_guard": dx_guard,
            "nan_bar": nan_bar(("stem_bwd_pool",), device, parent)}


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
    rec.update(fit_turns(device, net, x, y, {
        "fused_stem": ("bottleneck", True), "fused": ("bottleneck", False),
        "xla": (False, False)}))
    net.set_fusion("bottleneck", stem=True)
    rec["profile"], share = profile_fit_step(net, x, y, None)
    rec["profile"].update(
        conv_fwd_share=share("conv_gemm_kernel", "fwd_tc_kernel"),
        conv_bwd_share=share("dz_kernel", "dw_kernel<", "dz_tc_kernel",
                             "dw_tc_kernel<", "reduce_splits"),
        stem_share=share("conv_gemm_kernel<__nv_bfloat16, 2>",
                         "fwd_pool_kernel", "bwd_pool_kernel", "dy_kernel",
                         "dw_kernel<__nv_bfloat16>(", "dw_tc::dw_tc_kernel"))
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


# ---------------------------------------------------------------------
# phases 20-22: ResNet50 on the bn -> act -> 1x1-conv plan (fuse=True)
# ---------------------------------------------------------------------
def fused_inputs(n, hw, c, k, dtype, device, seed, tail=False):
    """Seeded inputs of one fused group: y [M, C] a raw conv output (a
    per-channel mean and scale drawn) with its BN affine (sc, bb) that
    zeroes about half of it under relu; w2 [C, K] He-normal, b [K]
    small, g [M, K] an output gradient. With ``tail`` y and g are the
    first M rows of buffers whose next 64 rows are NaN."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    m = n * hw * hw
    mean, std = 0.3 * randn(c), 0.5 + torch.rand(c, generator=gen)
    y = mean + std * randn(m, c)
    sc = (0.5 + torch.rand(c, generator=gen)) / std
    bb = 0.2 * randn(c) - mean * sc
    a = {"y": y.to(device, dtype), "sc": sc.to(device),
         "bb": bb.to(device),
         "w2": (randn(c, k) * (2.0 / c) ** 0.5).to(device, dtype),
         "b": (0.1 * randn(k)).to(device),
         "g": randn(m, k).to(device, dtype)}
    if tail:
        for key in ("y", "g"):
            buf = torch.full((m + 64, a[key].shape[1]), float("nan"),
                             dtype=dtype, device=device)
            buf[:m] = a[key]
            a[key] = buf[:m]
    return a


def fused_faults(a):
    """The planted faults (bf16), through the plain versions: {fault:
    (its output, the name of the kernel's output it is held against)}."""
    from deeplearning4j_tpu_torch.nn.layers import fused
    y, sc, bb, w2, b, g = (a[k] for k in ("y", "sc", "bb", "w2", "b", "g"))
    dtype = y.dtype
    z0 = y.float() * sc + bb
    z = torch.clamp_min(z0, 0.0)
    gf = g.float()
    dz = gf @ w2.float().t()
    return {
        # the forward's prologue without its relu
        "no_relu": (fused.fused_matmul_plain(y, sc, bb, w2, b, "identity"),
                    "out"),
        # the backward's dz without its relu' mask
        "no_mask": ((dz * sc).to(dtype), "dy"),
        # dW from z in f32, not rounded to g's dtype (bf16 only)
        "unrounded_z": ((z.t() @ gf).to(w2.dtype), "dw"),
    } if dtype == torch.bfloat16 else {}


def fused_fns(a):
    """(forward kernel, forward plain, forward library, backward kernel,
    backward plain, backward library) on inputs ``a``: the library calls
    are cuBLAS's ``torch.matmul`` on the activated input (forward; the
    activation made here, outside its time) and the two products
    ``g @ w2^T`` and ``z^T @ g`` (backward, "none alone")."""
    from deeplearning4j_tpu_torch.nn.layers import fused
    y, sc, bb, w2, b, g = (a[k] for k in ("y", "sc", "bb", "w2", "b", "g"))
    z = torch.clamp_min(y.float() * sc + bb, 0.0).to(y.dtype)
    zt, w2t = z.t(), w2.t()
    return (lambda: fused.fused_matmul(y, sc, bb, w2, b, "relu"),
            lambda: fused.fused_matmul_plain(y, sc, bb, w2, b, "relu"),
            lambda: torch.matmul(z, w2),
            lambda: fused.fused_matmul_bwd(y, sc, bb, w2, g, "relu"),
            lambda: fused.fused_matmul_bwd_plain(y, sc, bb, w2, g, "relu"),
            lambda: (torch.matmul(g, w2t), torch.matmul(zt, g)))


def fused_bounds(m, c, k, dtype):
    """Least time on this card for the forward and the backward: the
    bytes each must move (forward: y, W, sc, bb, b in, out written;
    backward: y, g, W, sc, bb in, dy, dW and the three sums written) over
    the memory rate, against its multiply-adds (2 M C K forward, twice
    that backward) over the dtype's peak. Returns {"fwd": (ms, by),
    "bwd": (ms, by)}."""
    el = 2 if dtype == torch.bfloat16 else 4
    out = {}
    for kind, nbytes, ops in (
            ("fwd", (m * c + c * k + m * k) * el + (2 * c + k) * 4,
             2 * m * c * k),
            ("bwd", (2 * m * c + m * k + 2 * c * k) * el + (4 * c + k) * 4,
             4 * m * c * k)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
        out[kind] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def fused_sums_rel(got, want, terms):
    """The sums' largest error over each channel's sum of |terms|."""
    return float(((got - want).abs() / terms.clamp_min(1e-30)).max())


def fused_bwd_plan(m, c, k, dtype, device):
    """The backward's route and plan as its wrapper makes them: bf16 the
    tensor cores' (fused._bwd_tc_plan: 128-row dz blocks, the dW pass's
    64-row chunks a split), f32 the CUDA cores' (128-row blocks, rows a
    split)."""
    from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
    from deeplearning4j_tpu_torch.nn.layers import fused
    route = fused.bwd_route(dtype)
    if route == fused.TENSOR_CORES:
        plan = fused._bwd_tc_plan(m, c, k, bn._sm_count(device))._asdict()
    else:
        chunk, splits = bn._dw_splits(m, -(-(c + 1) // 128) * -(-k // 64),
                                      device)
        plan = {"tiles": -(-m // 128), "chunk": chunk, "splits": splits}
    return route, plan


def fused_rounded_dz_sums(a):
    """The planted fault "rounded_dz_sums": dsc and dbb summed over the
    bf16-rounded dz instead of the f32 dz (what staging dz in bf16 for
    the epilogue's sums would give)."""
    y32, g32 = a["y"].float(), a["g"].float()
    dz = g32 @ a["w2"].float().t()
    dz = torch.where(y32 * a["sc"] + a["bb"] > 0, dz, 0.0)
    dz = dz.to(a["y"].dtype).float()
    return (dz * y32).sum(0), dz.sum(0)


def fused_case(name, dtype, n, device, seed, parent=None):
    """One group's shape: the forward and backward kernels against their
    plain versions (out, dy and dW by row and 64-row tile, the sums
    within BWD_SUMS of each channel's sum of |terms|, every value finite),
    two backward launches bitwise equal, the planted faults (bf16) beyond
    the limits; the backward's route and plan; then the kernels', plain
    versions' and library calls' times beside the bounds, and with a
    parent checkout its forward and backward in turns with this one's."""
    if name in ("tail", "ragged"):
        n, hw, c, k = FUSED_TAIL if name == "tail" else FUSED_RAGGED
    else:
        hw, c, k = FUSED_STAGES[name]
    a = fused_inputs(n, hw, c, k, dtype, device, seed,
                     tail=name in ("tail", "ragged"))
    m = n * hw * hw
    fwd, fwd_plain, fwd_lib, bwd, bwd_plain, bwd_lib = fused_fns(a)
    out, ref_out = fwd(), fwd_plain()
    out_again = fwd()
    got, ref = bwd(), bwd_plain()
    again = bwd()
    torch.cuda.synchronize()
    case = {"case": name, "dtype": str(dtype).split(".")[-1], "batch": n,
            "m": m, "c": c, "k": k,
            # the forward's units: bf16 the shared tensor-core 1x1
            # (conv_fwd_tc.cuh), f32 the CUDA cores
            "fwd_route": "tensor_cores" if dtype == torch.bfloat16
            else "cuda_cores"}
    if dtype == torch.bfloat16:
        from deeplearning4j_tpu_torch.nn.layers import bottleneck as bn
        from deeplearning4j_tpu_torch.nn.layers import fused
        case["fwd_plan"] = fused._fwd_plan(m, k, bn._sm_count(device)) \
            ._asdict()
        case["fwd_smem_bytes"] = fused._LIBRARY.load() \
            .dl4j_fused_fwd_tc_smem(m, k)
        import ctypes
        smem = (ctypes.c_int * 2)()
        fused._LIBRARY.load().dl4j_fused_bwd_tc_smem(c, k, smem)
        case["bwd_smem_bytes"] = {"dz": smem[0], "dw": smem[1]}
    case["bwd_route"], case["bwd_plan"] = fused_bwd_plan(m, c, k, dtype,
                                                         device)
    # the bf16 kernels copy 16 bytes a thread where C and K are multiples
    # of 8 (the buffers here are aligned), else element by element
    case["copies"] = "16-byte" if c % 8 == 0 and k % 8 == 0 \
        else "element-wise"
    failures = []
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *got))
    case["fwd_bitwise_repeat"] = torch.equal(out, out_again)
    if not case["fwd_bitwise_repeat"]:
        failures.append("two forward launches differ")
    del out_again
    case["bitwise_repeat"] = all(torch.equal(u, v)
                                 for u, v in zip(got, again))
    if not case["bitwise_repeat"]:
        failures.append("two backward launches differ")
    limits = {"row_rel": CONV_ROW[dtype], "tile_rel": CONV_TILE[dtype],
              "sums_rel": BWD_SUMS}
    for key, g_, r_ in (("out", out, ref_out), ("dy", got[0], ref[0]),
                        ("dw", got[3], ref[3])):
        row_rel, tile_rel = conv_agreement(g_, r_)
        case[key] = {"max_abs_err": float((g_.float() - r_.float()).abs()
                                          .max()),
                     "row_rel": row_rel, "tile_rel": tile_rel}
        if row_rel > limits["row_rel"] or tile_rel > limits["tile_rel"]:
            failures.append(key)
    # the sums' terms, from the plain version's f32 dz
    y32, g32 = a["y"].float(), a["g"].float()
    dz = g32 @ a["w2"].float().t()
    dz = torch.where(y32 * a["sc"] + a["bb"] > 0, dz, 0.0)
    case["sums_rel"] = {
        "dsc": fused_sums_rel(got[1], ref[1], (dz * y32).abs().sum(0)),
        "dbb": fused_sums_rel(got[2], ref[2], dz.abs().sum(0)),
        "db": fused_sums_rel(got[4], ref[4], g32.abs().sum(0))}
    if max(case["sums_rel"].values()) > BWD_SUMS:
        failures.append("sums")
    del dz, y32, g32
    case["max_abs_err"] = case["out"]["max_abs_err"]
    case["limits"] = limits
    if dtype == torch.bfloat16:
        planted_rec = {}
        outs = {"out": out, "dy": got[0], "dw": got[3]}
        for fault, (bad, key) in fused_faults(a).items():
            planted_rec[fault] = conv_agreement(bad, outs[key])
            if planted_rec[fault][0] <= limits["row_rel"] and \
                    planted_rec[fault][1] <= limits["tile_rel"]:
                failures.append(f"the limits do not tell {fault}")
        # the sums over the bf16-rounded dz, held to the sums' limit
        y32, g32 = a["y"].float(), a["g"].float()
        dz = torch.where(y32 * a["sc"] + a["bb"] > 0,
                         g32 @ a["w2"].float().t(), 0.0)
        bad_sc, bad_bb = fused_rounded_dz_sums(a)
        planted_rec["rounded_dz_sums"] = max(
            fused_sums_rel(bad_sc, got[1], (dz * y32).abs().sum(0)),
            fused_sums_rel(bad_bb, got[2], dz.abs().sum(0)))
        if planted_rec["rounded_dz_sums"] <= BWD_SUMS:
            failures.append("the limits do not tell rounded_dz_sums")
        del dz, y32, g32, bad_sc, bad_bb
        case["planted"] = planted_rec
    log("fused check", json.dumps(case))
    if not finite or failures:
        raise AssertionError(f"fused kernels disagree with their plain "
                             f"versions ({failures}, finite {finite}): "
                             f"{case}")
    del out, ref_out, got, ref, again
    bounds = fused_bounds(m, c, k, dtype)
    for kind, kern, plain, library in (("fwd", fwd, fwd_plain, fwd_lib),
                                       ("bwd", bwd, bwd_plain, bwd_lib)):
        case[kind] = {"ms": median_ms(kern, device),
                      "plain_ms": median_ms(plain, device, iters=10),
                      "library_ms": median_ms(library, device),
                      "bound_ms": bounds[kind][0],
                      "bound_by": bounds[kind][1]}
    if parent:
        from deeplearning4j_tpu_torch.nn.layers import fused
        for kind, kern in (("fwd", fwd), ("bwd", bwd)):
            case[kind]["parent"] = parent_swap_turns(
                parent, [fused.FUSED_FWD, fused.FUSED_BWD], kern, device)
    log("fused", json.dumps(case))
    del a, fwd, fwd_plain, fwd_lib, bwd, bwd_plain, bwd_lib
    torch.cuda.empty_cache()
    return case


def fused_sass():
    """The fused library's SASS: each bf16 forward function (the shared
    tensor-core 1x1, bias epilogue) holds 64 HMMA.16816.F32.BF16, the
    f32 forward (the CUDA cores) none; each bf16 backward function (the
    shared tensor-core dz and dW passes of conv_bwd_tc.cuh, fused mode)
    holds HMMA, the f32 backward's (fused_dz_kernel, fused_dw_kernel)
    none; with their registers and spills from ptxas -v (no backward
    function may spill)."""
    from deeplearning4j_tpu_torch.nn.layers import fused
    rec, bad = tc_sass(fused._LIBRARY, CONV_TC_KERNEL,
                       FUSED_CUDA_CORE_KERNEL, lambda f: CONV_TC_HMMA[1])
    counts, _ = sass_hmma(fused._LIBRARY)
    bwd_tc = {f: c for f, c in counts.items() if tc_key(f)}
    bwd_cc = {f: c for f, c in counts.items()
              if "fused_dz_kernel" in f or "fused_dw_kernel" in f}
    bad += [f for f, c in bwd_tc.items() if c == 0]
    bad += [f for f, c in bwd_cc.items() if c != 0]
    if not bwd_tc or not bwd_cc:
        bad.append("no tensor-core or no CUDA-core backward function")
    rec["hmma_16816_f32_bf16"].update(bwd_tensor_cores=bwd_tc,
                                      bwd_cuda_cores=bwd_cc)
    rec["ptxas_bwd"] = {**ptxas_usage(fused._LIBRARY, "dz_tc_kernel"),
                        **ptxas_usage(fused._LIBRARY, "dw_tc_kernel")}
    bad += spilling(rec["ptxas_bwd"])
    log("fused sass:", json.dumps(rec))
    if bad:
        raise AssertionError(f"fused sass: HMMA.16816.F32.BF16 counts off "
                             f"or spills in {bad}: "
                             f"{rec['hmma_16816_f32_bf16']}")
    return rec


def check_fused_kernels(device, parent=None):
    """The SASS check; every stage's group in bf16 at the main path's
    batch (with a parent checkout, its backward in turns), then in f32
    at 16; the tail and the ragged group in both."""
    sass = fused_sass()
    return {"sass": sass, "cases": [
        fused_case(name, dtype, n, device, seed=40 + i,
                   parent=parent if name in FUSED_STAGES else None)
        for dtype, n in ((torch.bfloat16, RESNET_B), (torch.float32, 16))
        for i, name in enumerate([*FUSED_STAGES, "tail", "ragged"])],
        "nan_bar": nan_bar(("fused", "fused_bwd"), device, parent)}


def fuse_true_net(device, dtype, lr=0.1, calibrate=False):
    """bench_all.py's bench_train_plan ResNet50 with ``fuse=True`` in
    place of ``execution_plan="fused"``: 1000 classes, 224x224, NHWC,
    Nesterovs(lr, 0.9), random weights from the conf seed; with
    ``calibrate`` the BN statistics set from 16 seeded images (as phase
    11's, so that inference does not saturate)."""
    from deeplearning4j_tpu_torch.nn.updater import Nesterovs
    from deeplearning4j_tpu_torch.zoo import ResNet50
    net = ResNet50(num_classes=RESNET_CLASSES, height=RESNET_HW,
                   width=RESNET_HW, updater=Nesterovs(lr, momentum=0.9),
                   data_format="NHWC", fuse=True).init(device=device)
    if calibrate:
        net.set_fusion(False)
        calibrate_bn(net, images(16, device, seed=7))
        net.set_fusion(True)
    net.conf.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return net


def fused_swapped():
    """The fused op's kernel wrappers swapped for their plain versions
    (for ``with_swaps``)."""
    from deeplearning4j_tpu_torch.nn.layers import fused
    return [(vars(fused), {"fused_matmul": fused.fused_matmul_plain,
                           "fused_matmul_bwd": fused.fused_matmul_bwd_plain})]


def fuse_true_fault(kind):
    """Swaps (for ``with_swaps``) that plant a fault in group
    FUSE_TRUE_PLANTED (counted per pass of 16 calls), through the
    kernels: "no_relu", its forward's prologue without the relu;
    "no_mask", its backward's dz without the relu' mask (dy and the sums
    of the identity prologue's launch, dW of the right one)."""
    from deeplearning4j_tpu_torch.nn.layers import fused
    fwd, bwd, seen = fused.fused_matmul, fused.fused_matmul_bwd, [0]

    def hit():
        seen[0] += 1
        return (seen[0] - 1) % 16 == FUSE_TRUE_PLANTED

    def no_relu(y2, sc, bb, w2, b, act="relu"):
        return fwd(y2, sc, bb, w2, b, "identity" if hit() else act)

    def no_mask(y2, sc, bb, w2, g, act="relu"):
        if not hit():
            return bwd(y2, sc, bb, w2, g, act)
        _, _, _, dw, db = bwd(y2, sc, bb, w2, g, act)
        dy, dsc, dbb, _, _ = bwd(y2, sc, bb, w2, g, "identity")
        return dy, dsc, dbb, dw, db

    if kind == "no_relu":
        return [(vars(fused), {"fused_matmul": no_relu})]
    return [(vars(fused), {"fused_matmul_bwd": no_mask})]


def resnet_fuse_true(device):
    """ResNet50 on the bn -> act -> 1x1-conv plan at full width: one
    counted ``output()`` (calibrated BN statistics) with its logits
    against the plain versions' and the planted prologue fault; then
    ``fit``: a warm-up step and the counted timed steps, the fuse=True
    and xla plans' steps and peak memory in turns, one profiled step;
    the losses against a fresh xla-plan net's from the same seed, and
    (a reading) against a fresh fuse=True net's whose first step runs
    the plain versions."""
    rec, failures = {}, []
    net = fuse_true_net(device, torch.bfloat16, calibrate=True)
    x = images(RESNET_B, device, seed=8)
    net.output(x)
    zero_counts()
    out_s, probs = output_s(net, x)
    counts = read_counts()
    inf = {"output_ms": 1e3 * out_s, "launches": counts,
           "groups": len(net._conv_plan())}
    if tuple(probs.shape) != (RESNET_B, RESNET_CLASSES) or \
            not bool(torch.isfinite(probs).all()):
        failures.append("probabilities not finite or misshapen")
    inf["row_sum_max_dev"] = float((probs.double().sum(1) - 1).abs().max())
    inf["max_probability"] = float(probs.max())
    if inf["row_sum_max_dev"] > RESNET_ROW_SUM:
        failures.append("rows do not sum to 1")
    for name, want in FUSE_TRUE_LAUNCHES.items():
        if counts[name] != want:
            failures.append(f"{name} launched {counts[name]} in a forward, "
                            f"want {want}")
    zero_counts()
    plain = with_swaps(fused_swapped(), lambda: logits(net, x))
    if any(read_counts().values()):
        failures.append("the plain versions launched a kernel")
    limit = RESNET_LOGIT[torch.bfloat16]
    inf["logit_rel"] = logit_rel(logits(net, x), plain)
    inf["logit_rel_planted_no_relu"] = logit_rel(
        with_swaps(fuse_true_fault("no_relu"), lambda: logits(net, x)),
        plain)
    inf["logit_rel_limit"] = limit
    if inf["logit_rel"] > limit:
        failures.append("logits disagree with the plain versions'")
    if inf["logit_rel_planted_no_relu"] <= limit:
        failures.append("the limit does not tell the planted no_relu")
    # output() of the two plans in turns (fuse_true, xla, fuse_true, xla)
    times = {"fuse_true": [], "xla": []}
    for _ in range(2):
        for plan in times:
            net.set_fusion(plan == "fuse_true")
            net.output(x)
            times[plan] += [output_s(net, x)[0] for _ in range(RESNET_TIMED)]
    for plan, ts in times.items():
        med = float(np.median(ts))
        inf["turns_" + plan] = {"output_ms": [1e3 * t for t in ts],
                                "output_ms_median": 1e3 * med,
                                "images_per_s": RESNET_B / med}
    rec["inference"] = inf
    del net, x, probs, plain
    torch.cuda.empty_cache()

    net = fuse_true_net(device, torch.bfloat16)
    x, y = train_images(RESNET_B)
    start = tree_numpy(net.params)
    warm_s, warm_loss = fit_s(net, x, y, None)
    first = tree_numpy(net.updater_state)
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
    rec.update(
        config={"model": "ResNet50", "classes": RESNET_CLASSES,
                "hw": RESNET_HW, "batch": RESNET_B, "dtype": "bfloat16",
                "data_format": "NHWC", "updater": "Nesterovs(0.1, 0.9)",
                "plan": "fuse=True", "groups": len(net._conv_plan())},
        warmup_step_s=warm_s, warmup_loss=warm_loss, losses=losses,
        step_ms=[1e3 * t for t in step_s], step_ms_median=1e3 * med,
        images_per_s=RESNET_B / med, max_memory_allocated_bytes=peak,
        launches=counts)
    if not all(np.isfinite(losses + [warm_loss])):
        failures.append("loss not finite")
    for name, per_step in FUSE_TRUE_TRAIN_LAUNCHES.items():
        if counts[name] != per_step * TRAIN_RESNET_STEPS:
            failures.append(f"{name} launched {counts[name]} in "
                            f"{TRAIN_RESNET_STEPS} steps, want "
                            f"{per_step} a step")
    # the two plans' steps and peak memory in turns (fuse_true, xla, ...)
    rec.update(fit_turns(device, net, x, y, {"fuse_true": (True, False),
                                             "xla": (False, False)}))
    net.set_fusion(True)
    rec["profile"], share = profile_fit_step(net, x, y, None)
    rec["profile"].update(
        # bf16: the shared tensor-core 1x1 with the bias epilogue
        fused_fwd_share=share("fused_fwd_kernel", "fwd_tc_kernel<1, 2, 1>",
                              "fwd_tc_kernel<1, 4, 1>"),
        # bf16: conv_bwd_tc.cuh's fused-mode passes (template mode 1;
        # no bottleneck stage runs in a fuse=True step)
        fused_bwd_share=share("fused_dz_kernel", "fused_dw_kernel",
                              "dz_tc_kernel<1, 2, 1>",
                              "dz_tc_kernel<1, 4, 1>",
                              *(f"dw_tc_kernel<1, {wm}, {wn}, 1>"
                                for wm, wn in ((1, 2), (1, 4), (1, 8),
                                               (2, 2), (2, 4))),
                              "fused_finish_kernel", "reduce_partials"))
    del net
    torch.cuda.empty_cache()
    xstart, xfirst, xlosses = train_steps(device, x, y, "xla",
                                          1 + TRAIN_RESNET_STEPS)
    _, pfirst, plosses = train_steps(device, x, y, True,
                                     1 + TRAIN_RESNET_STEPS,
                                     fused_swapped())
    all_losses = [warm_loss] + losses
    n = FUSE_TRUE_LOSS_AGREED
    rec["against_xla"] = {
        "same_start": all(np.array_equal(a, b) for a, b in zip(
            leaf_values(start), leaf_values(xstart))),
        "losses_xla": xlosses,
        "loss_rel": [abs(a - b) / b for a, b in zip(all_losses, xlosses)],
        "losses_plain_first": plosses,
        "loss_rel_plain_first": [abs(a - b) / b for a, b in
                                 zip(all_losses, plosses)],
        "first_velocity_rel_l2": {"xla": rel_l2(first, xfirst),
                                  "plain": rel_l2(first, pfirst)},
        "limits": {"loss_rel": TRAIN_LOSS_AGREE, "losses": n}}
    if not rec["against_xla"]["same_start"]:
        failures.append("the xla plan's net starts from other weights")
    if not max(rec["against_xla"]["loss_rel"][:n]) <= TRAIN_LOSS_AGREE:
        failures.append("the losses part from the xla plan's")
    log("resnet fuse_true:", json.dumps(rec))
    if failures:
        raise AssertionError(f"resnet fuse_true: {failures}: {rec}")
    return rec


# ---------------------------------------------------------------------
# phases 23-25: the text LSTM and the recurrence kernels
# ---------------------------------------------------------------------
def lstm_inputs(t, n, h, dtype, device, seed, peep=True, mask=False):
    """Seeded recurrence inputs: zx [T, N, 4H] (0.5 N(0, 1): gates away
    from saturation), RW [H, 4H] of scale 1/sqrt(H), h0, c0 [N, H], the
    peepholes [3, H] (or None), a 0/1 mask [T, N] with two fully masked
    steps and one fully masked row (or None), and the backward's output
    gradients dout [T, N, H], dhT, dcT [N, H]."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device, dtype)

    m = None
    if mask:
        m = (torch.rand((t, n), generator=gen) > 0.25).float()
        m[t // 4] = 0.0
        m[t // 2] = 0.0
        m[:, 1] = 0.0
        m = m.to(device)
    return {"zx": randn(t, n, 4 * h, scale=0.5),
            "rw": randn(h, 4 * h, scale=h ** -0.5),
            "h0": randn(n, h, scale=0.5), "c0": randn(n, h, scale=0.5),
            "peephole": randn(3, h, scale=0.3) if peep else None,
            "mask": m, "dout": randn(t, n, h),
            "dh": randn(n, h, scale=0.5), "dc": randn(n, h, scale=0.5)}


def lstm_limits(dtype, t):
    """The recurrence kernels' limits for a sequence of t steps (see
    LSTM_ROW)."""
    span = "short" if t <= LSTM_SHORT_T else "long"
    return {"row_rel": LSTM_ROW[dtype, span],
            "tile_rel": LSTM_TILE[dtype, span], "span": span}


def lstm_fault_forward(a, fault):
    """The plain forward with a planted fault: "po_on_c_prev", the output
    gate's peephole reading the previous cell; "no_mask_blend_c", a
    masked step keeping the new cell; "unrounded_carry", h and c carried
    in f32 between steps (rounded only as outputs); "stale_peer", the
    cluster route's second block's piece of h_{t-1} read from the other
    buffer, a step stale (zeros at the first step), as the CPU tests'
    mirror plants it. Returns out."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    zx, rw, p, m = a["zx"], a["rw"], a["peephole"], a["mask"]
    dt, h = zx.dtype, rw.shape[0]
    rwf = rw.float()
    hp, cp = a["h0"].float(), a["c0"].float()
    h_stale = torch.zeros_like(hp)   # the other buffer: zeros, then h_{t-2}
    plan = lk._lstm_fwd_cluster_plan(zx.shape[1], h, dt)
    peer = slice(plan.ub, min(h, 2 * plan.ub))
    p = None if p is None else p.float()
    outs = []
    for t in range(zx.shape[0]):
        h_in = hp
        if fault == "stale_peer":
            h_in = hp.clone()
            h_in[:, peer] = h_stale[:, peer]
            h_stale = hp
        z = zx[t].float() + h_in @ rwf
        zi, zf, zg, zo = z.split(h, dim=1)
        if p is not None:
            zi, zf = zi + p[0] * cp, zf + p[1] * cp
        i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        cn = f * cp + i * g
        if p is not None:
            zo = zo + p[2] * (cp if fault == "po_on_c_prev" else cn)
        hn = torch.sigmoid(zo) * torch.tanh(cn)
        hc, cc, ho = hn, cn, hn
        if m is not None:
            mt = m[t][:, None]
            hc = hn * mt + hp * (1.0 - mt)
            cc = cn if fault == "no_mask_blend_c" else \
                cn * mt + cp * (1.0 - mt)
            ho = hc * mt
        outs.append(ho.to(dt))
        if fault == "unrounded_carry":
            hp, cp = hc, cc
        else:
            hp, cp = hc.to(dt).float(), cc.to(dt).float()
    return torch.stack(outs)


#: the backward's planted faults: "dh_bf16_dgates", dh_{t-1} from the
#: dgates rounded to bf16 (the tensor-core product without the split's
#: lower terms); "dc_no_peep", dc_{t-1} without the pI / pF terms. The
#: second is a semantic fault, held wherever there are peepholes; the
#: first is bf16 rounding noise, held in f32 and reported (its readings,
#: told or not) in bf16, where the limits at a long T are of its size
LSTM_BWD_FAULTS = ("dh_bf16_dgates", "dc_no_peep")


def lstm_fault_backward(gates, c, c0, rw, peep, dout, dh_t, dc_t, fault):
    """lstm_backward_plain with a planted fault (LSTM_BWD_FAULTS):
    (dzx, dh0, dc0) in dout's dtype."""
    t_len, n, h = c.shape
    dt = dout.dtype
    rwt = rw.float().t()
    p = None if peep is None else peep.float()
    dh_next, dc_next = dh_t.float(), dc_t.float()
    dzx = []
    for t in range(t_len - 1, -1, -1):
        i, f, g, o = gates[t].float().split(h, dim=1)
        cn = c[t].float()
        cp = c0.float() if t == 0 else c[t - 1].to(dt).float()
        dh = dout[t].float() + dh_next
        tc = torch.tanh(cn)
        dzo = dh * tc * o * (1.0 - o)
        dcn = dh * o * (1.0 - tc * tc) + dc_next
        if p is not None:
            dcn = dcn + p[2] * dzo
        dzi = dcn * g * i * (1.0 - i)
        dzf = dcn * cp * f * (1.0 - f)
        dzg = dcn * i * (1.0 - g * g)
        dc_next = dcn * f
        if p is not None and fault != "dc_no_peep":
            dc_next = dc_next + p[0] * dzi + p[1] * dzf
        dg = torch.cat([dzi, dzf, dzg, dzo], dim=1)
        dzx.append(dg.to(dt))
        if fault == "dh_bf16_dgates":
            dg = dg.to(torch.bfloat16).float()
        dh_next = dg @ rwt
    return torch.stack(dzx[::-1]), dh_next.to(dt), dc_next.to(dt)


def lstm_bwd_launches():
    """The backward's device kernels started so far (the cooperative
    kernel, the cluster kernel), as its launchers count them."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    out = (ctypes.c_int * 2)()
    lk._LIBRARY.load().dl4j_lstm_bwd_kernel_launches(out)
    return list(out)


def lstm_fwd_launches():
    """The forward's device kernels started so far (the cooperative
    kernel, the cluster kernel), as its launchers count them."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    out = (ctypes.c_int * 2)()
    lk._LIBRARY.load().dl4j_lstm_fwd_kernel_launches(out)
    return list(out)


def parent_lstm_fwd(parent, args, save, device):
    """The parent checkout's forward (the cooperative kernel at every H)
    on the same arguments ``(zx, rw, h0, c0, peephole, mask)``, with the
    training saves where ``save``: a thunk launching it, and its
    outputs (out, hT, cT)."""
    import ctypes
    lib = parent_lstm_library(parent)
    zx, rw, h0, c0, peep, mask = args
    t, n, h4 = zx.shape
    h = h4 // 4
    bf16 = zx.dtype == torch.bfloat16
    plan = (ctypes.c_int * 7)()
    err = lib.dl4j_lstm_plan(n, h, int(bf16), 0, plan)
    if err:
        raise RuntimeError(f"the parent's LSTM plan: CUDA error {err}")
    dt, f32 = zx.dtype, torch.float32
    outs = (torch.empty((t, n, h), dtype=dt, device=device),
            torch.empty((n, h), dtype=dt, device=device),
            torch.empty((n, h), dtype=dt, device=device))
    hbuf = torch.empty((2, n, h), dtype=dt, device=device)
    cbuf = torch.empty((n, h), dtype=f32, device=device)
    saves = (torch.empty((t, n, 4 * h), dtype=f32, device=device),
             torch.empty((t, n, h), dtype=f32, device=device)) if save \
        else (None, None)
    sync = torch.zeros(2, dtype=torch.int32, device=device)
    fn = lib.dl4j_lstm_fwd_bf16 if bf16 else lib.dl4j_lstm_fwd_f32

    def ptr(x):
        return None if x is None else x.data_ptr()

    def old():
        e = fn(zx.data_ptr(), rw.data_ptr(), h0.data_ptr(), c0.data_ptr(),
               ptr(peep), ptr(mask), *(o.data_ptr() for o in outs),
               hbuf.data_ptr(), cbuf.data_ptr(), ptr(saves[0]),
               ptr(saves[1]), sync.data_ptr(), t, n, h, plan[0], plan[4],
               plan[5], torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"the parent's LSTM forward: CUDA error {e}")

    return old, outs


def parent_lstm_library(parent):
    """The parent checkout's LSTM library: its plan and its cooperative
    forward and backward entry points (one argument list each)."""
    import ctypes
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    args = [p_] * 14 + [i_] * 6 + [p_]
    return parent_library(parent, "lstm", "nn/layers/csrc/lstm.cu", {
        "dl4j_lstm_plan": [i_] * 4 + [ctypes.POINTER(ctypes.c_int)],
        **{f"dl4j_lstm_{kind}_{dt}": args for kind in ("fwd", "bwd")
           for dt in ("f32", "bf16")}})


def parent_lstm_bwd(parent, bwd_args, device):
    """The parent checkout's backward (the cooperative kernel at every H)
    on the same arguments: a thunk launching it, and its outputs."""
    import ctypes
    lib = parent_lstm_library(parent)
    gates, c, c0, rw, peep, dout, dh_t, dc_t = bwd_args
    t, n, h = c.shape
    bf16 = dout.dtype == torch.bfloat16
    plan = (ctypes.c_int * 7)()
    err = lib.dl4j_lstm_plan(n, h, int(bf16), 1, plan)
    if err:
        raise RuntimeError(f"the parent's LSTM plan: CUDA error {err}")
    dt, f32 = dout.dtype, torch.float32
    outs = (torch.empty((t, n, 4 * h), dtype=dt, device=device),
            torch.empty((n, h), dtype=dt, device=device),
            torch.empty((n, h), dtype=dt, device=device))
    dgbuf = torch.empty((2, n, 4 * h), dtype=f32, device=device)
    dcbuf = torch.empty((n, h), dtype=f32, device=device)
    sync = torch.zeros(2, dtype=torch.int32, device=device)
    fn = lib.dl4j_lstm_bwd_bf16 if bf16 else lib.dl4j_lstm_bwd_f32

    def old():
        e = fn(gates.data_ptr(), c.data_ptr(), c0.data_ptr(), rw.data_ptr(),
               None if peep is None else peep.data_ptr(), dout.data_ptr(),
               dh_t.data_ptr(), dc_t.data_ptr(), *(o.data_ptr()
                                                   for o in outs),
               dgbuf.data_ptr(), dcbuf.data_ptr(), sync.data_ptr(), t, n, h,
               plan[0], plan[4], plan[5],
               torch.cuda.current_stream().cuda_stream)
        if e:
            raise RuntimeError(f"the parent's LSTM backward: CUDA error {e}")

    return old, outs


def cluster_row_tiles(bwd_args, device):
    """The bf16 cluster backward at both row tiles a block (16 and 32
    rows: the plan takes the one whose clusters the card runs in fewer
    waves), each with its clusters, shared memory and time, launched
    past the wrapper (its count untouched)."""
    import ctypes

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    lib = lk._LIBRARY.load()
    gates, c, c0, rw, peep, dout, dh_t, dc_t = bwd_args
    t, n, h = c.shape
    outs = [torch.empty((t, n, 4 * h), dtype=dout.dtype, device=device),
            torch.empty((n, h), dtype=dout.dtype, device=device),
            torch.empty((n, h), dtype=dout.dtype, device=device)]
    rec = {}
    for mt in (1, 2):
        def call(mt=mt):
            e = lib.dl4j_lstm_bwd_cluster_bf16(
                gates.data_ptr(), c.data_ptr(), c0.data_ptr(), rw.data_ptr(),
                None if peep is None else peep.data_ptr(), dout.data_ptr(),
                dh_t.data_ptr(), dc_t.data_ptr(),
                *(o.data_ptr() for o in outs), t, n, h, mt,
                torch.cuda.current_stream().cuda_stream)
            if e:
                raise RuntimeError(f"cluster backward at mt {mt}: CUDA "
                                   f"error {e}")
        plan = lk._lstm_bwd_cluster_plan(n, h, dout.dtype, mt)
        rec[f"rows_{plan.rows}"] = {"clusters": plan.batch_tiles,
                                    "smem": plan.smem,
                                    "ms": median_ms(call, device, iters=10)}
    return rec


def lstm_sass():
    """The LSTM library's SASS: the bf16 cluster kernels (the forward's
    and the backward's) hold HMMA.16816.F32.BF16, the f32 cluster
    kernels and the cooperative kernels (forward and backward) none;
    each cluster function's registers and spills (none may spill)."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    counts, tool = sass_hmma(lk._LIBRARY)
    tc = {f: n for f, n in counts.items()
          if "cluster_kernelI13__nv_bfloat16" in f}
    rest = {f: n for f, n in counts.items() if f not in tc}
    rec = {"tool": tool, "hmma_16816_f32_bf16": {"cluster_bf16": tc,
                                                  "others": rest},
           "ptxas": ptxas_usage(lk._LIBRARY, "cluster_kernel")}
    bad = [f for f, n in tc.items() if n == 0] + \
        [f for f, n in rest.items() if n != 0]
    for kind in ("lstm_fwd_cluster_kernel", "lstm_bwd_cluster_kernel"):
        if not any(kind in f for f in tc):
            bad.append(f"no bf16 {kind} found")
    bad += spilling(rec["ptxas"])
    log("lstm sass:", json.dumps(rec))
    if bad:
        raise AssertionError(f"lstm sass: HMMA.16816.F32.BF16 counts off "
                             f"or spills in {bad}: {counts}")
    return rec


def lstm_bounds(t, n, h, dtype, exp_rate, peep):
    """Least time on this card, as (ms, by), for the inference forward,
    the training forward (its f32 saves written too) and the backward:
    the bytes each must move over the memory rate, its multiply-adds
    (2 T N H 4H) over the dtype's peak, its exponentials (sigmoid, tanh:
    5 T N H forward, T N H backward) over the SFU's rate; the largest."""
    el = 2 if dtype == torch.bfloat16 else 4
    p = 3 * h * el if peep else 0
    io = (h * 4 * h + 2 * n * h) * el + p
    fwd = (t * n * 4 * h + t * n * h + 2 * n * h) * el + io
    saves = t * n * 5 * h * 4
    bwd = saves + (t * n * h + t * n * 4 * h + 4 * n * h) * el + io
    flops = 2 * t * n * h * 4 * h
    out = {}
    for kind, nbytes, exps in (("fwd", fwd, 5 * t * n * h),
                               ("fwd_train", fwd + saves, 5 * t * n * h),
                               ("bwd", bwd, t * n * h)):
        times = {"bytes": nbytes / HBM_BYTES_PER_S,
                 "operations": flops / PEAK_FLOPS[dtype],
                 "exponentials": exps / exp_rate}
        by = max(times, key=times.get)
        out[kind] = (1e3 * times[by], by)
    return out


def cudnn_lstm_fns(t, n, h, dtype, device, seed):
    """cuDNN's LSTM (``torch.nn.LSTM``, no peepholes) on x [T, N, H]
    (the second layer's input width): (its forward, its backward alone
    -- ``autograd.grad`` over a retained forward --, the port's projection
    plus forward kernel on the same x and weights)."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    gen = torch.Generator().manual_seed(seed)
    lstm = torch.nn.LSTM(h, h).to(device, dtype)
    lstm.flatten_parameters()
    x = (0.5 * torch.randn((t, n, h), generator=gen)).to(device, dtype)
    # cuDNN's gate order is (i, f, g, o), the port's (i, f, c, o): the same
    w = lstm.weight_ih_l0.detach().t().contiguous()
    rw = lstm.weight_hh_l0.detach().t().contiguous()
    b = (lstm.bias_ih_l0 + lstm.bias_hh_l0).detach()
    z0 = torch.zeros((n, h), dtype=dtype, device=device)
    xg = x.detach().clone().requires_grad_()
    y = lstm(xg)[0]
    dy = torch.randn(y.shape, generator=gen).to(device, dtype)
    params = [xg, *lstm.parameters()]

    def fwd():
        with torch.no_grad():
            return lstm(x)

    def port():
        zx = (x.reshape(t * n, h) @ w).reshape(t, n, 4 * h) + b
        return lk.lstm_forward(zx, rw, z0, z0)

    return (fwd, lambda: torch.autograd.grad(y, params, dy,
                                             retain_graph=True), port)


def lstm_case(name, t, n, h, dtype, device, seed, exp_rate, peep=True,
              mask=False, timed=False, parent=None):
    """One shape: the forward kernel against its plain version (out, hT,
    cT, and without a mask the saved gates and c), the backward kernel
    against its plain version on the plain forward's saves (dzx, dh0,
    dc0), each by row and 64-row tile; two backward launches bitwise
    equal, and two forward launches; with a mask the masked outputs
    exactly 0 and the fully masked row's hT, cT exactly h0, c0; the
    planted faults beyond the limits. ``timed``: the kernels', plain
    versions' and cuDNN's times beside the bounds, and with a parent
    checkout its forward (inference and training) and backward in turns
    with this one's. Each kernel's route, the device kernel one call
    starts (which must be that route's) and the backward's planted
    faults (LSTM_BWD_FAULTS) are recorded."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    a = lstm_inputs(t, n, h, dtype, device, seed, peep, mask)
    args = (a["zx"], a["rw"], a["h0"], a["c0"], a["peephole"], a["mask"])
    save = not mask
    before = lstm_fwd_launches()
    got = lk.lstm_forward(*args, save=save)
    torch.cuda.synchronize()
    ran_fwd = [x - y for x, y in zip(lstm_fwd_launches(), before)]
    again_fwd = lk.lstm_forward(*args, save=save)
    ref = lk.lstm_forward_plain(*args, save=save)
    torch.cuda.synchronize()
    case = {"case": name, "dtype": str(dtype).split(".")[-1], "t": t,
            "n": n, "h": h, "peephole": peep, "mask": mask,
            "fwd_route": lk.lstm_fwd_route(n, h, dtype),
            "fwd_device_kernels": {"lstm_fwd_kernel": ran_fwd[0],
                                   "lstm_fwd_cluster_kernel": ran_fwd[1]},
            "plan": lk.lstm_plan(n, h, dtype, device=device),
            "plan_bwd": lk.lstm_plan(n, h, dtype, bwd=True, device=device)}
    limits = lstm_limits(dtype, t)
    failures = []
    if ran_fwd != ([0, 1] if case["fwd_route"] == lk.CLUSTER else [1, 0]) \
            or case["plan"]["route"] != case["fwd_route"]:
        failures.append(f"forward route {case['fwd_route']} launched "
                        f"{ran_fwd}")
    case["fwd_bitwise_repeat"] = all(
        torch.equal(u, v) for u, v in zip(
            [*got[:3], *(got[3] or ())], [*again_fwd[:3],
                                          *(again_fwd[3] or ())]))
    if not case["fwd_bitwise_repeat"]:
        failures.append("two forward launches differ")
    del again_fwd
    outs = {"out": (got[0], ref[0]), "hT": (got[1], ref[1]),
            "cT": (got[2], ref[2])}
    if save:
        outs.update(gates=(got[3][0], ref[3][0]), c=(got[3][1], ref[3][1]))
        sv = ref[3]
        bwd_args = (sv[0], sv[1], a["c0"], a["rw"], a["peephole"], a["dout"],
                    a["dh"], a["dc"])
        before = lstm_bwd_launches()
        bg = lk.lstm_backward(*bwd_args)
        torch.cuda.synchronize()
        ran = [x - y for x, y in zip(lstm_bwd_launches(), before)]
        case["bwd_route"] = lk.lstm_bwd_route(n, h, dtype)
        case["bwd_device_kernels"] = {"lstm_bwd_kernel": ran[0],
                                      "lstm_bwd_cluster_kernel": ran[1]}
        if ran != ([0, 1] if case["bwd_route"] == lk.CLUSTER else [1, 0]) \
                or case["plan_bwd"]["route"] != case["bwd_route"]:
            failures.append(f"route {case['bwd_route']} launched {ran}")
        again = lk.lstm_backward(*bwd_args)
        br = lk.lstm_backward_plain(*bwd_args)
        torch.cuda.synchronize()
        case["bitwise_repeat"] = all(torch.equal(u, v)
                                     for u, v in zip(bg, again))
        if not case["bitwise_repeat"]:
            failures.append("two backward launches differ")
        outs.update(dzx=(bg[0], br[0]), dh0=(bg[1], br[1]),
                    dc0=(bg[2], br[2]))
        case["planted_bwd"] = {}
        for fault in LSTM_BWD_FAULTS:
            if fault == "dc_no_peep" and not peep:
                continue
            bad = lstm_fault_backward(*bwd_args, fault)
            reads = {key: conv_agreement(b_, g_)
                     for key, b_, g_ in zip(("dzx", "dh0", "dc0"), bad, bg)}
            told = any(r[0] > limits["row_rel"] or r[1] > limits["tile_rel"]
                       for r in reads.values())
            held = fault == "dc_no_peep" or dtype == torch.float32
            case["planted_bwd"][fault] = {"readings": reads, "told": told,
                                          "held": held}
            if held and not told:
                failures.append(f"the limits do not tell {fault}")
            del bad
    finite = all(bool(torch.isfinite(g_).all()) for g_, _ in outs.values())
    for key, (g_, r_) in outs.items():
        row_rel, tile_rel = conv_agreement(g_, r_)
        case[key] = {"max_abs_err": float((g_.float() - r_.float()).abs()
                                          .max()),
                     "row_rel": row_rel, "tile_rel": tile_rel}
        if row_rel > limits["row_rel"] or tile_rel > limits["tile_rel"]:
            failures.append(key)
    if mask:
        m = a["mask"]
        case["masked_out_zero"] = bool((got[0][m == 0] == 0).all())
        case["masked_row_carry_exact"] = bool(
            torch.equal(got[1][1], a["h0"][1])
            and torch.equal(got[2][1], a["c0"][1]))
        if not (case["masked_out_zero"] and case["masked_row_carry_exact"]):
            failures.append("masked steps")
    case["max_abs_err"] = case["out"]["max_abs_err"]
    case["limits"] = limits
    faults = ([] if not peep else ["po_on_c_prev"]) + \
        (["no_mask_blend_c"] if mask else []) + \
        (["unrounded_carry"] if dtype == torch.bfloat16 else []) + \
        (["stale_peer"] if case["fwd_route"] == lk.CLUSTER
         and case["plan"]["cluster"] > 1 else [])
    case["planted"] = {}
    for fault in faults:
        bad = lstm_fault_forward(a, fault)
        rel = conv_agreement(bad, got[0])
        case["planted"][fault] = rel
        # a carry crosses a step only for T > 1
        held = fault != "unrounded_carry" or (
            limits["span"] == "short" and t > 1)
        if held and rel[0] <= limits["row_rel"] and \
                rel[1] <= limits["tile_rel"]:
            failures.append(f"the limits do not tell {fault}")
    log("lstm check", json.dumps(case))
    if not finite or failures:
        raise AssertionError(f"lstm kernels disagree with their plain "
                             f"versions ({failures}, finite {finite}): "
                             f"{case}")
    if timed:
        bounds = lstm_bounds(t, n, h, dtype, exp_rate, peep)
        cfwd, cbwd, port = cudnn_lstm_fns(t, n, h, dtype, device, seed + 1)
        plain_iters = 3 if t > 32 else 10
        fwd = lambda: lk.lstm_forward(*args)
        rows = {
            "fwd": (fwd, lambda: lk.lstm_forward_plain(*args), cfwd),
            "fwd_train": (lambda: lk.lstm_forward(*args, save=True),
                          lambda: lk.lstm_forward_plain(*args, save=True),
                          None),
            "bwd": (lambda: lk.lstm_backward(*bwd_args),
                    lambda: lk.lstm_backward_plain(*bwd_args), cbwd)}
        for kind, (kern, plain, library) in rows.items():
            ms = median_ms(kern, device, iters=10)
            case[kind] = {
                "ms": ms, "ms_per_step": ms / t,
                "plain_ms": median_ms(plain, device, iters=plain_iters,
                                      warm=1),
                "library_ms": (median_ms(library, device, iters=10)
                               if library is not None else None),
                "bound_ms": bounds[kind][0], "bound_by": bounds[kind][1]}
        case["fwd"]["projection_plus_kernel_ms"] = median_ms(port, device,
                                                             iters=10)
        if case["bwd_route"] == lk.CLUSTER and dtype == torch.bfloat16:
            case["bwd"]["row_tiles"] = cluster_row_tiles(bwd_args, device)
        if parent:
            for kind, train in (("fwd", False), ("fwd_train", True)):
                old, pouts = parent_lstm_fwd(parent, args, train, device)
                old()
                torch.cuda.synchronize()
                case[kind]["parent"] = {
                    **in_turns(old, rows[kind][0], device, iters=10),
                    "parent_max_abs_err": max(
                        float((u.float() - v.float()).abs().max())
                        for u, v in zip(pouts, ref[:3]))}
                del pouts
        if parent and save:
            old, pouts = parent_lstm_bwd(parent, bwd_args, device)
            old()
            torch.cuda.synchronize()
            case["bwd"]["parent"] = {
                **in_turns(old, rows["bwd"][0], device, iters=10),
                "parent_max_abs_err": max(
                    float((u.float() - v.float()).abs().max())
                    for u, v in zip(pouts, br))}
            del pouts
        case["library"] = ("torch.nn.LSTM (cuDNN, no peepholes; input "
                           "width H, its own projection inside): forward; "
                           "backward alone (autograd.grad over a retained "
                           "forward)")
        log("lstm", json.dumps(case))
    del a, got, ref, outs
    torch.cuda.empty_cache()
    return case


def check_lstm_kernels(device, exp_rate, parent=None):
    """The LSTM library's SASS; the recurrence kernels at the text LSTM's
    shape (T = N = H = 256, timed, with a parent checkout its forward and
    backward in turns), without peepholes (timed, against cuDNN's LSTM),
    at the decode shape (N = T = 1, timed, with a parent checkout in
    turns), with a mask, at an H that splits unevenly (200), short (T =
    8), and at the smallest H whose kernels take the cooperative route
    (512; N = 64, T = 4: over 32 steps the
    bf16 forward's one-ulp flips at this H reach 1.4e-4 in the tiles,
    past the short limit), in bf16 and f32;
    then reverse through ``lstm_scan`` in f32 (the wrapper's flips of
    zx, the mask and the outputs: no kernel code of their own; in bf16
    its gradients, products over 4H columns of the backward's recurrence
    noise, read up to 8.6e-4 in the tiles, which would blur the
    check)."""
    sass = lstm_sass()
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, t, n, h, kw) in enumerate((
                ("main", 256, 256, 256, dict(timed=True, parent=parent)),
                ("main_nopeep", 256, 256, 256, dict(peep=False, timed=True)),
                ("decode", 1, 1, 256, dict(timed=True, parent=parent)),
                ("mask", 32, 64, 256, dict(mask=True)),
                ("uneven", 32, 256, 200, {}),
                ("short", 8, 256, 256, {}),
                ("cooperative", 4, 64, 512, {}))):
            cases.append(lstm_case(name, t, n, h, dtype, device, 60 + i,
                                   exp_rate, **kw))
    coop = [c for c in cases if c["case"] == "cooperative"]
    if any(c["bwd_route"] != "cooperative" or c["fwd_route"] != "cooperative"
           for c in coop):
        raise AssertionError(f"H = 512 did not take the cooperative route: "
                             f"{[(c['plan'], c['plan_bwd']) for c in coop]}")
    cases.append(lstm_reverse_case(torch.float32, device))
    return {"cases": cases, "sass": sass}


def lstm_swapped():
    """The recurrence kernels' wrappers swapped for their plain versions
    (for ``with_swaps``)."""
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    return [(vars(lk), {"lstm_forward": lk.lstm_forward_plain,
                        "lstm_backward": lk.lstm_backward_plain})]


def lstm_reverse_case(dtype, device, t=32, n=64, c=128, h=256):
    """``lstm_scan(reverse=True)`` with peepholes: the masked forward,
    then the unmasked forward and the gradients of x, W, RW, b and P
    (autograd through the kernels), against the same with the plain
    versions swapped in, by row and tile."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_scan
    gen = torch.Generator().manual_seed(70)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).to(device, dtype)

    x = randn(n, c, t)
    w, rw = randn(c, 4 * h, scale=c ** -0.5), randn(h, 4 * h, scale=h ** -0.5)
    b, p = randn(4 * h, scale=0.1), randn(3, h, scale=0.3)
    m = (torch.rand((n, t), generator=gen) > 0.25).float().to(device)
    dy = randn(n, h, t)

    def run():
        with torch.no_grad():
            masked = lstm_scan(x, w, rw, b, peephole=p, mask=m,
                               reverse=True)[0]
        leaves = [v.detach().clone().requires_grad_()
                  for v in (x, w, rw, b, p)]
        out = lstm_scan(*leaves[:4], peephole=leaves[4], reverse=True)[0]
        grads = torch.autograd.grad(out, leaves, dy)
        return [masked, out.detach(), *grads]

    got, ref = run(), with_swaps(lstm_swapped(), run)
    torch.cuda.synchronize()
    case = {"case": "reverse", "dtype": str(dtype).split(".")[-1], "t": t,
            "n": n, "c": c, "h": h}
    limits = lstm_limits(dtype, t)
    failures = []
    for key, g_, r_ in zip(("masked_out", "out", "dx", "dW", "dRW", "db",
                            "dP"), got, ref):
        g2, r2 = (v.reshape(-1, v.shape[-1]) if v.dim() > 1
                  else v.reshape(1, -1) for v in (g_, r_))
        row_rel, tile_rel = conv_agreement(g2, r2)
        case[key] = {"max_abs_err": float((g_.float() - r_.float()).abs()
                                          .max()),
                     "row_rel": row_rel, "tile_rel": tile_rel}
        if row_rel > limits["row_rel"] or tile_rel > limits["tile_rel"]:
            failures.append(key)
    case["max_abs_err"] = case["out"]["max_abs_err"]
    case["limits"] = limits
    log("lstm check", json.dumps(case))
    if failures:
        raise AssertionError(f"lstm_scan(reverse=True) with the kernels "
                             f"disagrees with the plain versions "
                             f"({failures}): {case}")
    return case


def text_lstm_net(device, dtype, t=LSTM_T):
    """bench_all.py's bench_lstm model: TextGenerationLSTM(vocab 128,
    max_length t, RmsProp(1e-3)) -- 2 GravesLSTM layers of 256, an
    RnnOutputLayer softmax over 128, tBPTT in chunks of t -- random
    weights from the conf seed, in ``dtype``."""
    from deeplearning4j_tpu_torch.nn.updater import RmsProp
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    net = TextGenerationLSTM(vocab_size=LSTM_VOCAB, max_length=t,
                             updater=RmsProp(1e-3)).init(device=device)
    net.conf.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return net


def text_batch(b, t, seed=0):
    """bench_lstm's batch: one-hot [B, V, T] of ids from default_rng(seed)
    and the labels rolled by one position."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LSTM_VOCAB, (b, t))
    x = np.zeros((b, LSTM_VOCAB, t), np.float32)
    x[np.arange(b)[:, None], ids, np.arange(t)[None, :]] = 1.0
    return x, np.roll(x, -1, axis=2)


def lstm_counts():
    c = read_counts()
    return {"lstm_fwd": c["lstm_fwd"], "lstm_bwd": c["lstm_bwd"]}


def text_lstm(device):
    """The text LSTM's three paths at full width in bf16: ``output()``
    (2 forward launches, probabilities finite with rows summing to 1, ms
    per forward), ``sample_stream`` (32-token prompt, 256 new tokens, 2
    launches a decode step, tokens/s; the streamed probabilities of the
    sampled ids against one-shot ``output()`` of each prefix), ``fit``
    (a warm-up step, then LSTM_STEPS timed steps, each ending in a host
    read of the loss: finite and falling, 2 + 2 launches a step, ms per
    step, tokens/s, peak memory; one profiled step)."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    rec, failures = {}, []
    net = text_lstm_net(device, torch.bfloat16)
    x, y = text_batch(LSTM_B, LSTM_T)
    # inference
    net.output(x[:2])
    zero_counts()
    out_s, probs = output_s(net, x)
    counts = lstm_counts()
    times = [output_s(net, x)[0] for _ in range(4)] + [out_s]
    sums = probs.sum(dim=1)
    inf = {"output_ms_median": 1e3 * float(np.median(times)),
           "output_ms": [1e3 * v for v in times], "launches": counts,
           "row_sum_max_err": float((sums - 1).abs().max())}
    if tuple(probs.shape) != (LSTM_B, LSTM_VOCAB, LSTM_T) or \
            not bool(torch.isfinite(probs).all()) or \
            inf["row_sum_max_err"] > RESNET_ROW_SUM:
        failures.append("probabilities not finite, misshapen or not "
                        "summing to 1")
    if counts != {"lstm_fwd": LSTM_LAYERS, "lstm_bwd": 0}:
        failures.append(f"output() launched {counts}")
    rec["inference"] = inf
    log("text_lstm output:", json.dumps(inf))
    # streaming generation
    model = TextGenerationLSTM(vocab_size=LSTM_VOCAB, max_length=LSTM_T)
    prompt = np.random.default_rng(1).integers(0, LSTM_VOCAB,
                                               LSTM_PROMPT).tolist()
    model.sample_stream(net, prompt, 4, rng=np.random.default_rng(2))
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = model.sample_stream(net, prompt, LSTM_NEW,
                              rng=np.random.default_rng(2))
    gen_s = time.perf_counter() - t0
    counts = lstm_counts()
    stream = {"tokens": len(ids) - LSTM_PROMPT, "seconds": gen_s,
              "tokens_per_s": (len(ids) - LSTM_PROMPT) / gen_s,
              "ms_per_token": 1e3 * gen_s / (len(ids) - LSTM_PROMPT),
              "launches": counts}
    # one dispatch primes the prompt, one per later token
    want = LSTM_LAYERS * (len(ids) - LSTM_PROMPT)
    if counts != {"lstm_fwd": want, "lstm_bwd": 0}:
        failures.append(f"sample_stream launched {counts}, not {want} "
                        f"forward launches")
    stream.update(stream_against_one_shot(net, ids))
    lim = lstm_limits(torch.bfloat16, len(ids))
    if not stream["probs_bitwise"] and (stream["row_rel"] > lim["row_rel"]
                                        or stream["tile_rel"]
                                        > lim["tile_rel"]):
        failures.append("streamed probabilities part from one-shot "
                        "output()'s")
    rec["stream"] = stream
    log("text_lstm stream:", json.dumps(stream))
    # training
    net.rnn_clear_previous_state()
    fit_s(net, x, y, None)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    steps = [fit_s(net, x, y, None) for _ in range(LSTM_STEPS)]
    counts = lstm_counts()
    losses = [l for _, l in steps]
    ms = [1e3 * s for s, _ in steps]
    train = {"step_ms": ms, "step_ms_median": float(np.median(ms)),
             "tokens_per_s": LSTM_B * LSTM_T / (float(np.median(ms)) / 1e3),
             "losses": losses, "launches": counts,
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"the losses do not fall: {losses}")
    want = {"lstm_fwd": LSTM_LAYERS * LSTM_STEPS,
            "lstm_bwd": LSTM_LAYERS * LSTM_STEPS}
    if counts != want:
        failures.append(f"fit launched {counts}, not {want}")
    prof, share = profile_fit_step(net, x, y, None)
    prof["lstm_kernels_share_of_device_time"] = share(
        "lstm_fwd_kernel", "lstm_bwd_kernel", "lstm_fwd_cluster_kernel",
        "lstm_bwd_cluster_kernel")
    train["profile"] = prof
    rec["train"] = train
    log("text_lstm train:", json.dumps(train))
    if failures:
        raise AssertionError(f"text_lstm: {failures}: {rec}")
    return rec


def stream_against_one_shot(net, ids):
    """The next-token probabilities of the sampled ids, streamed (the
    prompt in one chunk, then one token a call) against one-shot
    ``output()`` of the whole sequence, column by column: bitwise equal
    or not, and their agreement by row (one position's distribution) and
    tile."""
    from deeplearning4j_tpu_torch.util.decoding import _one_hot
    x = _one_hot(net, [ids])
    net.rnn_clear_previous_state()
    cols = [net.rnn_time_step(x[:, :, :LSTM_PROMPT])]
    for k in range(LSTM_PROMPT, len(ids)):
        cols.append(net.rnn_time_step(x[:, :, k:k + 1]))
    streamed = torch.cat(cols, dim=2)[0].t().cpu()       # [T, V]
    one_shot = net.output(x)[0].t().cpu()
    row_rel, tile_rel = conv_agreement(streamed, one_shot)
    net.rnn_clear_previous_state()
    return {"probs_bitwise": bool(torch.equal(streamed, one_shot)),
            "positions_differing": int((streamed != one_shot).any(dim=1)
                                       .sum()),
            "max_abs_err": float((streamed - one_shot).abs().max()),
            "row_rel": row_rel, "tile_rel": tile_rel}


#: the serializer phase: a restored net's next fit step's loss against
#: the original's (the same bits in, the same kernels: a difference is a
#: fault in what the archive carried), and the transformer fixture's
#: output against its recorded output (tests/test_regression_formats.py's
#: OUT_ATOL: the fixture was recorded by the JAX package on a CPU)
SERIALIZER_LOSS_REL = 1e-6
SERIALIZER_FIXTURE_ATOL = 5e-3


def serializer(device):
    """The port's model archives on the card. The text LSTM at
    bench_lstm's widths (bf16) after one fit step: ``write_model`` to a
    temporary directory, ``restore_model`` onto the card; the restored
    parameters and updater state bitwise equal to the original's, its
    ``output()`` bitwise equal, and one more fit step from each with
    losses within SERIALIZER_LOSS_REL. Then ``regression_tfm_v1.zip``
    (the JAX package's archive of a 2-layer transformer) restored onto
    the card: its output within SERIALIZER_FIXTURE_ATOL of the fixture's
    ``_output.npy``, with the flash forward kernel's launches."""
    import os
    import tempfile

    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    rec, failures = {}, []
    net = text_lstm_net(device, torch.bfloat16)
    x, y = text_batch(LSTM_B, LSTM_T)
    fit_s(net, x, y, None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "text_lstm.zip")
        t0 = time.perf_counter()
        write_model(net, path)
        rec["write_s"] = time.perf_counter() - t0
        rec["archive_bytes"] = os.path.getsize(path)
        t0 = time.perf_counter()
        back = restore_model(path, device=device)
        rec["restore_s"] = time.perf_counter() - t0
    rec["restored"] = {"type": type(back).__name__,
                       "device": str(next(iter(back.params["0"].values()))
                                     .device),
                       "dtype": back.conf.dtype,
                       "iteration_count": back.iteration_count}
    same = {name: len(tree_leaves(a)) == len(tree_leaves(b)) and all(
                torch.equal(u, v)
                for u, v in zip(tree_leaves(a), tree_leaves(b)))
            for name, a, b in (("params", net.params, back.params),
                               ("updater_state", net.updater_state,
                                back.updater_state))}
    rec["bitwise"] = same
    out_a, out_b = net.output(x), back.output(x)
    rec["bitwise"]["output"] = bool(torch.equal(out_a, out_b))
    _, loss_a = fit_s(net, x, y, None)
    _, loss_b = fit_s(back, x, y, None)
    rec["next_step_losses"] = [loss_a, loss_b]
    rec["next_step_loss_rel"] = abs(loss_a - loss_b) / abs(loss_a)
    rec["limits"] = {"next_step_loss_rel": SERIALIZER_LOSS_REL,
                     "fixture_max_abs_err": SERIALIZER_FIXTURE_ATOL}
    log("serializer text_lstm:", json.dumps(rec))
    if not all(rec["bitwise"].values()):
        failures.append(f"the restored text LSTM is not the written one: "
                        f"{rec['bitwise']}")
    if rec["restored"]["device"] == "cpu" or rec["restored"]["dtype"] != \
            "bfloat16":
        failures.append(f"restored as {rec['restored']}")
    if not rec["next_step_loss_rel"] <= SERIALIZER_LOSS_REL:
        failures.append("the next fit step's losses part")
    del net, back, out_a, out_b
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures")
    tnet = restore_model(os.path.join(fix, "regression_tfm_v1.zip"),
                         device=device)
    xin = np.load(os.path.join(fix, "regression_tfm_v1_input.npy"))
    want = np.load(os.path.join(fix, "regression_tfm_v1_output.npy"))
    zero_counts()
    got = tnet.output(xin)
    got = (got[0] if isinstance(got, (list, tuple)) else got).float().cpu()
    counts = read_counts()
    tfm = {"type": type(tnet).__name__, "shape": list(got.shape),
           "max_abs_err": float(np.abs(got.numpy() - want).max()),
           "launches": {k: v for k, v in counts.items() if v},
           "updater_t": int(tnet.updater_state["t"])}
    rec["regression_tfm_v1"] = tfm
    log("serializer regression_tfm_v1:", json.dumps(tfm))
    if list(got.shape) != list(want.shape) or \
            not tfm["max_abs_err"] <= SERIALIZER_FIXTURE_ATOL:
        failures.append("the transformer fixture's output")
    if not counts["flash_fwd"]:
        failures.append("the restored transformer ran no flash forward")
    if failures:
        raise AssertionError(f"serializer: {failures}: {rec}")
    return rec


def text_lstm_reference(device):
    """f32 at full width, T = LSTM_REF_T: ``output()`` and
    LSTM_REF_STEPS RmsProp fit steps with the kernels against the same
    with the plain versions swapped in (probabilities by row and tile;
    parameters and RmsProp's g2 by update_err, leaf by leaf), and a
    planted backward fault (the peephole gradient dropped, through the
    kernels) beyond the limit."""
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    x, y = text_batch(LSTM_B, LSTM_REF_T, seed=3)
    scan = recurrent.lstm_recurrence

    def no_dp(zx, rw, h0, c0, peephole=None, mask=None):
        return scan(zx, rw, h0, c0,
                    None if peephole is None else peephole.detach(), mask)

    def run(swaps):
        net = text_lstm_net(device, torch.float32, LSTM_REF_T)
        start = tree_numpy(net.params)

        def go():
            probs = net.output(x).cpu()
            for _ in range(LSTM_REF_STEPS):
                net.fit(x, y, batch_size=LSTM_B)
            return probs
        probs = with_swaps(swaps, go)
        res = (start, probs, tree_numpy(net.params),
               tree_numpy(net.updater_state))
        del net
        torch.cuda.empty_cache()
        return res

    start, probs, params, g2 = run(())
    _, pprobs, pparams, pg2 = run(lstm_swapped())
    _, _, fparams, _ = run([(vars(recurrent), {"lstm_recurrence": no_dp})])
    p_rel = conv_agreement(*(p.permute(0, 2, 1).reshape(-1, LSTM_VOCAB)
                             for p in (probs, pprobs)))
    rec = {"t": LSTM_REF_T, "steps": LSTM_REF_STEPS,
           "probs": {"row_rel": p_rel[0], "tile_rel": p_rel[1]},
           "params_vs_plain": update_err(params, pparams, start),
           "g2_vs_plain": update_err(g2, pg2, {"g2": {
               k: {n: np.zeros_like(v) for n, v in p.items()}
               for k, p in start.items()}}),
           "fault_no_dp": update_err(fparams, params, start),
           "limits": {**lstm_limits(torch.float32, LSTM_REF_T),
                      "update_err": LSTM_REF_LIMIT}}
    log("text_lstm reference:", json.dumps(rec))
    failures = []
    lim = lstm_limits(torch.float32, LSTM_REF_T)
    if p_rel[0] > lim["row_rel"] or p_rel[1] > lim["tile_rel"]:
        failures.append("the probabilities part from the plain versions'")
    if rec["params_vs_plain"][0] > LSTM_REF_LIMIT or \
            rec["g2_vs_plain"][0] > LSTM_REF_LIMIT:
        failures.append("two steps part from the plain versions'")
    if rec["fault_no_dp"][0] <= LSTM_REF_LIMIT:
        failures.append("the limit does not tell the dropped dP")
    if failures:
        raise AssertionError(f"text_lstm reference: {failures}: {rec}")
    return rec


def regularized_lstm_net(device, dtype, t=LSTM_T, seed=12345, tbptt=True):
    """bench_lstm's text LSTM (2 GravesLSTM of 256, vocab 128, tBPTT in
    chunks of ``t`` unless ``tbptt`` is off (then a [N, V, t] batch is
    one step of the same arithmetic, grouped by the fit loop),
    element-wise clipping at 1) with A1's training
    hooks: Dropout(0.9) on each LSTM's input, DropConnect(0.95) on the
    second LSTM's weights, MaxNormConstraint(REG_MAX_NORM) on each
    LSTM's weights, xavier_uniform weights, the output bias at 0.1,
    AdaMax(2e-3); random weights from ``seed``, its training generator
    from ``seed + 1``."""
    from deeplearning4j_tpu_torch.nn.conf.constraints import (
        MaxNormConstraint)
    from deeplearning4j_tpu_torch.nn.conf.dropout import DropConnect, Dropout
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import AdaMax
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(AdaMax(2e-3))
         .weight_init("xavier_uniform")
         .gradient_normalization("clipelementwiseabsolutevalue", 1.0)
         .list())
    for i in range(LSTM_LAYERS):
        b.layer(GravesLSTM(
            n_out=256, activation="tanh", dropout=Dropout(0.9),
            weight_noise=DropConnect(0.95) if i == 1 else None,
            constraints=[MaxNormConstraint(max_norm=REG_MAX_NORM)]))
    b.layer(RnnOutputLayer(n_out=LSTM_VOCAB, loss="mcxent",
                           activation="softmax", bias_init=0.1))
    b = b.set_input_type(InputType.recurrent(LSTM_VOCAB, t))
    conf = (b.tbptt(t) if tbptt else b).build()
    conf.dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return MultiLayerNetwork(conf).init(device=device)


def regularized_reference(device):
    """f32, T = LSTM_REF_T: REG_STEPS fit steps of the regularized net
    with the kernels and with their plain versions swapped in (the same
    generator seed, so the same masks): the losses within REG_LOSS_REL,
    the parameters and AdaMax's m and u by update_err within
    LSTM_REF_LIMIT; a run with another generator seed beyond it."""
    x, y = text_batch(LSTM_B, LSTM_REF_T, seed=5)

    def run(swaps, gen_seed=None):
        net = regularized_lstm_net(device, torch.float32, LSTM_REF_T)
        if gen_seed is not None:
            net._train_gen.manual_seed(gen_seed)
        start = tree_numpy(net.params)
        losses = with_swaps(swaps, lambda: [fit_s(net, x, y, None)[1]
                                            for _ in range(REG_STEPS)])
        res = (start, losses, tree_numpy(net.params),
               tree_numpy({k: net.updater_state[k] for k in ("m", "u")}))
        del net
        torch.cuda.empty_cache()
        return res

    start, losses, params, st = run(())
    _, plosses, pparams, pst = run(lstm_swapped())
    _, _, oparams, _ = run((), gen_seed=7)
    zeros = {k: {kk: {n: np.zeros_like(v) for n, v in p.items()}
                 for kk, p in start.items()} for k in ("m", "u")}
    rec = {"t": LSTM_REF_T, "steps": REG_STEPS, "losses": losses,
           "losses_plain": plosses,
           "loss_rel": max(abs(a - b) / abs(b)
                           for a, b in zip(losses, plosses)),
           "params_vs_plain": update_err(params, pparams, start),
           "adamax_vs_plain": update_err(st, pst, zeros),
           "other_masks": update_err(oparams, params, start),
           "limits": {"loss_rel": REG_LOSS_REL,
                      "update_err": LSTM_REF_LIMIT}}
    log("regularized_lstm reference:", json.dumps(rec))
    failures = []
    if rec["loss_rel"] > REG_LOSS_REL:
        failures.append("the losses part from the plain versions'")
    if rec["params_vs_plain"][0] > LSTM_REF_LIMIT or \
            rec["adamax_vs_plain"][0] > LSTM_REF_LIMIT:
        failures.append("the steps part from the plain versions'")
    if rec["other_masks"][0] <= LSTM_REF_LIMIT:
        failures.append("the limit does not tell other masks")
    return rec, failures


def regularized_scan(device):
    """A small hardsigmoid-gated GravesLSTM net (the scan route: no
    recurrence kernel) on the card against the same net on the CPU:
    output() and one Sgd fit step (no dropout) within REG_SCAN_TOL
    (AdaMax's first step, lr g / (|g| + eps), turns the f32 sums' order
    into 1e-5 of a parameter where a gradient is near 0)."""
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import Sgd

    def net_on(dev):
        conf = (NeuralNetConfiguration.Builder().seed(3)
                .updater(Sgd(0.1)).list()
                .layer(GravesLSTM(n_out=REG_SCAN_H,
                                  gate_activation="hardsigmoid"))
                .layer(RnnOutputLayer(n_out=LSTM_VOCAB, loss="mcxent",
                                      activation="softmax"))
                .set_input_type(InputType.recurrent(LSTM_VOCAB,
                                                    REG_SCAN_T)).build())
        return MultiLayerNetwork(conf).init(device=dev)

    x, y = text_batch(8, REG_SCAN_T, seed=6)
    card, cpu = net_on(device), net_on("cpu")
    zero_counts()
    runs = recurrent.LSTM_SCAN.runs
    out = card.output(x).cpu()
    card.fit(x, y, batch_size=8)
    loss = card.score_value
    counts = lstm_counts()
    rec = {"scan_runs": recurrent.LSTM_SCAN.runs - runs, "launches": counts,
           "output_max_abs_err": float((out - cpu.output(x)).abs().max())}
    cpu.fit(x, y, batch_size=8)
    rec["loss_rel"] = abs(loss - cpu.score_value) / abs(cpu.score_value)
    rec["params_max_abs_err"] = max(
        float((card.params[k][n].cpu() - cpu.params[k][n]).abs().max())
        for k in cpu.params for n in cpu.params[k])
    log("regularized_lstm scan route:", json.dumps(rec))
    failures = []
    if rec["scan_runs"] != 2 or counts != {"lstm_fwd": 0, "lstm_bwd": 0}:
        failures.append(f"the scan route: {rec['scan_runs']} runs, "
                        f"kernels {counts}")
    if max(rec["output_max_abs_err"], rec["loss_rel"],
           rec["params_max_abs_err"]) > REG_SCAN_TOL:
        failures.append("the card's scan parts from the CPU's")
    return rec, failures


class max_norm_clips:
    """A context in which MaxNormConstraint rescales as before and also
    counts the columns it rescales (norm over max_norm), a device tensor
    a call in ``.calls`` (read after the steps: no sync in them)."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.nn.conf.constraints import (
            MaxNormConstraint)
        self.cls, self.apply = MaxNormConstraint, MaxNormConstraint.apply
        self.calls = []

        def apply(con, w):
            self.calls.append((con._norm(w) > con.max_norm).sum())
            return self.apply(con, w)
        MaxNormConstraint.apply = apply
        return self

    def __exit__(self, *exc):
        self.cls.apply = self.apply


def regularized_lstm(device):
    """The text LSTM at full width (bench_lstm, bf16, B = T = 256) with
    A1's training hooks (:func:`regularized_lstm_net`): a warm-up fit
    step and REG_STEPS timed ones, each LSTM's kernels launched as in
    the text_lstm phase (2 + 2 a step) and the scan route never, the
    MaxNorm projection rescaling some columns in every step, the
    loss finite and falling; the net written and restored onto the card
    bitwise (parameters, AdaMax's m, u and t, output()); ms a step and
    peak memory against the unregularized text_lstm net in turns (a
    report); the f32 reference (:func:`regularized_reference`) and the
    scan route (:func:`regularized_scan`)."""
    import os
    import tempfile

    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.nn.updater import tree_leaves
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model, write_model)
    rec, failures = {}, []
    net = regularized_lstm_net(device, torch.bfloat16)
    norms = {f"{k}/{n}": torch.sqrt((w.float() ** 2).sum(0)).quantile(
                 torch.tensor([0.0, 0.5, 1.0], device=w.device)).tolist()
             for k, p in net.params.items() for n, w in p.items()
             if n in ("W", "RW") and k != str(LSTM_LAYERS)}
    x, y = text_batch(LSTM_B, LSTM_T)
    first = fit_s(net, x, y, None)[1]
    zero_counts()
    runs = recurrent.LSTM_SCAN.runs
    steps, marks = [], []
    with max_norm_clips() as clips:
        for _ in range(REG_STEPS):
            marks.append(len(clips.calls))
            steps.append(fit_s(net, x, y, None))
    counts = lstm_counts()
    marks.append(len(clips.calls))
    losses = [first] + [l for _, l in steps]
    train = {"step_ms": [1e3 * t for t, _ in steps], "losses": losses,
             "launches": counts,
             "scan_runs": recurrent.LSTM_SCAN.runs - runs,
             "max_norm": REG_MAX_NORM, "init_column_norms": norms,
             "clipped_columns": [sum(int(n) for n in clips.calls[a:b])
                                 for a, b in zip(marks, marks[1:])]}
    if not all(train["clipped_columns"]):
        failures.append(f"MaxNorm({REG_MAX_NORM}) rescaled no column in "
                        f"a step: {train['clipped_columns']}")
    want = {"lstm_fwd": LSTM_LAYERS * REG_STEPS,
            "lstm_bwd": LSTM_LAYERS * REG_STEPS}
    if counts != want or train["scan_runs"]:
        failures.append(f"fit launched {counts} (scan {train['scan_runs']})"
                        f", not {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"the losses do not fall: {losses}")
    rec["train"] = train
    log("regularized_lstm train:", json.dumps(train))
    # the archive: written after the steps, restored onto the card
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "regularized_lstm.zip")
        write_model(net, path)
        rec["archive_bytes"] = os.path.getsize(path)
        back = restore_model(path, device=device)
    same = {name: len(tree_leaves(a)) == len(tree_leaves(b)) and all(
                torch.equal(u, v)
                for u, v in zip(tree_leaves(a), tree_leaves(b)))
            for name, a, b in (("params", net.params, back.params),
                               ("adamax", net.updater_state,
                                back.updater_state))}
    same["output"] = bool(torch.equal(net.output(x), back.output(x)))
    same["conf"] = back.conf.to_dict() == net.conf.to_dict()
    rec["restored_bitwise"] = same
    if not all(same.values()):
        failures.append(f"the restored net is not the written one: {same}")
    del back
    # the step against the unregularized text LSTM, in turns
    plain_net = text_lstm_net(device, torch.bfloat16)
    fit_s(plain_net, x, y, None)
    turns = {"regularized": [], "text_lstm": [], "peak_bytes": {}}
    for name in ("regularized", "text_lstm", "text_lstm", "regularized"):
        n_ = net if name == "regularized" else plain_net
        torch.cuda.reset_peak_memory_stats()
        turns[name] += [1e3 * fit_s(n_, x, y, None)[0]
                        for _ in range(REG_STEPS)]
        turns["peak_bytes"][name] = torch.cuda.max_memory_allocated()
    turns["step_ms_median"] = {k: float(np.median(turns[k]))
                               for k in ("regularized", "text_lstm")}
    rec["turns"] = turns
    log("regularized_lstm turns (a report):", json.dumps(turns))
    del net, plain_net
    torch.cuda.empty_cache()
    rec["reference"], fails = regularized_reference(device)
    failures += fails
    rec["scan"], fails = regularized_scan(device)
    failures += fails
    if failures:
        raise AssertionError(f"regularized_lstm: {failures}: {rec}")
    return rec


def lstm_entry(name, replaces, launches, cases, text):
    """A recurrence kernel's entry of the kernels line: its numbers at the
    main path's shape (bf16, T = N = H = 256, peepholes) and every timed
    case's; the launches of the counted fit steps, and those of the
    other two paths."""
    kind = "fwd" if name == "lstm_fwd" else "bwd"
    main = next(c for c in cases if c["case"] == "main"
                and c["dtype"] == "bfloat16")
    errs = ("out", "hT", "cT") if kind == "fwd" else ("dzx", "dh0", "dc0")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/lstm.cu",
            "replaces": replaces, "launches": launches,
            **({} if kind == "fwd" else {
                "replaces_note": "the port's own kernel, no TPU twin: JAX's "
                                 "_lstm_bwd differentiates through a scan",
                "design": "redesigned: clusters of the unit tiles of a "
                          "batch tile exchange dgates through distributed "
                          "shared memory, one cluster barrier a step; bf16 "
                          "products on mma.sync over a three-term split",
                "bwd_route": main["bwd_route"],
                "functions": {"cluster": "cl::lstm_bwd_cluster_kernel<T> "
                                         "(H <= 256)",
                              "cooperative": "lstm_bwd_kernel<T> (H > 256)"},
                "plan_bwd": main["plan_bwd"],
                "planted_bwd": main["planted_bwd"],
                **({"parent": main["bwd"]["parent"]}
                   if "parent" in main["bwd"] else {}),
                "ms_f32": next(c["bwd"]["ms"] for c in cases
                               if c["case"] == "main"
                               and c["dtype"] == "float32")}),
            **({"design": "redesigned: clusters of the unit tiles of a "
                          "batch tile exchange h through distributed "
                          "shared memory, one cluster barrier a step; "
                          "bf16 products on mma.sync, each peer's K-slice "
                          "promoted in order",
                "fwd_route": main["fwd_route"],
                "functions": {"cluster": "cl::lstm_fwd_cluster_kernel<T> "
                                         "(H <= 256)",
                              "cooperative": "lstm_fwd_kernel<T> (H > 256)"},
                "plan": main["plan"], "planted": main["planted"],
                **({"parent": {k: main[k]["parent"]
                               for k in ("fwd", "fwd_train")}}
                   if "parent" in main["fwd"] else {}),
                **({"parent_decode": next(
                    c["fwd"]["parent"] for c in cases
                    if c["case"] == "decode" and c["dtype"] == "bfloat16")}
                   if any(c["case"] == "decode" and "parent" in c["fwd"]
                          for c in cases) else {}),
                "ms_f32": next(c["fwd"]["ms"] for c in cases
                               if c["case"] == "main"
                               and c["dtype"] == "float32")}
               if kind == "fwd" else {}),
            "launches_on": f"{LSTM_STEPS} fit steps of the text LSTM",
            "launches_output": text["inference"]["launches"][name],
            "launches_sample_stream": text["stream"]["launches"][name],
            "max_abs_err": max(main[k]["max_abs_err"] for k in errs),
            **{k: main[kind][k] for k in ("ms", "ms_per_step", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
            **({"ms_train_forward": main["fwd_train"]["ms"],
                "projection_plus_kernel_ms":
                    main["fwd"]["projection_plus_kernel_ms"]}
               if kind == "fwd" else {}),
            "library": main["library"], "dtype": main["dtype"],
            "limits": main["limits"],
            "cases": [{"case": c["case"], "dtype": c["dtype"],
                       **{k: c[k] for k in (kind, "plan", "plan_bwd")
                          if k in c},
                       **{k: c[k] for k in errs if k in c}}
                      for c in cases if "plan" in c]}


def cnn_entry(name, replaces, launches, cases, sweep):
    """A ResNet50 kernel's entry of the kernels line: its numbers at the
    main path's shape (the first bf16 case of the kernel), every case's,
    and for the bottleneck convs the sweep's launch-weighted times a
    forward."""
    mine = [c for c in cases if c["kernel"] == name]
    main = mine[0]
    keys = ("max_abs_err", "row_rel", "tile_rel", "sums_rel",
            "unrounded_tile_rel", "bitwise_repeat", "route", "planted",
            "nan_positions_equal", "bits_differ", "device_kernels", "plan",
            "parent")
    conv = name in sweep["per_forward"]
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/" + (
                "stem.cu" if name.startswith("stem") else "bottleneck.cu"),
            "replaces": replaces, "launches": launches,
            **({"design": "redesigned for the tensor cores (bf16: "
                          "mma.sync over conv_mma.cuh; f32: the CUDA "
                          "cores)"} if conv else {}),
            **({"design": "redesigned: a strip walk that reads y once (16-"
                          "byte loads, a warp 4 pooled columns by 8 pooled "
                          "rows), each window's raw NaN-propagating maximum "
                          "and minimum, relu(max(z(hi), z(lo))) exact for "
                          "every sign of sc",
                "functions": {"vector": "fwd_pool::fwd_pool_kernel<T, "
                                        "16 / sizeof(T)>",
                              "element": "fwd_pool::fwd_pool_kernel<T, 1>"},
                "nonfinite": {x: c.get(x) for c in mine
                              if c["case"] == "stem_pool_nonfinite"
                              and c["dtype"] == "bfloat16"
                              for x in ("nan_kernel", "nan_plain",
                                        "nan_positions_equal",
                                        "bits_differ", "parent")},
                **({"parent": main["parent"]} if "parent" in main else {})}
               if name == "stem_pool" else {}),
            **({"design": "redesigned for the tensor cores (bf16 at 4 C "
                          "<= 16: a 16-tap conv over the s2d halo tile, "
                          "mma.sync over conv_mma.cuh; f32 and wider "
                          "inputs: the CUDA-core implicit GEMM)",
                "core_route": main["route"],
                "functions": {"tensor_cores": "conv_tc::conv_tc_kernel",
                              "cuda_cores":
                                  "conv_gemm_kernel<T, kStemS2d>"},
                **({"parent": main["parent"]} if "parent" in main else {})}
               if name == "stem_conv" else {}),
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            **({"per_forward_sweep": sweep["per_forward"][name]}
               if conv else {}),
            "case": main["case"], "dtype": main["dtype"],
            "batch": main["batch"], "limits": main["limits"],
            "max_abs_err_all": max(c["max_abs_err"] for c in mine),
            "cases": [{k: c[k] for k in ("case", "dtype", "batch", "ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by", *keys)
                       if k in c} for c in mine]}


def bwd_entry(name, replaces, launches, cases, sweep):
    """A backward kernel's entry of the kernels line: its numbers at the
    main path's shape (the first bf16 case of the kernel), every case's,
    and the sweep's launch-weighted times a step."""
    mine = [c for c in cases if c["kernel"] == name]
    main = mine[0]
    keys = ("max_abs_err", "dw_max_abs_err", "row_rel", "tile_rel",
            "dw_row_rel", "dw_tile_rel", "sums_rel", "planted",
            "bitwise_repeat")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/"
                      "bottleneck_bwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "library": "aten.convolution_backward (cuDNN dgrad + wgrad)",
            "per_step_sweep": sweep["per_step"][name],
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
    keys = ("case", "route", "max_abs_err", "sums_rel", "dz0", "dy", "dW",
            "dx", "planted", "bitwise_repeat", "x_unaligned_bitwise",
            "dy_unaligned_bitwise")
    design = {"stem_bwd_pool": "redesigned: a tiled gather reading y once "
                               "(8 x 8 pooled windows a block, zc and each "
                               "window's maximum once in shared memory)",
              "stem_bwd_dw": "redesigned for the tensor cores (bf16 at 4 C "
                             "<= 16: one pass, mma.sync over conv_mma.cuh; "
                             "f32: the CUDA cores)",
              "stem_bwd_dx": "redesigned for the tensor cores (bf16 at 4 C "
                             "<= 16 and K <= 64: the s2d weight resident, "
                             "mma.sync over a dy halo tile; f32: the CUDA "
                             "cores)"}
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/stem_bwd.cu",
            "replaces": replaces, "launches": launches,
            "launches_on": path,
            "design": design[name],
            **({"core_route": main["route"]} if "route" in main else {}),
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


def fused_entry(name, replaces, launches, cases):
    """A fused kernel's entry of the kernels line ("fwd" or "bwd" of
    each case): its numbers at the main path's s2 shape (bf16, B=128),
    and every case's."""
    kind = name.split("_")[1]
    main = cases[0]
    keys = ("out", "fwd_route", "fwd_bitwise_repeat") if kind == "fwd" \
        else ("dy", "dw", "sums_rel", "bitwise_repeat", "bwd_route",
              "bwd_plan")
    return {"name": name, "route": "cuda",
            "source": "deeplearning4j_tpu_torch/nn/layers/csrc/fused.cu",
            "replaces": replaces, "launches": launches,
            "launches_on": f"{TRAIN_RESNET_STEPS} fit steps on fuse=True",
            **({"design": "redesigned for the tensor cores (bf16: the "
                          "bottleneck's 1x1 kernel of conv_fwd_tc.cuh with "
                          "a bias epilogue; f32: the CUDA cores)",
                "core_route": main["fwd_route"],
                "kernel_source": "deeplearning4j_tpu_torch/nn/layers/csrc/"
                                 "conv_fwd_tc.cuh"}
               if kind == "fwd" else {
                "design": "redesigned for the tensor cores (bf16: the "
                          "bottleneck's bwd1x1 kernels of conv_bwd_tc.cuh "
                          "in their fused mode, the raw g the dz "
                          "product's operand, db from the dW pass's g "
                          "tiles; f32: the CUDA cores)",
                "core_route": main["bwd_route"], "plan": main["bwd_plan"],
                "functions": {
                    "tensor_cores": "dl4j_bwd::dz_tc_kernel<1, WN, kFused>, "
                                    "dl4j_bwd::dw_tc_kernel<1, WM, WN, "
                                    "kFused> (bf16)",
                    "cuda_cores": "fused_dz_kernel<float>, "
                                  "fused_dw_kernel<float> (f32)"},
                "planted": main["planted"],
                **({"parent": {c["case"]: c["bwd"]["parent"]
                               for c in cases if "parent" in c["bwd"]}}
                   if "parent" in main["bwd"] else {}),
                "kernel_source": "deeplearning4j_tpu_torch/nn/layers/csrc/"
                                 "conv_bwd_tc.cuh"}),
            "max_abs_err": max(main[k]["max_abs_err"] for k in (
                ("out",) if kind == "fwd" else ("dy", "dw"))),
            **{k: main[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "library": ("torch.matmul on the activated input (cuBLAS)"
                        if kind == "fwd" else "none alone; torch.matmul "
                        "g @ W^T and z^T @ g (cuBLAS)"),
            "case": main["case"], "dtype": main["dtype"],
            "batch": main["batch"], "limits": main["limits"],
            "cases": [{"case": c["case"], "dtype": c["dtype"],
                       "batch": c["batch"], **c[kind],
                       **{k: c[k] for k in keys}} for c in cases]}


# ---------------------------------------------------------------------
# the fit machinery (ROADMAP A5): K-step CUDA graphs and the prefetch
# stage, each against the eager fit from the same initial trees
# ---------------------------------------------------------------------
#: fit(steps_per_dispatch=GRAPH_K, prefetch=GRAPH_PREFETCH) over
#: GRAPH_BATCHES batches (pad_tail at its default, on for K > 1: every
#: batch carries its example-weight mask), against the eager fit (K = 1,
#: no prefetch) with pad_tail=True, which computes the same masked loss
GRAPH_K, GRAPH_BATCHES, GRAPH_PREFETCH = 4, 12, 2
#: profiled steady-state fits of each kind a graph phase takes, in turns
#: (graph, eager, eager, graph, ...): the busy shares' spread
PROFILE_TURNS = 3
#: the graph phases' ResNet50 learning rate (Nesterovs): small enough
#: that 12 steps from random weights stay finite
GRAPH_RESNET_LR = 0.01
#: the sentinel phase: the transformer cut to 2 layers, 2 groups, one
#: NaN in the third batch of the second (a replayed) group
SENTINEL_LAYERS, SENTINEL_BATCHES, SENTINEL_NAN_BATCH = 2, 8, 6
#: the prefetch phase: bench_lstm's batch, this many batches a fit
PREFETCH_LSTM_BATCHES = 6
#: the port's own kernels, by the device function names of csrc/ (the
#: profiler's kernel names hold them)
OUR_KERNELS = ("flash_fwd_kernel", "flash_fwd_mma_kernel",
               "flash_bwd_dq_kernel", "flash_bwd_dq_mma_kernel",
               "flash_bwd_dkv_kernel", "flash_bwd_dkv_mma_kernel",
               "fwd_tc_kernel", "conv_gemm_kernel", "dz_kernel",
               "dz_tc_kernel", "dw_kernel", "dw_tc_kernel", "dy_kernel",
               "dx_kernel", "dx_tc_kernel", "reduce_splits_kernel",
               "reduce_partials_kernel", "conv_tc_kernel", "fwd_pool_kernel",
               "bwd_pool_kernel", "fused_fwd_kernel", "fused_dz_kernel",
               "fused_dw_kernel", "fused_finish_kernel", "lstm_fwd_kernel",
               "lstm_bwd_kernel", "lstm_fwd_cluster_kernel",
               "lstm_bwd_cluster_kernel")
#: each kernel row's launches a step in a profile, by the one device
#: function its wrapper launches once a call (bf16, the graph phases'
#: dtype; rows 3, 4 and 6 by their dz pass, or the fused finish); the
#: profile's kernel names, cut to 90 characters, hold these
ROW_KERNELS = {"flash_fwd": r"flash_fwd(_mma)?_kernel",
               "flash_bwd_dq": r"flash_bwd_dq(_mma)?_kernel",
               "flash_bwd_dkv": r"flash_bwd_dkv(_mma)?_kernel",
               "conv1x1": r"dl4j_fwd::fwd_tc_kernel<1, \d+, 0>",
               "conv3x3": r"dl4j_fwd::fwd_tc_kernel<9, \d+, 0>",
               "bwd1x1": r"dl4j_bwd::dz_tc_kernel<1, \d+, 0>",
               "bwd3x3": r"dl4j_bwd::dz_tc_kernel<9, \d+, 0>",
               "stem_conv": r"conv_tc::conv_tc_kernel",
               "stem_pool": r"fwd_pool::fwd_pool_kernel",
               "stem_bwd_pool": r"bwd_pool_kernel",
               "stem_bwd_dw": r"dw_tc::dw_tc_kernel",
               "fused_fwd": r"dl4j_fwd::fwd_tc_kernel<1, \d+, 1>",
               "fused_bwd": r"fused_finish_kernel",
               "lstm_fwd": r"lstm_fwd(_cluster)?_kernel",
               "lstm_bwd": r"lstm_bwd(_cluster)?_kernel"}
#: the host's launch calls, by the profiler's runtime-call names
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


class RawScores:
    """A listener that keeps each step's loss as it arrives (a device
    scalar: no host read until the run is over)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration, score):
        self.scores.append(score)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def net_trees(net):
    return (net.params, net.updater_state, net.state)


def clone_trees(trees):
    from deeplearning4j_tpu_torch.nn.updater import tree_map
    return tuple(tree_map(lambda t: t.detach().clone()
                          if torch.is_tensor(t) else t, tree)
                 for tree in trees)


def tensor_leaves(trees):
    out = []
    for tree in trees:
        out += [t for _, t in leaf_items(tree) if torch.is_tensor(t)]
    return out


def run_trees(net):
    """The trees a run is held by: the parameters, the updater state and
    the layer state without its streaming carry (an LSTM's last h / c,
    which the next forward strips, and which a K-step group keeps out
    of its state as the JAX scan does)."""
    from deeplearning4j_tpu_torch.nn.network_base import _strip_stream
    return (net.params, net.updater_state, _strip_stream(net.state))


def start_of(net):
    """What a run starts from: copies of the net's trees and its
    training generator's state."""
    return clone_trees(net_trees(net)) + (net._train_gen.get_state(),)


def run_fit(net, x, y, b, init, k=1, prefetch=0, pad_tail=None, extra=()):
    """One fit over (x, y) in batches of b from ``init`` (``start_of``:
    the trees and the training generator's state; or, with ``init``
    None, from the net's own: a steady-state run), with ``pad_tail`` at
    fit's default unless given and the listeners ``extra`` beside the
    loss recorder: its wall time (fit ends in its one sync), the losses,
    the final trees (device copies, with ``init``), peak memory and the
    dispatch counts it added."""
    if init is not None:
        net.params, net.updater_state, net.state = clone_trees(init[:3])
        net._train_gen.set_state(init[3])
    lst = RawScores()
    net.set_listeners(lst, *extra)
    d0 = dict(net.fit_dispatch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(x, y, batch_size=b, steps_per_dispatch=k, prefetch=prefetch,
            pad_tail=pad_tail)
    wall = time.perf_counter() - t0
    net.set_listeners()
    steps = len(lst.scores)
    return {"k": k, "prefetch": prefetch, "wall_s": wall, "steps": steps,
            "step_ms": 1e3 * wall / steps,
            "losses": [float(s) for s in lst.scores],
            "trees": None if init is None else clone_trees(run_trees(net)),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "max_memory_reserved_bytes": torch.cuda.max_memory_reserved(),
            "dispatch": {key: v - d0.get(key, 0)
                         for key, v in net.fit_dispatch.items()
                         if v - d0.get(key, 0)}}


def run_diff(a, b):
    """(bitwise, largest absolute difference) of two runs' losses and
    final trees (NaN where both are NaN counts as equal)."""
    la, lb = np.asarray(a["losses"]), np.asarray(b["losses"])
    same = la.shape == lb.shape and bool(np.array_equal(la, lb,
                                                        equal_nan=True))
    worst = float(np.nanmax(np.abs(la - lb))) if la.size else 0.0
    for u, w in zip(tensor_leaves(a["trees"]), tensor_leaves(b["trees"]),
                    strict=True):
        if torch.equal(u, w) or (u.is_floating_point() and bool(
                torch.equal(torch.nan_to_num(u), torch.nan_to_num(w)))):
            continue
        same = False
        d = (u.double() - w.double()).abs()
        worst = max(worst, float(torch.nan_to_num(d, nan=float("inf"))
                                 .max()))
    return same, worst


def eager_gate(e1, e2, g):
    """The graph fit against the eager fit: bitwise where two eager fits
    are bitwise equal, else within twice their difference."""
    ee_same, ee = run_diff(e1, e2)
    ge_same, ge = run_diff(g, e1)
    held = ge_same if ee_same else ge <= 2 * ee
    return {"eager_bitwise": ee_same, "eager_diff": ee,
            "graph_bitwise": ge_same, "graph_diff": ge,
            "rule": "bitwise" if ee_same else "within 2x eager diff",
            "held": bool(held)}


def summary(run):
    return {k: v for k, v in run.items() if k != "trees"}


def union_us(spans):
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def profile_run(net, x, y, b, k, prefetch, pad_tail=None):
    """A steady-state run (from the net's own trees) under
    torch.profiler, read from its Chrome trace: wall ms a step, the
    device's busy share (the union of its kernel, copy and fill
    intervals over the wall time), host launch calls a step, kernels a
    step, the port's own kernels a step by name, the graph launches, and
    the host-to-device copies (``h2d_exposure``)."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.makedirs("chiprun_out", exist_ok=True)
    path = f"chiprun_out/profile_{os.getpid()}.trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run = run_fit(net, x, y, b, None, k, prefetch, pad_tail)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        rec = h2d_exposure(events)
    finally:
        os.remove(path)
    steps = run["steps"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    names = {}
    for e in kernels:
        if any(n in e["name"] for n in OUR_KERNELS):
            key = e["name"][:90]
            names[key] = names.get(key, 0) + 1
    host = {}
    for e in events:
        if e.get("name") in HOST_LAUNCHES:
            host[e["name"]] = host.get(e["name"], 0) + 1
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in device]
    rec.update({
        "step_ms": run["step_ms"],
        "device_busy_share": union_us(spans) / (run["wall_s"] * 1e6),
        "device_busy_ms_per_step": union_us(spans) / 1e3 / steps,
        "host_launches_per_step": sum(host.values()) / steps,
        "host_calls": host,
        "kernel_launches_per_step": len(kernels) / steps,
        "our_kernels_per_step": {n: c / steps for n, c in names.items()},
        "graph_launches": host.get("cudaGraphLaunch", 0),
        "h2d_exposed_ms_per_step": rec["h2d_exposed_ms"] / steps})
    return rec, run


def replay_device_ms(net, reps=3):
    """The card's time of one replay of the net's step graph (CUDA events
    on its stream), median of ``reps``; the replays update the net's
    trees, so this runs after the gates."""
    sg = net._step_graph
    times = []
    with torch.cuda.stream(sg.stream):
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sg.graph.replay()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def spread(values):
    """The values with their median, least and largest."""
    return {"values": values, "median": float(np.median(values)),
            "min": float(min(values)), "max": float(max(values))}


def most_per_step(profiles):
    """Each of the port's kernels' most launches a step over profiles."""
    out = {}
    for p in profiles:
        for name, v in p["our_kernels_per_step"].items():
            out[name] = max(out.get(name, 0), v)
    return out


def row_launches(ours):
    """A profile's launches a step of each kernel row (ROW_KERNELS)."""
    import re
    return {row: sum(v for name, v in ours.items() if re.search(pat, name))
            for row, pat in ROW_KERNELS.items()}


def graph_phase(label, net, x, y, b, failures, want_rows):
    """A net's graph fit against its eager fit (pad_tail=True: the same
    masked loss): two eager fits (the gate's noise floor), the first
    graph fit (its first group warms eagerly, its second is captured,
    then every group replays), the turns graph, eager, eager, graph,
    then PROFILE_TURNS profiled steady-state fits of each kind in turns
    and one replay timed on the card. The rows ``want_rows`` must each
    launch inside the replays as often a step as the eager fit's wrapper
    counts say; the inference forward after a graph fit (``output()``'s
    path; its logits, which a saturated softmax would hide) must read
    the parameters the fit left, not a compute-dtype copy from before
    it. A profile can lose some of a replay's kernel records, so the
    kernel counts are each name's most over the profiled fits of a
    kind."""
    steps = x.shape[0] // b
    graph_kp = (GRAPH_K, GRAPH_PREFETCH)
    eager_kp = (1, 0, True)
    init = start_of(net)
    cap0 = net.fit_dispatch.get("captures", 0)
    zero_counts()
    e1 = run_fit(net, x, y, b, init, *eager_kp)
    eager_rows = {n: c / steps for n, c in read_counts().items() if c}
    e2 = run_fit(net, x, y, b, init, *eager_kp)
    zero_counts()
    g1 = run_fit(net, x, y, b, init, *graph_kp)
    capture_counts = {n: c for n, c in read_counts().items() if c}
    turns = [run_fit(net, x, y, b, init, *kp)
             for kp in (graph_kp, eager_kp, eager_kp, graph_kp)]
    gate = eager_gate(e1, e2, g1)
    gate_replayed = eager_gate(e1, e2, turns[0])
    # profiled steady-state fits in turns, the graph first (the last turn
    # left the graph's own trees in the net). Around the first, the
    # output() check: before it (a compute-dtype copy made), after it,
    # and from a copy of the trees it left
    probe = x[:b]
    before = logits(net, probe)
    pgraphs, peffs, probe_rec = [], [], None
    for i in range(PROFILE_TURNS):
        for kind in (("graph", "eager") if i % 2 == 0 else
                     ("eager", "graph")):
            if kind == "graph":
                # the eager fit's trees into the graph's, outside the
                # profile (a steady-state fit's replays copy nothing in;
                # a group's state holds no streaming carry)
                net.params, net.updater_state, net.state = run_trees(net)
                net._step_graph.bind(net)
                pgraphs.append(profile_run(net, x, y, b, *graph_kp)[0])
            else:
                peffs.append(profile_run(net, x, y, b, *eager_kp)[0])
            if probe_rec is None:
                after = logits(net, probe)
                held = net_trees(net)
                net.params, net.updater_state, net.state = clone_trees(held)
                fresh = logits(net, probe)
                net.params, net.updater_state, net.state = held
                probe_rec = {"equal_to_fresh_trees": bool(
                                 torch.equal(after, fresh)),
                             "moved_by_the_fit": not bool(
                                 torch.equal(after, before))}
                del before, after, fresh
    dev_ms = replay_device_ms(net)
    pgraph, peff = pgraphs[0], peffs[0]
    eager_ms = [e1["step_ms"], e2["step_ms"], turns[1]["step_ms"],
                turns[2]["step_ms"]]
    graph_ms = [turns[0]["step_ms"], turns[3]["step_ms"]]
    graph_step_ms = float(np.median(graph_ms))
    rec = {"batches": steps, "batch": b, "k": GRAPH_K,
           "prefetch": GRAPH_PREFETCH, "pad_tail": "default (on)",
           "eager_pad_tail": True,
           "eager_step_ms": eager_ms,
           "eager_step_ms_median": float(np.median(eager_ms)),
           "graph_first_fit_step_ms": g1["step_ms"],
           "graph_step_ms": graph_ms, "graph_step_ms_median": graph_step_ms,
           "replay_device_ms": dev_ms,
           "replay_device_ms_per_step": dev_ms / GRAPH_K,
           "graph_busy_share_from_replay": dev_ms / GRAPH_K / graph_step_ms,
           "captures": net.fit_dispatch.get("captures", 0) - cap0,
           "first_fit_dispatch": g1["dispatch"],
           "replayed_fit_dispatch": turns[0]["dispatch"],
           "eager_fit_dispatch": e1["dispatch"],
           "eager_launches_per_step": eager_rows,
           "capture_launch_counts": capture_counts,
           # a replayed fit allocates nothing: the graph's pool was
           # allocated at its capture (the first graph fit)
           "peak_allocated_bytes": {"eager": e1["max_memory_allocated_bytes"],
                                    "graph_first": g1[
                                        "max_memory_allocated_bytes"],
                                    "graph": turns[0][
                                        "max_memory_allocated_bytes"]},
           "peak_reserved_bytes": {"eager": e1["max_memory_reserved_bytes"],
                                   "graph_first": g1[
                                       "max_memory_reserved_bytes"],
                                   "graph": turns[0][
                                       "max_memory_reserved_bytes"]},
           "losses_eager": e1["losses"], "losses_graph": g1["losses"],
           "gate_first_graph_fit": gate,
           "gate_replayed_graph_fit": gate_replayed,
           "output_after_graph_fit": probe_rec,
           "profiled_turns": {
               kind: {key: spread([p[key] for p in ps]) for key in (
                   "step_ms", "device_busy_share", "device_busy_ms_per_step",
                   "host_launches_per_step", "kernel_launches_per_step")}
               for kind, ps in (("eager", peffs), ("graph", pgraphs))},
           "profile_eager": peff, "profile_graph": pgraph}
    ours_e, ours_g = most_per_step(peffs), most_per_step(pgraphs)
    got_rows = row_launches(ours_g)
    rec["graph_row_launches_per_step"] = {r: got_rows[r] for r in want_rows}
    rec["graph_row_launches_per_profile"] = [
        {r: v for r, v in row_launches(p["our_kernels_per_step"]).items()
         if r in want_rows} for p in pgraphs]
    log(f"{label}:", json.dumps(rec))
    if not (gate["held"] and gate_replayed["held"]):
        failures.append(f"{label}: the graph fit parts from the eager fit "
                        f"({gate}, {gate_replayed})")
    if not (probe_rec["equal_to_fresh_trees"]
            and probe_rec["moved_by_the_fit"]):
        failures.append(f"{label}: output() after a graph fit {probe_rec}")
    if rec["captures"] != 1:
        failures.append(f"{label}: {rec['captures']} captures, want 1")
    want_first = {"eager_group_steps": GRAPH_K, "replays":
                  steps // GRAPH_K - 1, "graph_steps": steps - GRAPH_K,
                  "captures": 1}
    if g1["dispatch"] != want_first:
        failures.append(f"{label}: the first graph fit ran "
                        f"{g1['dispatch']}, want {want_first}")
    want_replayed = {"replays": steps // GRAPH_K, "graph_steps": steps}
    if turns[0]["dispatch"] != want_replayed:
        failures.append(f"{label}: a replayed graph fit ran "
                        f"{turns[0]['dispatch']}, want {want_replayed}")
    for p in pgraphs:
        if p["graph_launches"] != steps // GRAPH_K:
            failures.append(f"{label}: {p['graph_launches']} graph "
                            f"launches in a profiled fit, want "
                            f"{steps // GRAPH_K}")
    # each wanted row's kernels are held below against the eager fit's
    # exact wrapper counts; the rest of the port's kernels against the
    # eager fit's trace (a trace can lose a record: one call's eager
    # traces lost one of 24 LSTM forwards in every profiled fit)
    def unrowed(ours):
        return {n: v for n, v in ours.items() if not any(
            re.search(ROW_KERNELS[r], n) for r in want_rows)}
    if not ours_g or unrowed(ours_g) != unrowed(ours_e):
        failures.append(f"{label}: the graph's kernels a step {ours_g} "
                        f"are not the eager fit's {ours_e}")
    for row in want_rows:
        want = eager_rows.get(row, 0)
        if not want or got_rows[row] != want:
            failures.append(f"{label}: {row} launched {got_rows[row]} a "
                            f"graph step, the eager fit's wrapper {want}")
    return rec


def graph_transformer_data(layers_seed, batches):
    rng = np.random.default_rng(layers_seed)
    x, y = one_hot_batch(rng, TRAIN_B * batches, TRAIN_VOCAB, TRAIN_T)
    return x, y


def fit_graph_transformer(device):
    """The train phase's transformer (bench_all.py:356-387: T 8192, B 4,
    bf16, 6 layers) through fit(steps_per_dispatch=4, prefetch=2) over 12
    batches against the eager fit (``graph_phase``); the flash kernels
    launch 6 times a graph step each."""
    net = train_model(LAYERS, TRAIN_T, seed=3).init(device=device)
    net.conf.dtype = "bfloat16"
    x, y = graph_transformer_data(21, GRAPH_BATCHES)
    failures = []
    rec = graph_phase("fit_graph_transformer", net, x, y, TRAIN_B, failures,
                      want_rows=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del net
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"fit_graph_transformer: {failures}")
    return rec


def graph_resnet_images(batches, seed=0):
    """GRAPH_BATCHES batches of bench_all.py's images: 4 distinct seeded
    batches of RESNET_B, repeated."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(4):
        xs.append(rng.standard_normal((RESNET_B, 3, RESNET_HW, RESNET_HW))
                  .astype(np.float32))
        y = np.zeros((RESNET_B, RESNET_CLASSES), np.float32)
        y[np.arange(RESNET_B), rng.integers(0, RESNET_CLASSES, RESNET_B)] = 1
        ys.append(y)
    reps = batches // 4
    return np.concatenate(xs * reps), np.concatenate(ys * reps)


def fit_graph_resnet(device):
    """ResNet50 at B=128 (bench_all.py:390-469, bf16) on two plans, each
    through ``graph_phase`` (the BN running statistics are in the gate's
    trees): fuse=True (rows 5, 6) and the fused plan with the stem (rows
    1-4, 7-10). cuDNN runs its deterministic algorithms here, so two
    eager fits can agree bit for bit."""
    x, y = graph_resnet_images(GRAPH_BATCHES)
    failures, rec = [], {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = fuse_true_net(device, torch.bfloat16, lr=GRAPH_RESNET_LR)
        rec["fuse_true"] = graph_phase("fit_graph_resnet fuse_true", net, x,
                                       y, RESNET_B, failures,
                                       ("fused_fwd", "fused_bwd"))
        del net
        torch.cuda.empty_cache()
        net = resnet_train_net(device, torch.bfloat16, lr=GRAPH_RESNET_LR)
        net.set_fusion("bottleneck", stem=True)
        rec["fused_stem"] = graph_phase(
            "fit_graph_resnet fused_stem", net, x, y, RESNET_B, failures,
            ("conv1x1", "conv3x3", "bwd1x1", "bwd3x3", "stem_conv",
             "stem_pool", "stem_bwd_pool", "stem_bwd_dw"))
        rec["fused_stem"]["plan"] = {"blocks": len(net._fusion()[1]),
                                     "stem": bool(net._fusion()[2])}
        del net
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    if failures:
        raise AssertionError(f"fit_graph_resnet: {failures}")
    return rec


def registry_count(name):
    from deeplearning4j_tpu_torch.monitoring import global_registry
    m = global_registry().get(name)
    return 0.0 if m is None else m.total()


def fit_graph_sentinel(device):
    """One NaN in the third batch of a replayed K=4 group (the
    transformer cut to 2 layers): the graph's device select must leave
    the parameters, updater and layer state as the eager fit's host-read
    skip leaves them (the gate's rule), the registry must count one bad
    and one skipped step, and the same run with the select removed
    (planted) must fail that check."""
    from deeplearning4j_tpu_torch.nn import network_base
    net = train_model(SENTINEL_LAYERS, TRAIN_T, seed=5).init(device=device)
    net.conf.dtype = "bfloat16"
    x, y = graph_transformer_data(22, SENTINEL_BATCHES)
    rows = slice(TRAIN_B * SENTINEL_NAN_BATCH,
                 TRAIN_B * (SENTINEL_NAN_BATCH + 1))
    x[rows][1, 7, TRAIN_T // 2] = np.nan
    init = start_of(net)
    e1 = run_fit(net, x, y, TRAIN_B, init, pad_tail=True)
    e2 = run_fit(net, x, y, TRAIN_B, init, pad_tail=True)

    def graph_run():
        bad0 = registry_count("dl4jtpu_bad_steps_total")
        skip0 = registry_count("dl4jtpu_skipped_updates_total")
        g = run_fit(net, x, y, TRAIN_B, init, GRAPH_K, GRAPH_PREFETCH)
        gate = eager_gate(e1, e2, g)
        counts = {"bad_steps": registry_count("dl4jtpu_bad_steps_total")
                  - bad0, "skipped_updates": registry_count(
                      "dl4jtpu_skipped_updates_total") - skip0}
        finite = all(bool(torch.isfinite(t).all())
                     for t in tensor_leaves(g["trees"])
                     if t.is_floating_point())
        ok = gate["held"] and finite and counts == {"bad_steps": 1,
                                                    "skipped_updates": 1}
        return {"gate": gate, "registry": counts, "trees_finite": finite,
                "losses": g["losses"], "dispatch": g["dispatch"],
                "held": bool(ok)}

    real = graph_run()
    real_guard = network_base.guard_updates
    net._drop_step_graph()
    network_base.guard_updates = lambda ok, policy, *pairs: tuple(
        n for n, _ in pairs)
    try:
        planted = graph_run()
    finally:
        network_base.guard_updates = real_guard
        net._drop_step_graph()
    rec = {"nan_batch": SENTINEL_NAN_BATCH, "layers": SENTINEL_LAYERS,
           "eager_losses": e1["losses"], "graph": real,
           "planted_no_select": planted}
    log("fit_graph_sentinel:", json.dumps(rec))
    del net
    torch.cuda.empty_cache()
    if not real["held"] or planted["held"] or \
            not np.isnan(real["losses"][SENTINEL_NAN_BATCH]) or \
            real["dispatch"].get("graph_steps") != GRAPH_K:
        raise AssertionError(f"fit_graph_sentinel: {rec}")
    return rec


def draws_mlp(device):
    """A small MLP whose training draws: Dropout(0.9) on the first
    layer's input, WeightNoise on the second layer's weights."""
    from deeplearning4j_tpu_torch.nn.conf import dropout as tdrop
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    layers = [tl.DenseLayer(n_in=64, n_out=256, activation="relu",
                            dropout=tdrop.Dropout(0.9)),
              tl.DenseLayer(n_out=256, activation="relu",
                            weight_noise=tdrop.WeightNoise(stddev=0.01)),
              tl.OutputLayer(n_out=10, loss="mcxent", activation="softmax")]
    return MultiLayerNetwork(MultiLayerConfiguration(
        layers=layers, input_type=InputType.feed_forward(64),
        seed=11)).init(device=device)


def stale_draw(sg, net):
    """The planted fault: a replay's generators left where the last
    replay moved them (the training generator advanced as it should)."""
    for _ in sg.gens:
        net._step_base()


def capture_gc_run(device, guarded):
    """One fit of ``draws_mlp`` through the K-step graph while a dead
    network's step graph waits in a reference cycle. A live reference
    holds it until the capture's first step, which drops it and then
    collects if the collector is on: what an automatic collection at an
    allocation there would do. ``guarded`` False takes out the fit's
    collector pause (planted). Returns the fit's dispatch counts and
    losses."""
    import contextlib
    import gc
    from deeplearning4j_tpu_torch.nn import network_base
    rng = np.random.default_rng(5)
    n = GRAPH_BATCHES * 32
    x = rng.standard_normal((n, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    cls = network_base.NetworkBase
    real_steps, real_pause = cls._group_steps, network_base._collector_paused
    dead = draws_mlp(device)
    dead.fit(x, y, batch_size=32, steps_per_dispatch=GRAPH_K)
    if dead._step_graph is None or dead._step_graph.graph is None:
        raise AssertionError("capture_gc: the first fit captured no graph")
    dead.cycle = dead
    held = [dead]
    del dead

    def collecting(self, *a):
        if torch.cuda.is_current_stream_capturing() and held:
            held.clear()
            if gc.isenabled():
                gc.collect()
        return real_steps(self, *a)

    cls._group_steps = collecting
    if not guarded:
        network_base._collector_paused = contextlib.nullcontext
    try:
        net = draws_mlp(device)
        lst = RawScores()
        net.set_listeners(lst)
        net.fit(x, y, batch_size=32, steps_per_dispatch=GRAPH_K)
        torch.cuda.synchronize()
    finally:
        cls._group_steps, network_base._collector_paused = real_steps, \
            real_pause
    if held:
        raise AssertionError("capture_gc: the fit captured no graph")
    return dict(net.fit_dispatch), [float(v) for v in lst.scores]


def capture_gc_child():
    """The planted run of ``capture_gc`` (no collector pause): prints
    the error the fit raised and exits 4, or exits 0 if it passed."""
    try:
        capture_gc_run(torch.device("cuda", 0), False)
    except Exception as e:  # noqa: BLE001 — the planted fault's report
        print("capture_gc_child:", repr(e)[:400], flush=True)
        return 4
    return 0


def capture_gc(device, smi):
    """The fit's collector pause around a capture (``nn/network_base.py``
    ``_collector_paused``): a collection inside a capture that frees a
    dead network's CUDA graph invalidates the capture. With the pause
    (this process) the fit captures once and its losses are finite;
    without it (planted, a child process) the fit must fail so."""
    import gc
    import os
    d, losses = capture_gc_run(device, True)
    if not gc.isenabled():
        raise AssertionError("capture_gc: the collector stayed off")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--capture-gc-child"], capture_output=True,
                          text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    child_s = time.perf_counter() - t0
    planted = (proc.stdout.strip().splitlines() or [""])[-1]
    rec = {"dispatch": d, "losses": losses, "planted_rc": proc.returncode,
           "planted": planted, "planted_s": child_s, "card": smi}
    log("capture_gc:", json.dumps(rec))
    failures = []
    if d.get("captures") != 1 or d.get("replays", 0) < 1:
        failures.append(f"dispatch {d}")
    if len(losses) != GRAPH_BATCHES or not np.isfinite(losses).all():
        failures.append(f"losses {losses}")
    if proc.returncode != 4 or "during capture" not in planted:
        failures.append(f"the planted run without the pause did not fail "
                        f"so: rc {proc.returncode} {planted!r} "
                        f"{proc.stderr[-400:]!r}")
    if failures:
        raise AssertionError(f"capture_gc: {failures}")
    return rec


def fit_graph_draws(device, smi):
    """ROADMAP C5's gate: networks whose training draws, through the
    K-step graph. (a) The MLP of ``draws_mlp``, 12 batches of 32: two
    eager fits, a graph fit (warm, capture, replay) and one that replays
    every group, each from the same trees and training generator state;
    the graph fits' losses, parameters and updater state against the
    eager fit's by ``eager_gate``, and the same graph fit with the
    generators not re-offset before each replay (planted) must fail it.
    (b) The regularized text LSTM (Dropout(0.9), DropConnect(0.95),
    MaxNormConstraint, AdaMax; bf16, B = T = 256) without tBPTT, through
    ``graph_phase``: fit(steps_per_dispatch=4, prefetch=2) over 12
    batches against the eager fit in turns, rows 17 and 17b inside the
    replays as often a step as in the eager fit. (c) The cooperative
    route in a graph (``cooperative_in_graph``)."""
    from deeplearning4j_tpu_torch.nn import network_base
    failures = []
    net = draws_mlp(device)
    rng = np.random.default_rng(5)
    n = GRAPH_BATCHES * 32
    x = rng.standard_normal((n, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    init = start_of(net)
    e1, e2 = (run_fit(net, x, y, 32, init, 1, 0, True) for _ in range(2))
    g1, g2 = (run_fit(net, x, y, 32, init, GRAPH_K) for _ in range(2))
    real = network_base._StepGraph.draw
    network_base._StepGraph.draw = stale_draw
    try:
        planted = run_fit(net, x, y, 32, init, GRAPH_K)
    finally:
        network_base._StepGraph.draw = real
    gates = {"first_graph_fit": eager_gate(e1, e2, g1),
             "replayed_graph_fit": eager_gate(e1, e2, g2),
             "planted_no_reoffset": eager_gate(e1, e2, planted)}
    mlp = {"batches": GRAPH_BATCHES, "batch": 32, "k": GRAPH_K,
           "gates": gates, "dispatch": {"first": g1["dispatch"],
                                        "replayed": g2["dispatch"]},
           "step_ms": {"eager": [e1["step_ms"], e2["step_ms"]],
                       "graph": [g1["step_ms"], g2["step_ms"]]},
           "peak_allocated_bytes": {"eager": e1["max_memory_allocated_bytes"],
                                    "graph": g1["max_memory_allocated_bytes"]},
           "losses_eager": e1["losses"], "losses_graph": g1["losses"],
           "card": smi}
    log("fit_graph_draws mlp:", json.dumps(mlp))
    if not (gates["first_graph_fit"]["held"]
            and gates["replayed_graph_fit"]["held"]):
        failures.append(f"mlp: the graph fit parts from the eager fit "
                        f"{gates}")
    if gates["planted_no_reoffset"]["held"]:
        failures.append("mlp: the planted un-re-offset generators pass "
                        "the gate")
    want = {"eager_group_steps": GRAPH_K, "captures": 1,
            "replays": GRAPH_BATCHES // GRAPH_K - 1,
            "graph_steps": GRAPH_BATCHES - GRAPH_K}
    if g1["dispatch"] != want or g2["dispatch"] != {
            "replays": GRAPH_BATCHES // GRAPH_K,
            "graph_steps": GRAPH_BATCHES}:
        failures.append(f"mlp: dispatch {g1['dispatch']}, "
                        f"{g2['dispatch']}")
    del net
    torch.cuda.empty_cache()
    net = regularized_lstm_net(device, torch.bfloat16, tbptt=False)
    x, y = text_batch(LSTM_B * GRAPH_BATCHES, LSTM_T, seed=4)
    lstm = graph_phase("fit_graph_draws lstm", net, x, y, LSTM_B, failures,
                       want_rows=("lstm_fwd", "lstm_bwd"))
    lstm["card"] = smi
    del net
    torch.cuda.empty_cache()
    wide = cooperative_in_graph(device, failures)
    wide["card"] = smi
    log("fit_graph_draws cooperative:", json.dumps(wide))
    if failures:
        raise AssertionError(f"fit_graph_draws: {failures}")
    return {"mlp": mlp, "lstm": lstm, "cooperative": wide}


#: the cooperative LSTM route in a graph: one GravesLSTM of this many
#: units (beyond the cluster route's 256), bf16, batches of COOP_B rows
#: and COOP_T steps
COOP_H, COOP_B, COOP_T = 512, 64, 32


def cooperative_in_graph(device, failures):
    """Rows 17 / 17b's cooperative route (``cudaLaunchCooperativeKernel``
    after ``cudaFuncSetAttribute``) inside a captured K-step graph: a
    bf16 GravesLSTM of COOP_H units with input dropout, 12 batches, the
    graph fit against two eager fits by the gate; one forward and one
    backward launch a step in the eager fit, and the graph's capture
    launching them as often a step."""
    from deeplearning4j_tpu_torch.nn.conf.dropout import Dropout
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        GravesLSTM, RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers.lstm_kernel import (
        lstm_bwd_route, lstm_fwd_route)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updater import Adam
    conf = (NeuralNetConfiguration.Builder().seed(21).updater(Adam(1e-3))
            .list().layer(GravesLSTM(n_out=COOP_H, activation="tanh",
                                     dropout=Dropout(0.9)))
            .layer(RnnOutputLayer(n_out=LSTM_VOCAB, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(LSTM_VOCAB, COOP_T)).build())
    conf.dtype = "bfloat16"
    net = MultiLayerNetwork(conf).init(device=device)
    x, y = text_batch(COOP_B * GRAPH_BATCHES, COOP_T, seed=6)
    init = start_of(net)
    zero_counts()
    e1 = run_fit(net, x, y, COOP_B, init, 1, 0, True)
    eager = {k: v / GRAPH_BATCHES for k, v in lstm_counts().items()}
    e2 = run_fit(net, x, y, COOP_B, init, 1, 0, True)
    zero_counts()
    g = run_fit(net, x, y, COOP_B, init, GRAPH_K, GRAPH_PREFETCH)
    captured = lstm_counts()
    gate = eager_gate(e1, e2, g)
    rec = {"h": COOP_H, "batch": COOP_B, "t": COOP_T,
           "routes": [lstm_fwd_route(COOP_B, COOP_H, torch.bfloat16),
                      lstm_bwd_route(COOP_B, COOP_H, torch.bfloat16)],
           "gate": gate, "dispatch": g["dispatch"],
           "eager_launches_per_step": eager,
           "launches_in_graph_fit": captured,
           "step_ms": {"eager": [e1["step_ms"], e2["step_ms"]],
                       "graph": g["step_ms"]}}
    # the graph fit's wrappers count the warm group's 4 steps and the
    # capture's 4 (the replays launch without the host)
    want = {k: 2 * GRAPH_K * v for k, v in eager.items()}
    if not gate["held"] or rec["routes"] != ["cooperative", "cooperative"] \
            or captured != want or eager != {"lstm_fwd": 1.0,
                                             "lstm_bwd": 1.0} or \
            g["dispatch"].get("captures") != 1:
        failures.append(f"cooperative route in a graph: {rec}")
    del net
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------
# durable training state (util/checkpoint.py, resilience/durable.py,
# util/recovery.py, resilience/chaos.py)
# ---------------------------------------------------------------------
#: the killed child: SIGKILL before global batch DURABLE_KILL_AT,
#: DURABLE_KILL_DELAY s after its prefetch worker reaches it (the fit
#: goes on meanwhile, so the kill can land inside a save); the preempted
#: run: PreemptionGuard.trigger() in iteration DURABLE_TRIGGER's
#: listener pass (the save lands at the boundary after its group)
DURABLE_KILL_AT, DURABLE_KILL_DELAY, DURABLE_TRIGGER = 9, 1.5, 6
DURABLE_EVERY, DURABLE_KEEP = 4, 2
#: the recovery phase: 8 batches, a save every 2 iterations, the
#: transient fault before global batch 5, NaN batches 4 and 5 and a
#: watchdog that raises at 2 bad steps in a row, the rate halved
RECOVERY_BATCHES, RECOVERY_EVERY, RECOVERY_FAULT = 8, 2, 5
RECOVERY_NAN, RECOVERY_BACKOFF = (4, 5), 0.5


def durable_net(device):
    """The durable phase's network: the fit_graph_transformer cell
    (T 8192, B 4, bf16, 6 layers, Adam(3e-4)), random weights from seed
    3."""
    net = train_model(LAYERS, TRAIN_T, seed=3).init(device=device)
    net.conf.dtype = "bfloat16"
    return net


def dir_bytes(path):
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def timed_checkpoints(path):
    """A CheckpointListener (a save every DURABLE_EVERY iterations,
    asynchronous, the newest DURABLE_KEEP kept) that records, per save,
    the ms the fit waited at the boundary (``wait_ms``), the part of it
    the snapshot took (``snapshot_ms``: the device-to-host copies and
    their one sync) and the part its hand-over to the writer blocked on
    the writer's queue (``queue_ms``: backpressure), the s its
    background write took and the bytes of its step directory."""
    import os
    from deeplearning4j_tpu_torch.util import checkpoint as ck

    class Timed(ck.CheckpointListener):
        def __init__(self):
            super().__init__(path, save_every_n_iterations=DURABLE_EVERY,
                             async_save=True, keep_last=DURABLE_KEEP)
            self.saves = []
            submit = self.writer.submit

            def timed_submit(fn, label="save", is_save=True):
                rec = self.saves[-1]
                if is_save:
                    def run():
                        t0 = time.perf_counter()
                        fn()
                        rec["write_s"] = time.perf_counter() - t0
                        rec["bytes"] = dir_bytes(os.path.join(path, label))
                else:
                    run = fn
                t0 = time.perf_counter()
                submit(run, label, is_save)
                rec["queue_ms"] = rec.get("queue_ms", 0.0) + 1e3 * (
                    time.perf_counter() - t0)
            self.writer.submit = timed_submit

        def _save(self, model, step):
            rec = {"step": step}
            self.saves.append(rec)
            snapshot = ck.snapshot_tree

            def timed_snapshot(tree):
                t0 = time.perf_counter()
                out = snapshot(tree)
                rec["snapshot_ms"] = 1e3 * (time.perf_counter() - t0)
                return out
            ck.snapshot_tree = timed_snapshot
            t0 = time.perf_counter()
            try:
                super()._save(model, step)
            finally:
                ck.snapshot_tree = snapshot
            rec["wait_ms"] = 1e3 * (time.perf_counter() - t0)
    return Timed()


def tree_arrays(trees, names=("params", "updater", "state")):
    """``{path: host array}`` of a tuple of trees."""
    out = {}
    for name, tree in zip(names, trees):
        for key, t in leaf_items(tree):
            if torch.is_tensor(t):
                out["/".join((name,) + tuple(key))] = \
                    t.detach().float().cpu().numpy()
    return out


def same_arrays(a, b):
    """(bitwise, the keys that differ) of two ``tree_arrays``."""
    bad = sorted(k for k in set(a) | set(b) if k not in a or k not in b
                 or not np.array_equal(a[k], b[k], equal_nan=True))
    return not bad, bad[:8]


def durable_child(mode, ck, out):
    """The durable phase's child process. ``kill``: the straight run's
    fit with its checkpoint listener and a ProcessKillInjector, which
    SIGKILLs the process (it never returns). ``resume``: a fresh network
    restored from the newest intact checkpoint under ``ck`` finishes
    the fit; its trees go to ``out`` (.npz) and its restore time and
    counters to ``out``.json."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.resilience.chaos import (
        ProcessKillInjector)
    from deeplearning4j_tpu_torch.util.checkpoint import (
        CheckpointListener, restore_checkpoint)
    device = torch.device("cuda", 0)
    net = durable_net(device)
    x, y = graph_transformer_data(21, GRAPH_BATCHES)
    if mode == "kill":
        net.set_listeners(CheckpointListener(
            ck, save_every_n_iterations=DURABLE_EVERY, async_save=True,
            keep_last=DURABLE_KEEP))
        net.fit(ProcessKillInjector(ArrayDataSetIterator(x, y, TRAIN_B),
                                    n=DURABLE_KILL_AT,
                                    delay=DURABLE_KILL_DELAY),
                steps_per_dispatch=GRAPH_K, prefetch=GRAPH_PREFETCH)
        return 3                        # not reached: the kill ends it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_checkpoint(net, ck)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    step = net.iteration_count
    net.fit(ArrayDataSetIterator(x, y, TRAIN_B), epochs=1 - net.epoch_count,
            steps_per_dispatch=GRAPH_K, prefetch=GRAPH_PREFETCH)
    np.savez(out, **tree_arrays(net_trees(net)))
    with open(out + ".json", "w") as f:
        json.dump({"restored_step": step, "restore_s": restore_s,
                   "iteration": net.iteration_count,
                   "epoch": net.epoch_count,
                   "dispatch": dict(net.fit_dispatch)}, f)
    return 0


def run_child(mode, ck, out):
    """The durable child in a new process (its output captured)."""
    import os
    cmd = [sys.executable, os.path.abspath(__file__), "--durable-child",
           mode, "--durable-dir", ck, "--durable-out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter() - t0


def durable_transformer(device, smi):
    """The transformer of fit_graph_transformer through fit(
    steps_per_dispatch=4, prefetch=2) over 12 batches with a
    CheckpointListener (a save every 4 iterations, asynchronous, the
    newest 2 kept). (i) A straight run from the seeded weights: the
    reference trees, each save's wait, write and bytes; then the step
    with and without the listener in turns. (ii) A child process runs
    the same fit with a ProcessKillInjector at batch 9 and must die by
    SIGKILL; every checkpoint it left verifies; a second child restores
    the newest into a fresh network and finishes: its trees bitwise the
    straight run's. (iii) In this process PreemptionGuard.trigger() in
    iteration 6: the emergency save lands at the boundary after the
    group (step 8) and PreemptionExit is raised; a fresh network
    restores it and finishes, bitwise the straight run's."""
    import os
    import shutil
    import signal
    import tempfile
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.resilience.durable import (
        PreemptionExit, PreemptionGuard)
    from deeplearning4j_tpu_torch.util.checkpoint import (
        list_checkpoints, restore_checkpoint, verify_checkpoint)
    root = tempfile.mkdtemp(prefix="durable_")
    failures, rec = [], {"card": smi, "batches": GRAPH_BATCHES,
                         "k": GRAPH_K, "prefetch": GRAPH_PREFETCH,
                         "save_every": DURABLE_EVERY,
                         "keep_last": DURABLE_KEEP}
    try:
        x, y = graph_transformer_data(21, GRAPH_BATCHES)
        net = durable_net(device)
        init = start_of(net)
        lst = timed_checkpoints(os.path.join(root, "straight"))
        straight = run_fit(net, x, y, TRAIN_B, init, GRAPH_K,
                           GRAPH_PREFETCH, extra=(lst,))
        lst.flush()
        want = tree_arrays(straight["trees"])
        rec["straight"] = {"step_ms": straight["step_ms"],
                           "dispatch": straight["dispatch"],
                           "losses": straight["losses"],
                           "saves": lst.saves,
                           "checkpoints": list_checkpoints(lst.path)}
        turns = []
        for i, with_lst in enumerate((False, True, True, False)):
            extra = (timed_checkpoints(os.path.join(root, f"turn{i}")),) \
                if with_lst else ()
            r = run_fit(net, x, y, TRAIN_B, init, GRAPH_K, GRAPH_PREFETCH,
                        extra=extra)
            if extra:
                extra[0].flush()
            same, _ = same_arrays(tree_arrays(r["trees"]), want)
            turns.append({"listener": with_lst, "step_ms": r["step_ms"],
                          "bitwise": same,
                          "saves": extra[0].saves if extra else None})
        rec["listener_turns"] = turns
        rec["step_ms"] = {k: [t["step_ms"] for t in turns
                              if t["listener"] == v]
                          for k, v in (("with", True), ("without", False))}
        if not all(t["bitwise"] for t in turns):
            failures.append("a turn parts from the straight run")
        del net, init, straight
        torch.cuda.empty_cache()
        # (ii) a SIGKILLed child, then a resumed one
        ck = os.path.join(root, "killed")
        proc, wall = run_child("kill", ck, "")
        steps = list_checkpoints(ck)
        killed = {"returncode": proc.returncode, "wall_s": wall,
                  "checkpoints": steps,
                  "verified": [verify_checkpoint(ck, s) for s in steps],
                  "tmp_left": sorted(n for n in os.listdir(ck)
                                     if n.startswith(".tmp-"))
                  if os.path.isdir(ck) else []}
        if proc.returncode != -signal.SIGKILL or not steps or \
                not all(killed["verified"]):
            killed["output_tail"] = (proc.stdout + proc.stderr)[-3000:]
            failures.append(f"killed child: {killed}")
        out = os.path.join(root, "resumed.npz")
        proc, wall = run_child("resume", ck, out)
        resumed = {"returncode": proc.returncode, "wall_s": wall}
        if proc.returncode == 0:
            with open(out + ".json") as f:
                resumed.update(json.load(f))
            with np.load(out) as z:
                same, bad = same_arrays(dict(z), want)
            resumed.update(bitwise=same, differ=bad)
            if not same or resumed["iteration"] != GRAPH_BATCHES:
                failures.append(f"resumed child: {resumed}")
        else:
            resumed["output_tail"] = (proc.stdout + proc.stderr)[-3000:]
            failures.append(f"resumed child: {resumed}")
        rec["killed_child"], rec["resumed_child"] = killed, resumed
        # (iii) preemption in this process
        ck = os.path.join(root, "preempted")
        net = durable_net(device)

        class Trigger:
            def iteration_done(self, model, iteration, score):
                if iteration == DURABLE_TRIGGER:
                    guard.trigger()

            def on_epoch_start(self, model, epoch):
                pass

            def on_epoch_end(self, model, epoch):
                pass

        guard = PreemptionGuard(net, ck, install=False)
        net.set_listeners(Trigger())
        exit_step, t0 = None, time.perf_counter()
        try:
            net.fit(ArrayDataSetIterator(x, y, TRAIN_B),
                    steps_per_dispatch=GRAPH_K, prefetch=GRAPH_PREFETCH)
        except PreemptionExit as e:
            exit_step = e.step
        pre_s = time.perf_counter() - t0
        guard.uninstall()
        del net
        torch.cuda.empty_cache()
        net = durable_net(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(net, ck)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        step = net.iteration_count
        net.fit(ArrayDataSetIterator(x, y, TRAIN_B), epochs=1,
                steps_per_dispatch=GRAPH_K, prefetch=GRAPH_PREFETCH)
        same, bad = same_arrays(tree_arrays(net_trees(net)), want)
        rec["preempted"] = {
            "exit_step": exit_step, "checkpoints": list_checkpoints(ck),
            "fit_until_exit_s": pre_s, "restore_s": restore_s,
            "restored_step": step, "iteration": net.iteration_count,
            "bitwise": same, "differ": bad,
            "bytes": dir_bytes(os.path.join(ck, f"step_{exit_step}"))
            if exit_step is not None else None}
        want_exit = (DURABLE_TRIGGER // GRAPH_K + 1) * GRAPH_K
        if exit_step != want_exit or not same or \
                net.iteration_count != GRAPH_BATCHES:
            failures.append(f"preempted: {rec['preempted']}")
        del net
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("durable_transformer:", json.dumps(rec))
    if failures:
        raise AssertionError(f"durable_transformer: {failures}")
    return rec


def cursored(cls):
    """``cls`` (an injector) passing the data cursor through to its base
    iterator, so a restart resumes mid-pass exactly."""
    class Cursored(cls):
        def state(self):
            return self.base.state()

        def restore_state(self, state):
            self.base.restore_state(state)
    return Cursored


def recovery_resnet(device, smi):
    """ResNet50 on the fused plan with the stem (rows 1-4, 7-10), B =
    128, bf16, Nesterovs(0.01), eager, under FaultTolerantTrainer with a
    save every 2 iterations over 8 batches (cuDNN deterministic). A
    straight run; RaiseOnBatch before global batch 5 restarts from the
    newest checkpoint and must end bitwise the straight run; NaN batches
    4 and 5 with a DivergenceWatchdog (2 bad steps in a row) and
    lr_backoff=0.5 must roll back to step 4 (the last good save: the
    trees after iteration 3) at the halved rate, whose next step is
    bitwise an eager step from the restored trees at that rate (and not
    one at the old rate)."""
    import os
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.resilience.chaos import (
        NaNPoisonIterator, RaiseOnBatch)
    from deeplearning4j_tpu_torch.resilience.watchdog import (
        DivergenceWatchdog)
    from deeplearning4j_tpu_torch.util import (
        FaultTolerantTrainer, list_checkpoints)
    x, y = graph_resnet_images(RECOVERY_BATCHES)
    root = tempfile.mkdtemp(prefix="recovery_")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    failures, rec = [], {"card": smi, "batches": RECOVERY_BATCHES,
                         "save_every": RECOVERY_EVERY}

    def make():
        net = resnet_train_net(device, torch.bfloat16, lr=GRAPH_RESNET_LR)
        net.set_fusion("bottleneck", stem=True)
        return net

    def data():
        return ArrayDataSetIterator(x, y, RESNET_B)

    def train(net, it, name, **kw):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        FaultTolerantTrainer(net, os.path.join(root, name),
                             save_every_n_iterations=RECOVERY_EVERY,
                             **kw).fit(it, epochs=1)
        torch.cuda.synchronize()
        return {"wall_s": time.perf_counter() - t0,
                "iterations": net.iteration_count,
                "checkpoints": list_checkpoints(os.path.join(root, name)),
                "launches": {k: v for k, v in read_counts().items() if v}}

    try:
        net = make()
        rec["straight"] = train(net, data(), "straight")
        want = tree_arrays(net_trees(net))
        del net
        net = make()
        it = cursored(RaiseOnBatch)(data(), n=RECOVERY_FAULT)
        rec["transient"] = train(net, it, "transient")
        same, bad = same_arrays(tree_arrays(net_trees(net)), want)
        rec["transient"].update(faults_fired=it.faults_fired, bitwise=same,
                                differ=bad)
        if not same or it.faults_fired != 1:
            failures.append(f"transient restart: {rec['transient']}")
        del net
        torch.cuda.empty_cache()
        net = make()

        class Watch:
            """Device copies of the trees at each fit's start, and of
            the parameters after iterations 3 and 4."""

            def __init__(self):
                self.starts, self.after = [], {3: [], 4: []}

            def on_epoch_start(self, model, epoch):
                self.starts.append(clone_trees(net_trees(model)))

            def on_epoch_end(self, model, epoch):
                pass

            def iteration_done(self, model, iteration, score):
                if iteration in self.after:
                    self.after[iteration].append(
                        clone_trees((model.params,))[0])

        watch = Watch()
        net.set_listeners(watch)
        wd = DivergenceWatchdog(max_consecutive_bad=2, check_every=1)
        it = cursored(NaNPoisonIterator)(data(), n=list(RECOVERY_NAN))
        rec["divergence"] = train(net, it, "divergence",
                                  save_every_epoch=False, watchdog=wd,
                                  lr_backoff=RECOVERY_BACKOFF)
        lr = net.conf.updater.learning_rate
        restored = watch.starts[-1]
        rolled_to_good = len(watch.starts) == 2 and \
            tensor_leaves((restored[0],)) and all(
                torch.equal(u, v) for u, v in zip(
                    tensor_leaves((restored[0],)),
                    tensor_leaves((watch.after[3][0],))))
        took = watch.after[4][-1]
        net.set_listeners()
        steps = {}
        for rate in (GRAPH_RESNET_LR * RECOVERY_BACKOFF, GRAPH_RESNET_LR):
            net.params, net.updater_state, net.state = clone_trees(restored)
            net.conf.updater.learning_rate = rate
            b4 = slice(RECOVERY_NAN[0] * RESNET_B,
                       (RECOVERY_NAN[0] + 1) * RESNET_B)
            net.fit(x[b4], y[b4], batch_size=RESNET_B)
            steps[rate] = all(torch.equal(u, v) for u, v in zip(
                tensor_leaves((net.params,)), tensor_leaves((took,))))
        rec["divergence"].update(
            learning_rate_after=lr, attempts=len(watch.starts),
            rolled_back_to_the_last_good=bool(rolled_to_good),
            next_step_equals_eager_step_at={str(k): v
                                            for k, v in steps.items()})
        if lr != GRAPH_RESNET_LR * RECOVERY_BACKOFF or not rolled_to_good \
                or not steps[GRAPH_RESNET_LR * RECOVERY_BACKOFF] or \
                steps[GRAPH_RESNET_LR] or rec["divergence"][
                    "checkpoints"] != [4, 6, 8]:
            failures.append(f"divergence: {rec['divergence']}")
        del net, watch
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
        shutil.rmtree(root, ignore_errors=True)
    log("recovery_resnet:", json.dumps(rec))
    if failures:
        raise AssertionError(f"recovery_resnet: {failures}")
    return rec


def h2d_exposure(events):
    """From a Chrome trace's complete events: the host-to-device copies'
    total device ms and the ms of it not overlapped by any kernel (the
    copy still on the step's critical path)."""
    copies, kernels = [], []
    for e in events:
        cat, name = e.get("cat", ""), e.get("name", "")
        span_ = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if cat == "gpu_memcpy" and "HtoD" in name:
            copies.append((span_, name))
        elif cat == "kernel":
            kernels.append(span_)
    kernels.sort()
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = exposed = 0.0
    kinds = {}
    for (a, b), name in copies:
        total += b - a
        kinds[name] = kinds.get(name, 0) + 1
        covered = sum(max(0.0, min(b, m1) - max(a, m0))
                      for m0, m1 in merged if m1 > a and m0 < b)
        exposed += (b - a) - covered
    return {"h2d_ms": total / 1e3, "h2d_exposed_ms": exposed / 1e3,
            "h2d_copies": kinds}


def copy_stalls(net, x, y, b, prefetch):
    """A steady-state prefetched fit with each batch's hand-over timed
    on the consumer's stream: an event before and after its wait on the
    batch's copy event. The first completes when the stream's earlier
    work (the previous step) is done, so the gap is how long the step
    waited for its copy: the copy's share of the critical path. Returns
    the ms of each wait."""
    from deeplearning4j_tpu_torch.pipeline import prefetch as pf
    real, pairs = pf.handover, []

    def timed(ds, stream=None):
        if getattr(ds, "copy_event", None) is None:
            return real(ds, stream)
        s = stream or torch.cuda.current_stream()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record(s)
        out = real(ds, s)
        z.record(s)
        pairs.append((a, z))
        return out
    pf.handover = timed
    try:
        run_fit(net, x, y, b, None, 1, prefetch)
    finally:
        pf.handover = real
    torch.cuda.synchronize()
    return [a.elapsed_time(z) for a, z in pairs]


def prefetch_lstm(device):
    """bench_lstm's text LSTM (bf16, B = T = 256, tBPTT: every batch
    runs by itself) through fit(prefetch=2) against fit() in turns from
    the same trees: the losses bitwise equal (prefetch changes no
    arithmetic), ms a step, the busy share, and how much of the
    host-to-device copy still sits on the step's critical path (the
    profiler's copies against its kernels)."""
    net = text_lstm_net(device, torch.bfloat16)
    x, y = text_batch(LSTM_B * PREFETCH_LSTM_BATCHES, LSTM_T, seed=3)
    init = start_of(net)
    run_fit(net, x[:LSTM_B], y[:LSTM_B], LSTM_B, init)
    runs = [run_fit(net, x, y, LSTM_B, init, 1, p) for p in (0, 2, 2, 0)]
    same = all(r["losses"] == runs[0]["losses"] for r in runs) and all(
        run_diff(r, runs[0])[0] for r in runs)
    prof = {p: profile_run(net, x, y, LSTM_B, 1, p)[0] for p in (0, 2)}
    stalls = copy_stalls(net, x, y, LSTM_B, 2)
    ms = {p: [r["step_ms"] for r in runs if r["prefetch"] == p]
          for p in (0, 2)}
    rec = {"batches": PREFETCH_LSTM_BATCHES, "batch": LSTM_B, "T": LSTM_T,
           "bytes_per_batch": 2 * LSTM_B * LSTM_VOCAB * LSTM_T * 4,
           "step_ms": ms,
           "step_ms_median": {p: float(np.median(v)) for p, v in ms.items()},
           "losses_bitwise": bool(same), "losses": runs[0]["losses"],
           "peak_allocated_bytes": {p: runs[i]["max_memory_allocated_bytes"]
                                    for i, p in ((0, 0), (1, 2))},
           "profile": {str(p): v for p, v in prof.items()},
           # without prefetch the pageable copy runs on the compute
           # stream: all of it is on the critical path
           "h2d_critical_ms_per_step": {
               "0": prof[0]["h2d_ms"] / PREFETCH_LSTM_BATCHES,
               "2": float(np.mean(stalls))},
           "copy_waits_ms": stalls}
    log("prefetch_lstm:", json.dumps(rec))
    del net
    torch.cuda.empty_cache()
    if not same or not all(np.isfinite(runs[0]["losses"])):
        raise AssertionError(f"prefetch_lstm: {rec}")
    return rec


# ---------------------------------------------------------------------
# phases 34-36: evaluation, early stopping, in-engine speculation
# ---------------------------------------------------------------------
#: evaluate: examples (two full batches of EVAL_B and a ragged one of
#: 44) and the iterator's batch, as the JAX package's evaluate wraps a
#: DataSet
EVAL_N, EVAL_B = 300, 128
#: a fuse=True argmax that differs from the xla plan's must sit where
#: the xla plan's top two logits lie within this share of the row's
#: spread: each plan's logits lie within RESNET_LOGIT of the row's
#: spread (phase 11's bf16 limit), so two plans may swap a pair whose
#: gap is under twice that, and nothing wider
EVAL_GAP = 2 * RESNET_LOGIT[torch.bfloat16]
#: the text LSTM's evaluation: examples, the labels mask's kept share
EVAL_LSTM_N, EVAL_LSTM_KEEP = 256, 0.75
#: early stopping: train batches an epoch, epochs, validation examples
ES_BATCHES, ES_EPOCHS, ES_VALID = 2, 3, 128
#: the EvaluativeListener check: its frequency, K, batches of the fit
EL_FREQ, EL_K, EL_BATCHES = 2, 4, 8
#: serve_spec: the proposer's n-gram and gamma; the f32 references'
#: depth and new tokens
SPEC_NGRAM, SPEC_GAMMA = 3, 4
SPEC_REF_LAYERS, SPEC_REF_TOKENS = 2, 48
#: a greedy bf16 stream of the speculative engine may leave the plain
#: engine's only where the plain run's top two probabilities lie within
#: this of each other (a verify at width 5 and a decode at width 1 sum
#: in different orders: a near-tie may flip, nothing else)
SPEC_GAP = 2e-2


def top_two_gap(p):
    """The gap between the two largest entries of each row of ``p``."""
    s = np.sort(np.asarray(p, np.float64), axis=-1)
    return s[..., -1] - s[..., -2]


def plan_logits(net, x, device):
    """The logits (``logits``) of the host images ``x``, EVAL_B at a
    time, as one host array."""
    return torch.cat([logits(net, torch.as_tensor(x[i:i + EVAL_B],
                                                  device=device))
                      for i in range(0, len(x), EVAL_B)]).numpy()


def eval_by_hand(net, it):
    """``Evaluation.eval`` fed the same heads ``evaluate`` reads, batch
    by batch from ``it``, with each batch's forward (to a sync) and host
    copy timed; returns (evaluation, host heads, forward s, copy s)."""
    from deeplearning4j_tpu_torch.eval import Evaluation
    ev, heads, fwd, copy = Evaluation(), [], 0.0, 0.0
    for ds in it:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net._eval_output(ds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h = out.cpu().numpy()
        fwd, copy = fwd + t1 - t0, copy + time.perf_counter() - t1
        ev.eval(ds.labels, h, mask=ds.labels_mask)
        heads.append(h)
    return ev, heads, fwd, copy


def counted_evaluate(net, data):
    """``net.evaluate(data)`` with the launch counts zeroed before it
    and read after it, timed to its end (its last host copy)."""
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = net.evaluate(data)
    return ev, time.perf_counter() - t0, read_counts()


def evaluate_phase(device, smi):
    """``evaluate`` on both networks at full width (bf16). ResNet50
    ``fuse=True`` (BN calibrated) over 300 seeded 224x224 images through
    a DataSet (batched by 128: two full batches and a ragged one of 44):
    16 fused forward launches a batch; the confusion matrix and the wire
    form equal ``Evaluation.eval`` fed the same ``output()`` heads; the
    counts sum to 300; against the xla plan's evaluation, every argmax
    that differs sits where the xla plan's top two logits lie within
    EVAL_GAP of the row's spread; ms a batch, the host copy's share. The text LSTM (T = 256, vocab 128) on
    ``[N, C, T]`` labels under a labels mask through an iterator: 2 LSTM
    forward launches a batch, held the same way."""
    from deeplearning4j_tpu_torch.datasets import (
        ArrayDataSetIterator, DataSet)
    rec = {"card": smi}
    net = fuse_true_net(device, torch.bfloat16, calibrate=True)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((EVAL_N, 3, RESNET_HW, RESNET_HW)).astype(
        np.float32)
    y = np.eye(RESNET_CLASSES, dtype=np.float32)[
        rng.integers(0, RESNET_CLASSES, EVAL_N)]
    n_batches = -(-EVAL_N // EVAL_B)
    net.evaluate(DataSet(x, y))                      # first-use costs
    ev, eval_s, counts = counted_evaluate(net, DataSet(x, y))
    ref, heads, fwd, copy = eval_by_hand(net, ArrayDataSetIterator(
        x, y, EVAL_B))
    want = {"fused_fwd": FUSE_TRUE_LAUNCHES["fused_fwd"] * n_batches}
    same = ev.to_json() == ref.to_json()
    total = int(ev.confusion.matrix.sum())
    # the xla plan's evaluation of the same images
    net.set_fusion(False)
    ev_xla = net.evaluate(DataSet(x, y))
    _, heads_xla, fwd_xla, _ = eval_by_hand(net, ArrayDataSetIterator(
        x, y, EVAL_B))
    net.set_fusion(True)
    a, b = np.concatenate(heads), np.concatenate(heads_xla)
    differ = np.flatnonzero(a.argmax(1) != b.argmax(1))
    net.set_fusion(False)
    lx = plan_logits(net, x[differ], device) if differ.size else \
        np.zeros((0, RESNET_CLASSES))
    net.set_fusion(True)
    gaps = top_two_gap(lx) / np.maximum(np.ptp(lx, axis=1), 1e-30)
    rec["resnet"] = {
        "examples": EVAL_N, "batch": EVAL_B, "batches": n_batches,
        "launches": counts, "launches_wanted": want,
        "equals_eval_of_output": same, "counts_sum": total,
        "accuracy": ev.accuracy(), "accuracy_xla": ev_xla.accuracy(),
        "argmax_differ_xla": int(differ.size),
        "differ_gaps": [float(g) for g in gaps], "gap_limit": EVAL_GAP,
        "evaluate_ms_per_batch": 1e3 * eval_s / n_batches,
        "forward_ms_per_batch": 1e3 * fwd / n_batches,
        "xla_forward_ms_per_batch": 1e3 * fwd_xla / n_batches,
        "host_copy_ms_per_batch": 1e3 * copy / n_batches,
        "host_copy_share": copy / (fwd + copy)}
    log("evaluate resnet:", json.dumps(rec["resnet"]))
    if not same or total != EVAL_N or \
            any(counts[k] != v for k, v in want.items()) or \
            (gaps >= EVAL_GAP).any():
        raise AssertionError(f"evaluate resnet: {rec['resnet']}")
    del net
    torch.cuda.empty_cache()
    # the text LSTM: [N, C, T] labels under a labels mask
    net = text_lstm_net(device, torch.bfloat16)
    x, y = text_batch(EVAL_LSTM_N, LSTM_T, seed=9)
    m = (np.random.default_rng(10).random((EVAL_LSTM_N, LSTM_T))
         < EVAL_LSTM_KEEP).astype(np.float32)
    n_batches = -(-EVAL_LSTM_N // EVAL_B)
    net.evaluate(ArrayDataSetIterator(x, y, EVAL_B, labels_mask=m))
    ev, eval_s, counts = counted_evaluate(net, ArrayDataSetIterator(
        x, y, EVAL_B, labels_mask=m))
    ref, _, fwd, copy = eval_by_hand(net, ArrayDataSetIterator(
        x, y, EVAL_B, labels_mask=m))
    want = {"lstm_fwd": LSTM_LAYERS * n_batches}
    rec["text_lstm"] = {
        "examples": EVAL_LSTM_N, "t": LSTM_T, "batches": n_batches,
        "launches": {k: counts[k] for k in ("lstm_fwd", "lstm_bwd")},
        "launches_wanted": want,
        "equals_eval_of_output": ev.to_json() == ref.to_json(),
        "counts_sum": int(ev.confusion.matrix.sum()),
        "mask_sum": int(m.sum()),
        "evaluate_ms_per_batch": 1e3 * eval_s / n_batches,
        "forward_ms_per_batch": 1e3 * fwd / n_batches,
        "host_copy_share": copy / (fwd + copy)}
    log("evaluate text_lstm:", json.dumps(rec["text_lstm"]))
    r = rec["text_lstm"]
    if not r["equals_eval_of_output"] or r["counts_sum"] != r["mask_sum"] \
            or counts["lstm_fwd"] != want["lstm_fwd"]:
        raise AssertionError(f"evaluate text_lstm: {r}")
    rec["launches"] = {k: rec["resnet"]["launches"][k] +
                       rec["text_lstm"]["launches"].get(k, 0)
                       for k in rec["resnet"]["launches"]}
    return rec


def es_images(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, RESNET_HW, RESNET_HW)).astype(np.float32)
    return x, np.eye(RESNET_CLASSES, dtype=np.float32)[
        rng.integers(0, RESNET_CLASSES, n)]


class EvalAt:
    """An EvaluativeListener that records the iteration of each of its
    evaluations."""

    def __init__(self, iterator, frequency):
        from deeplearning4j_tpu_torch.optimize import EvaluativeListener
        self.inner = EvaluativeListener(iterator, frequency=frequency)
        self.at, self.now = [], None
        real = self.inner._eval

        def record(model):
            self.at.append(self.now)
            real(model)
        self.inner._eval = record

    def iteration_done(self, model, iteration, score):
        self.now = iteration
        self.inner.iteration_done(model, iteration, score)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        self.inner.on_epoch_end(model, epoch)


def jax_eval_steps(first, n, freq):
    """The iterations at which the JAX EvaluativeListener evaluates in a
    fit of ``n`` steps from iteration ``first``."""
    return [i for i in range(first, first + n) if i > 0 and i % freq == 0]


def listener_graph_check(net, x, y, valid, label):
    """The EvaluativeListener (frequency EL_FREQ) inside
    ``fit(steps_per_dispatch=EL_K, prefetch=2)`` from the net's trees:
    it evaluates at the JAX iterations; each evaluation equals
    ``evaluate()`` of an eager fit from the same trees stopped at the end
    of that evaluation's group; the graph fit's losses and trees are
    bitwise those of the same graph fit without the listener, and its
    training generator ends where that fit's does."""
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    t0 = time.perf_counter()
    init = start_of(net)
    b = x.shape[0] // EL_BATCHES
    first = net.iteration_count
    lst = EvalAt(ArrayDataSetIterator(*valid, b), EL_FREQ)
    with_l = run_fit(net, x, y, b, init, k=EL_K, prefetch=2, extra=(lst,))
    gen_with = net._train_gen.get_state()
    net.iteration_count = first
    without = run_fit(net, x, y, b, init, k=EL_K, prefetch=2)
    gen_without = net._train_gen.get_state()
    same, worst = run_diff(with_l, without)
    want_at = jax_eval_steps(first, EL_BATCHES, EL_FREQ)
    # eager fits stopped at each group's end
    group_eval = {}
    net._drop_step_graph()
    net.params, net.updater_state, net.state = clone_trees(init[:3])
    net._train_gen.set_state(init[3])
    net.iteration_count = first
    for g in range(EL_BATCHES // EL_K):
        sl = slice(g * EL_K * b, (g + 1) * EL_K * b)
        net.fit(x[sl], y[sl], batch_size=b, pad_tail=True)
        group_eval[g] = net.evaluate(ArrayDataSetIterator(*valid, b))
    equal = [lst.inner.evaluations[i].to_json()
             == group_eval[(it - first) // EL_K].to_json()
             for i, it in enumerate(lst.at)]
    rec = {"net": label, "evaluated_at": lst.at, "jax_steps": want_at,
           "evals_equal_eager_group_end": equal,
           "losses_bitwise_without_listener": same, "worst": worst,
           "train_gen_same": bool(torch.equal(gen_with, gen_without)),
           "dispatch": with_l["dispatch"],
           "wall_s": time.perf_counter() - t0}
    log("early_stop listener:", json.dumps(rec))
    if lst.at != want_at or not all(equal) or not same or \
            not rec["train_gen_same"] or not with_l["dispatch"].get(
                "replays"):
        raise AssertionError(f"EvaluativeListener in the graph: {rec}")
    return rec


def early_stop(device, smi):
    """``EarlyStoppingTrainer`` on ResNet50 ``fuse=True`` (bf16, BN
    calibrated, Nesterovs(0.01)) at B = 128: ES_EPOCHS epochs of
    ES_BATCHES batches, ``ClassificationScoreCalculator`` over 128
    validation images, ``LocalFileModelSaver`` and
    ``MaxEpochsTerminationCondition``: the restored best model's logits
    (the inference forward before the softmax, which a bf16 softmax over
    1000 classes would hide) equal those recorded at its save, bitwise.
    An ``InMemoryModelSaver`` run: its best copy's logits unchanged after
    the source trains two more steps and two K=2 graph fits (the second
    replays, writing the source's parameters in place). Then
    ``listener_graph_check`` on the same net, and on the drawing MLP of
    ``fit_graph_draws`` (an evaluation between replays moves no
    generator offset). cuDNN runs its deterministic algorithms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return early_stop_runs(device, smi)
    finally:
        torch.backends.cudnn.deterministic = prev


def early_stop_runs(device, smi):
    """``early_stop``'s runs (cuDNN deterministic, so that an eager fit
    and a graph fit agree bit for bit)."""
    import tempfile
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import ArrayDataSetIterator
    rec = {"card": smi}
    net = fuse_true_net(device, torch.bfloat16, lr=GRAPH_RESNET_LR,
                        calibrate=True)
    x, y = es_images(ES_BATCHES * RESNET_B, seed=31)
    valid = es_images(ES_VALID, seed=32)
    probe = images(16, device, seed=33)

    class Recording(es.LocalFileModelSaver):
        def save_best(self, model, score):
            super().save_best(model, score)
            self.at_save = logits(model, probe)

    zero_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dl4j_es_") as tmp:
        saver = Recording(tmp, device=device)
        cfg = es.EarlyStoppingConfiguration(
            epoch_termination_conditions=[
                es.MaxEpochsTerminationCondition(ES_EPOCHS)],
            score_calculator=es.ClassificationScoreCalculator(
                ArrayDataSetIterator(*valid, RESNET_B)),
            model_saver=saver)
        res = es.EarlyStoppingTrainer(cfg, net, ArrayDataSetIterator(
            x, y, RESNET_B)).fit()
        es_s = time.perf_counter() - t0
        counts = read_counts()
        best = res.best_model
        best.set_fusion(True)
        restored_same = torch.equal(logits(best, probe), saver.at_save)
        archive_bytes = sum(os.path.getsize(os.path.join(tmp, f))
                            for f in os.listdir(tmp))
    del best
    rec["trainer"] = {
        "termination": [res.termination_reason, res.termination_details],
        "total_epochs": res.total_epochs, "best_epoch": res.best_model_epoch,
        "scores": {int(k): float(v) for k, v in res.score_vs_epoch.items()},
        "restored_output_bitwise": restored_same,
        "archive_bytes": archive_bytes, "wall_s": es_s,
        "launches": counts}
    log("early_stop trainer:", json.dumps(rec["trainer"]))
    want = FUSE_TRUE_TRAIN_LAUNCHES["fused_bwd"] * ES_BATCHES * ES_EPOCHS
    if not restored_same or res.total_epochs != ES_EPOCHS or \
            counts["fused_bwd"] != want or counts["fused_fwd"] == 0:
        raise AssertionError(f"early stopping: {rec['trainer']}")
    # the in-memory best copy while the source trains on
    t0 = time.perf_counter()
    mem = es.InMemoryModelSaver()
    cfg = es.EarlyStoppingConfiguration(
        epoch_termination_conditions=[es.MaxEpochsTerminationCondition(1)],
        model_saver=mem)
    es.EarlyStoppingTrainer(cfg, net, ArrayDataSetIterator(
        x, y, RESNET_B)).fit()
    copy = mem.get_best()
    at_copy = logits(copy, probe)
    net.fit(x, y, batch_size=RESNET_B)
    d0 = dict(net.fit_dispatch)
    x4, y4 = np.concatenate([x, x]), np.concatenate([y, y])
    for _ in range(2):
        net.fit(x4, y4, batch_size=RESNET_B, steps_per_dispatch=2)
    replays = net.fit_dispatch["replays"] - d0.get("replays", 0)
    rec["in_memory"] = {
        "copy_unchanged": torch.equal(logits(copy, probe), at_copy),
        "source_moved": not torch.equal(logits(net, probe), at_copy),
        "source_replays": replays, "wall_s": time.perf_counter() - t0}
    log("early_stop in memory:", json.dumps(rec["in_memory"]))
    if not rec["in_memory"]["copy_unchanged"] or \
            not rec["in_memory"]["source_moved"] or replays == 0:
        raise AssertionError(f"copy_model: {rec['in_memory']}")
    del copy, mem
    net._drop_step_graph()
    torch.cuda.empty_cache()
    xl, yl = es_images(EL_BATCHES * RESNET_B, seed=34)
    rec["listener_resnet"] = listener_graph_check(
        net, xl, yl, valid, "resnet50_fuse_true")
    del net
    torch.cuda.empty_cache()
    mlp = draws_mlp(device)
    rng = np.random.default_rng(35)
    xm = rng.standard_normal((EL_BATCHES * 32, 64)).astype(np.float32)
    ym = np.eye(10, dtype=np.float32)[rng.integers(0, 10, len(xm))]
    vm = (xm[:64], ym[:64])
    rec["listener_draws_mlp"] = listener_graph_check(mlp, xm, ym, vm,
                                                     "draws_mlp")
    return rec


def spec_engine(net, device, kv, spec):
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig, SpeculationConfig)
    from deeplearning4j_tpu_torch.util.decoding import (
        prompt_lookup_proposer)
    return replay_calls(GenerationEngine(
        net, VOCAB, slots=SLOTS, device=device,
        paging=PagedKVConfig(page_size=PAGE, kv_dtype=kv),
        speculation=SpeculationConfig(prompt_lookup_proposer(SPEC_NGRAM),
                                      gamma=SPEC_GAMMA) if spec else None))


def spec_reference(device):
    """In f32 at SPEC_REF_LAYERS layers of the served width: the
    speculative engine's greedy streams equal the plain engine's with a
    bf16 and with an int8 pool (and, unquantized, one-shot
    ``sample_stream``'s), the paged kernels launched by the verify."""
    model, net = served_net(device, layers=SPEC_REF_LAYERS,
                            dtype="float32", seed=11)
    rng = np.random.default_rng(41)
    motif = [int(t) for t in rng.integers(1, VOCAB, 12)]
    prompts = [motif * 4, [int(t) for t in rng.integers(1, VOCAB, 40)],
               motif[:5] * 3 + [7], [int(t) for t in rng.integers(1, VOCAB,
                                                                    9)]]
    rec = {"layers": SPEC_REF_LAYERS, "dtype": "float32"}
    for kv in ("bf16", "int8"):
        runs = {}
        for spec in (False, True):
            eng = spec_engine(net, device, kv, spec)
            hs = [eng.submit(p, steps=SPEC_REF_TOKENS, top_k=1)
                  for p in prompts]
            # in the trace: the replays and the capture's warm-up pass
            # (the capture itself launches nothing)
            _, c = counted(eng, eng.run_until_idle)
            key = "paged_attention_quant" if kv == "int8" \
                else "paged_attention"
            runs[spec] = ([h.result(timeout=0) for h in hs],
                          c["launches"][key],
                          eng.dispatches + eng.graph_captures,
                          eng.spec_accepted)
        rec[kv] = {"equal": runs[True][0] == runs[False][0],
                   "verify_launches": runs[True][1],
                   # the dispatches and the captures' warm-up passes
                   "verify_dispatches": runs[True][2],
                   "accepted": runs[True][3]}
        if kv == "bf16":
            want = [model.sample_stream(net, p, steps=SPEC_REF_TOKENS,
                                        top_k=1) for p in prompts]
            rec[kv]["equal_sample_stream"] = runs[True][0] == want
        r = rec[kv]
        if not r["equal"] or not r.get("equal_sample_stream", True) or \
                not trace_holds({key: r["verify_launches"]}, {
                    key: SPEC_REF_LAYERS * r["verify_dispatches"]}) or \
                r["accepted"] == 0:
            raise AssertionError(f"serve_spec reference: {rec}")
    log("serve_spec reference:", json.dumps(rec))
    return rec


def first_divergence(net, plain, spec, prompt):
    """The first generated position where ``spec`` leaves ``plain``, and
    the top-two gap of the plain stream's distribution there (one-shot
    ``output()`` over the plain prefix)."""
    n = len(prompt)
    d = next((i for i, (a, b) in enumerate(zip(plain[n:], spec[n:]))
              if a != b), None)
    if d is None:
        return None, None
    ids = plain[:n + d]
    x = np.zeros((1, VOCAB, len(ids)), np.float32)
    x[0, ids, np.arange(len(ids))] = 1.0
    p = net.output(x)[0, :, -1].float().cpu().numpy()
    return d, float(top_two_gap(p))


def profile_spec(net, device, kv, steps=20):
    """``torch.profiler`` over ``steps`` verify steps with all slots
    decoding: the device's busy share, CUDA kernel launches a step, the
    tokens each step commits, the paged kernels' share (launches the
    trace's records, device time ``key_averages()``'s)."""
    eng = spec_engine(net, device, kv, True)
    rng = np.random.default_rng(43)
    for _ in range(SLOTS):
        motif = [int(t) for t in rng.integers(1, VOCAB, 24)]
        eng.submit(motif * 8, steps=600, top_k=1)
    for _ in range(3):
        eng.step()
    t0 = eng.tokens_generated
    with traced(cpu=True) as t:
        w0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    prof = t.prof
    tokens = eng.tokens_generated - t0
    if sum(r is not None for r in eng._slots) != SLOTS:
        raise AssertionError("profile_spec: the engine stopped decoding")
    eng.shutdown()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and "spin_kernel" not in e.key]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in kernels}
    busy = sum(dev_us.values())
    launches = t.kernels
    rows = {r: n / steps for r, n in t.rows.items()}
    key = "paged_attention_quant" if kv == "int8" else "paged_attention"
    if not trace_holds(t.rows, {key: LAYERS * steps}):
        raise AssertionError(f"profile_spec: {rows} a step in the trace")
    return {"kv": kv, "steps": steps, "step_ms": 1e3 * wall / steps,
            "row_launches_per_step": rows,
            "device_busy_share": busy / (wall * 1e6),
            "kernel_launches_per_step": launches / steps,
            "tokens_per_step": tokens / steps,
            "kernel_launches_per_token": launches / max(1, tokens),
            "paged_kernel_share_of_device_time":
                sum(t for k, t in dev_us.items() if "paged_decode" in k)
                / busy if busy else None}


def serve_spec(device, smi):
    """Phase 4's configuration and traffic (16 requests of 128 new
    tokens, bf16, 8 slots, page 16) through the speculative engine
    (``prompt_lookup_proposer(3)``, gamma 4) and the plain engine in
    turns (spec, plain, plain, spec), over a bf16 and an int8 pool, then
    a traced speculative turn, in whose trace every verify dispatch
    launches the pool's paged kernel once a layer (6) at query width 1 +
    gamma; tokens/s, TPOT p50, acceptance and
    tokens a step; each greedy request's first divergence from the plain
    engine at a top-two gap under SPEC_GAP. Then a profile of each and
    the f32 reference (``spec_reference``)."""
    model, net = served_net(device)
    requests = serve_requests(np.random.default_rng(1))
    rec = {"card": smi, "gamma": SPEC_GAMMA, "ngram": SPEC_NGRAM}
    for kv in ("bf16", "int8"):
        t0 = time.perf_counter()
        key = "paged_attention_quant" if kv == "int8" else "paged_attention"
        turns = {True: [], False: []}
        outs = {}
        # the timed turns, then a traced speculative turn for its launches
        for i, spec in enumerate((True, False, False, True, True)):
            trace = i == 4
            eng = spec_engine(net, device, kv, spec)
            eng.warmup(max_prompt_len=300)
            a0, p0 = eng.spec_accepted, eng.spec_proposed
            r = serve_turn(eng, requests, keep_outs=True, trace=trace)
            n = r["decode_dispatches"]
            r.update(accepted=eng.spec_accepted - a0,
                     proposed=eng.spec_proposed - p0,
                     tokens_per_step=N_REQUESTS * NEW_TOKENS / max(1, n))
            # every dispatch one replay of the one width's graph (its
            # capture in the warm-up); in the trace, one graph launch a
            # dispatch whose replay runs the paged kernel once a layer
            want_w = [1 + SPEC_GAMMA if spec else 1]
            if n == 0 or r["graph_widths"] != want_w or r["captures"] or \
                    r["replays"] != n or trace and not trace_holds(
                        {key: r["launches"][key],
                         "graphs": r["graph_launches"]},
                        {key: n * LAYERS, "graphs": n}):
                raise AssertionError(f"serve_spec {kv} spec={spec}: "
                                     f"{r.get('launches', {}).get(key)} "
                                     f"launches in the trace, graphs "
                                     f"{r['graph_widths']}, "
                                     f"{r['captures']} captures, "
                                     f"{r['replays']} replays for {n} "
                                     f"dispatches")
            o = r.pop("outs")
            if trace:
                counted_turn = r
                continue
            turns[spec].append(r)
            outs[spec] = o
            log(f"serve_spec {kv} {'spec' if spec else 'plain'} turn:",
                json.dumps({k: v for k, v in r.items() if k != "launches"}
                           | {"card": smi}))
        divergence = []
        for i, (p, kw) in enumerate(requests):
            if kw.get("top_k") != 1:
                continue
            d, gap = first_divergence(net, outs[False][i], outs[True][i], p)
            divergence.append({"request": i, "first": d, "gap": gap})
        bad = [v for v in divergence if v["gap"] is not None
               and v["gap"] >= SPEC_GAP]
        med = {s: {k: float(np.median([t[k] for t in turns[s]]))
                   for k in ("tokens_per_s", "tpot_p50_ms", "decode_step_ms",
                             "ttft_p50_ms", "tokens_per_step")}
               for s in (True, False)}
        acc = sum(t["accepted"] for t in turns[True]) / max(
            1, sum(t["proposed"] for t in turns[True]))
        rec[kv] = {"spec": med[True], "plain": med[False],
                   "acceptance": acc, "divergence": divergence,
                   "gap_limit": SPEC_GAP,
                   "launches_per_verify_step": LAYERS,
                   "verify_launches": counted_turn["launches"][key],
                   "counted_turn": counted_turn,
                   "turns": {"spec": turns[True], "plain": turns[False]}}
        log(f"serve_spec {kv}:", json.dumps(
            {k: v for k, v in rec[kv].items()
             if k not in ("turns", "counted_turn")}
            | {"card": smi}))
        if bad:
            raise AssertionError(f"serve_spec {kv}: streams left the plain "
                                 f"engine's at wide gaps: {bad}")
        rec[kv]["profile"] = profile_spec(net, device, kv)
        rec[kv]["wall_s"] = time.perf_counter() - t0
        log(f"serve_spec {kv} profile:", json.dumps(rec[kv]["profile"]
                                                     | {"card": smi}))
    del net
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["reference"] = spec_reference(device)
    rec["reference"]["wall_s"] = time.perf_counter() - t0
    return rec


# ---------------------------------------------------------------------
# phases 37-39: the survivable engine (supervisor, chaos seams,
# decode_retry, registry), overload control and drain, the LSTM arena
# ---------------------------------------------------------------------
#: serve_survive: the decode dispatches that fault, the dispatch whose
#: chaos event seizes every free page, the admission whose pop-to-seat
#: window faults, the dispatch the retried run's transient fault hits
SURVIVE_FAULTS, SURVIVE_SEIZE, SURVIVE_SEAT, SURVIVE_RETRY = \
    (40, 110, 180), 20, 5, 60
#: a stream after a rebuild may leave the unperturbed run's only where
#: the unperturbed distribution was within this of a flip: a greedy
#: row's top-two gap, a sampled row's draw this close to a boundary of
#: its filtered cdf (the re-prime computes the survivors' K/V in one
#: prefill where the unperturbed run took them a step at a time: the
#: serve_spec rule)
SURVIVE_GAP = SPEC_GAP
#: a rebuild may keep at most this many allocated bytes outside the
#: decode graphs' pools beyond the old arena's (its graph's token buffer
#: is a 512-byte block of the default pool, freed with the graph). Less
#: is no fault: the old arena is gone
REBUILD_BYTES = 2048
#: the C9 bait: a free cached block this much larger than one of the
#: int8 pools, planted just before the supervised int8 run's first
#: rebuild. The caching allocator hands a large request the smallest
#: free block that fits, whole when less than 1 MiB would be left, and
#: counts it whole: a rebuild that allocated the store anew read +515,584
#: B with it (ROADMAP.md C9); the engine zeroes the store in place
C9_BAIT_EXTRA = 516096
#: the largest |log p| difference a survivor's distribution after a
#: rebuild may show against the unperturbed run's at a context both
#: share (bf16: one prefill against decode steps). Set from
#: serve_survive's readings on an H100: sound paths read at most 0.053
#: (a rebuilt row) and 0.037 (a one-shot forward of the same context),
#: a context with its first token dropped at least 0.69
SURVIVE_LOGP = 0.15
#: serve_overload: requests (two waves), new tokens, the page budget in
#: tokens (93 pages: four requests of 23 pages and one page free, under
#: the 3% of rung 3), the TTFT objective (a request that waits for a
#: slot misses it: sustained breach, shedding)
OVERLOAD_WAVES, OVERLOAD_NEW = (32, 16), 64
OVERLOAD_TOKENS, OVERLOAD_TTFT_SLO = 93 * PAGE, 0.05
#: the brownout ladder's free-page thresholds for this pool
OVERLOAD_FRACS = (0.15, 0.08, 0.03)
#: serve_lstm: requests, new tokens, and the f32 reference's
SERVE_LSTM_N, SERVE_LSTM_NEW = 16, 256
SERVE_LSTM_REF_N, SERVE_LSTM_REF_NEW = 4, 64


class ChaosChain:
    """A ``decode_chaos`` of several injectors, each consulted in turn
    at every dispatch (``resilience.chaos.fire`` drives each)."""

    def __init__(self, *parts):
        self.parts = list(parts)
        self.batches_seen = 0

    def before_batch(self, index):
        from deeplearning4j_tpu_torch.resilience import chaos
        for p in self.parts:
            chaos.fire(p, index)


#: the engine's registry handles (serve_survive's cost turns swap them)
HANDLE_ATTRS = ("_tokens", "_ttft_hist", "_tpot_hist", "_queue_wait_hist",
                "_dispatch_hist", "_kv_bytes", "_prefix_hits",
                "_prefix_misses", "_prefix_reused")


class _NullHandle:
    """A metric handle that records nothing (the handles-off turns of
    serve_survive)."""

    def inc(self, *args, **kwargs):
        pass

    observe = observe_many = inc


class _TimedHandle:
    """A metric handle that forwards to ``h`` and adds the seconds and
    the calls spent inside it to ``acc``."""

    def __init__(self, h, acc):
        self._h, self._acc = h, acc

    def __getattr__(self, name):
        f, acc = getattr(self._h, name), self._acc

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                acc[0] += time.perf_counter() - t0
                acc[1] += 1
        return timed


def swap_handles(eng, make):
    """Replace each of ``eng``'s registry handles ``h`` by ``make(h)``."""
    for name in HANDLE_ATTRS:
        if hasattr(eng, name):
            setattr(eng, name, make(getattr(eng, name)))
    eng._handles = {k: make(v) for k, v in eng._handles.items()}


def survive_engine(net, device, kv, **kw):
    from deeplearning4j_tpu_torch.monitoring.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    kw.setdefault("registry", MetricsRegistry())
    eng = replay_calls(GenerationEngine(
        net, VOCAB, slots=SLOTS, device=device, name=f"engine:survive_{kv}",
        paging=PagedKVConfig(page_size=PAGE, kv_dtype=kv), **kw))
    eng.warmup(max_prompt_len=300)
    return eng


def drive(eng, requests, new_tokens=NEW_TOKENS, draws=None):
    """Submit every request up front and step the engine by hand to idle
    (deterministic dispatch indices for the chaos seams): the handles,
    the wall seconds, the tokens generated and the decode dispatches.
    With ``draws`` (a dict), every draw the engine makes is kept under
    its request's index, in order: the rng's state before the draw and
    the distribution drawn from."""
    from deeplearning4j_tpu_torch.serving import engine as engine_mod
    rngs = [np.random.default_rng(i) for i in range(len(requests))]
    real = engine_mod.draw
    if draws is not None:
        owner = {id(g): i for i, g in enumerate(rngs)}

        def kept(probs, temperature, rng, **kw):
            draws.setdefault(owner[id(rng)], []).append(
                (rng.bit_generator.state, np.array(probs)))
            return real(probs, temperature, rng, **kw)
        engine_mod.draw = kept
    d0 = eng.dispatches
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = [eng.submit(p, steps=new_tokens, rng=rngs[i], **kw)
              for i, (p, kw) in enumerate(requests)]
        eng.run_until_idle()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        engine_mod.draw = real
    return hs, {"wall_s": dt,
                "tokens_per_s": sum(len(h.generated) for h in hs) / dt,
                "dispatches": eng.dispatches - d0}


def first_flip(net, plain, other, prompt, sampling, seed):
    """Where ``other`` first leaves ``plain`` (a generated index, None if
    never) and how close the unperturbed distribution was to a flip
    there (one-shot ``output()`` over the plain prefix): a greedy row's
    top-two gap, a sampled row's distance from its draw (the request's
    rng replayed: one uniform a generated token) to the nearest boundary
    of its filtered cdf."""
    from deeplearning4j_tpu_torch.util.decoding import _vocab, filter_probs
    n = len(prompt)
    d = next((i for i, (a, b) in enumerate(zip(plain[n:], other[n:]))
              if a != b), None)
    if d is None:
        return None, None
    ids = plain[:n + d]
    V = _vocab(net)
    x = np.zeros((1, V, len(ids)), np.float32)
    x[0, ids, np.arange(len(ids))] = 1.0
    net.rnn_clear_previous_state()
    p = net.output(x)[0, :, -1].float().cpu().numpy().astype(np.float64)
    if sampling.get("top_k") == 1:
        return d, float(top_two_gap(p))
    q = filter_probs(p, sampling.get("temperature", 1.0),
                     sampling.get("top_k"), sampling.get("top_p"))
    u = np.random.default_rng(seed).random(d + 1)[d]
    cdf = np.cumsum(q)
    cdf /= cdf[-1]
    return d, float(np.min(np.abs(cdf - u)))


def flips(net, plain, other, requests):
    """``first_flip`` of every request; the ones past SURVIVE_GAP."""
    out = []
    for i, (p, kw) in enumerate(requests):
        d, margin = first_flip(net, plain[i], other[i], p, kw, i)
        out.append({"request": i, "first": d, "margin": margin,
                    "sampled": kw.get("top_k") != 1})
    bad = [f for f in out if f["first"] is not None
           and f["margin"] >= SURVIVE_GAP]
    return out, bad


def logp_distance(p, q):
    """The largest |log p - log q| over the tokens both give mass."""
    m = (p > 0) & (q > 0)
    return float(np.max(np.abs(np.log(p[m].astype(np.float64))
                               - np.log(q[m].astype(np.float64)))))


def explain_flips(plain_draws, draws, plain, other, requests):
    """Hold a rebuilt run's draws against the unperturbed run's (both
    kept by ``drive``), request by request:

    - one draw a generated token in each run, and the rng's state
      before every draw equal to the unperturbed run's (exact: a
      survivor re-admitted with a shifted rng fails here);
    - at every context the two runs share (up to the first flip), the
      two distributions within SURVIVE_LOGP of each other in
      log-probability (a wrongly re-primed row reads another context);
    - each flip explained by that distance alone: a greedy row's new
      token is the unperturbed distribution's runner-up at a top-two gap
      under SURVIVE_GAP; a sampled row's draw, replayed from the shared
      rng state on each run's distribution, gives each run's token (its
      uniform lies between the two runs' cdf boundaries).

    Returns each request's readings, the closest two neighbouring
    contexts of the unperturbed run came in log-probability (what a
    context one token off would read), and the faults."""
    from deeplearning4j_tpu_torch.util.decoding import draw, filter_probs
    out, faults, neighbour = [], [], float("inf")
    for i, (prompt, kw) in enumerate(requests):
        n = len(prompt)
        a, b = plain_draws.get(i, []), draws.get(i, [])
        ga, gb = plain[i][n:], other[i][n:]
        f = {"request": i, "sampled": kw.get("top_k") != 1, "first": None}
        out.append(f)
        if len(a) != len(ga) or len(b) != len(gb):
            faults.append(f"request {i}: {len(a)} and {len(b)} draws for "
                          f"{len(ga)} and {len(gb)} tokens")
            continue
        shift = next((k for k, (x, y) in enumerate(zip(a, b))
                      if x[0] != y[0]), None)
        if shift is not None:
            faults.append(f"request {i}: the rng's state differs before "
                          f"draw {shift}")
        d = next((k for k, (x, y) in enumerate(zip(ga, gb)) if x != y),
                 None)
        last = min(len(a), len(b)) - 1 if d is None else d
        f["first"] = d
        f["logp"] = max((logp_distance(a[k][1], b[k][1])
                         for k in range(last + 1)), default=0.0)
        if last:
            neighbour = min(neighbour, min(
                logp_distance(a[k][1], a[k - 1][1])
                for k in range(1, last + 1)))
        if f["logp"] >= SURVIVE_LOGP:
            faults.append(f"request {i}: the distributions differ by "
                          f"{f['logp']} in log-probability")
        if d is None:
            continue
        pa, pb = a[d][1], b[d][1]
        if not f["sampled"]:
            second = np.sort(pa)[-2]
            f["gap"] = float(pa.max() - second)
            if pa[gb[d]] != second or f["gap"] >= SURVIVE_GAP:
                faults.append(f"request {i}: greedy token {gb[d]} at "
                              f"{d} is not the runner-up at a near-tie: "
                              f"{f}")
            continue
        temp, top_k, top_p = (kw.get("temperature", 1.0), kw.get("top_k"),
                              kw.get("top_p"))
        made = []
        for p in (pa, pb):
            g = np.random.default_rng()
            g.bit_generator.state = a[d][0]
            made.append(draw(p, temp, g, top_k=top_k, top_p=top_p))
        g = np.random.default_rng()
        g.bit_generator.state = a[d][0]
        u = g.random()
        cdf = np.cumsum(filter_probs(pa, temp, top_k, top_p)
                        .astype(np.float64))
        cdf /= cdf[-1]
        lo = cdf[ga[d] - 1] if ga[d] else 0.0
        f["margin"] = float(min(u - lo, cdf[ga[d]] - u))
        if made != [ga[d], gb[d]]:
            faults.append(f"request {i}: the shared draw gives {made}, the "
                          f"runs {[ga[d], gb[d]]} at {d}")
    return out, neighbour, faults


def context_readings(net, plain, requests, plain_draws):
    """Two readings that place SURVIVE_LOGP, each request at the middle
    of its generated stream, against the unperturbed run's decode-step
    distribution there: a one-shot ``output()`` over the same context
    (another sound path, as a re-prime is) and over the context with
    its first token dropped (a planted re-prime fault). Returns the
    largest sound and the smallest planted distance."""
    from deeplearning4j_tpu_torch.util.decoding import _vocab
    V = _vocab(net)

    def dist(ids):
        x = np.zeros((1, V, len(ids)), np.float32)
        x[0, ids, np.arange(len(ids))] = 1.0
        net.rnn_clear_previous_state()
        return net.output(x)[0, :, -1].float().cpu().numpy()
    sound, planted = 0.0, float("inf")
    for i, (prompt, _) in enumerate(requests):
        k = len(plain_draws[i]) // 2
        ids, p = plain[i][:len(prompt) + k], plain_draws[i][k][1]
        sound = max(sound, logp_distance(p, dist(ids)))
        planted = min(planted, logp_distance(p, dist(ids[1:])))
    net.rnn_clear_previous_state()
    return sound, planted


def kv_tok_bytes(kv):
    """The bytes of one position over every paged leaf (k and v of each
    layer) and an int8 pool's scale row over every leaf, from the
    served configuration."""
    item = 1 if kv == "int8" else 2
    d = WIDTH // HEADS
    return (LAYERS * 2 * HEADS * d * item,
            LAYERS * 2 * HEADS * 4 if kv == "int8" else 0)


def kernel_kv_tally(eng, rec):
    """Tally the KV bytes the paged kernel's own inputs say each dispatch
    moves, read back from the card before each replay of the decode
    graph (the graph's fixed page table and each paged layer's
    ``kv_pos``, whose sum with the query width is the kernel's lengths;
    not the engine's host positions its model reads): each row whose
    table maps a page reads its pages up to its length, page-rounded, at
    most the table's span; every row appends its query width; an int8
    pool reads one scale row a live page. Every paged leaf (k and v of
    each layer) a replay; a faulted dispatch replays nothing. Returns
    the undo."""
    real = eng._replay

    def tallied(chunk):
        width = int(chunk.shape[1])
        table = eng._tables()
        ps = eng._ps
        span = table.shape[1] * ps
        mapped = (table != 0).any(1).cpu().tolist()
        for (name, _), pool in zip(eng._paged_keys, eng._page_store):
            lengths = (eng.net.state[name]["kv_pos"] + width).cpu().tolist()
            live = sum(min(-(-n // ps) * ps, span)
                       for n, m in zip(lengths, mapped) if m)
            hkv, d = pool.shape[1], pool.shape[3]
            tok = hkv * d * pool.element_size()
            row = 0 if eng._scale_store is None else hkv * 4
            rec["dispatch_bytes"] += (live + len(lengths) * width) * tok \
                + (live // ps) * row
        return real(chunk)
    eng._replay = tallied
    return lambda: setattr(eng, "_replay", real)


def kv_admission_bytes(handles, kv):
    """The model's bytes of the admissions (and re-admissions) in the
    handles' traces: a bf16 prime's commit of the primed row (MAX_LEN
    positions) and, on a prefix hit, its gather (MAX_LEN more); an int8
    prime's read of the context and append (MAX_LEN + fed)."""
    tb, _ = kv_tok_bytes(kv)
    total = 0
    for h in handles:
        start = None
        for r in h.trace().events():
            if r["event"] == "prefill_start":
                start = r
            elif r["event"] == "seat" and start is not None:
                if kv == "int8":
                    total += (MAX_LEN + start["width"]) * tb
                else:
                    total += MAX_LEN * tb * (2 if start["prefix_hit"] else 1)
                start = None
    return total


def free_large_blocks():
    """The sizes of the default pool's free large blocks."""
    return sorted(b["size"] for seg in torch.cuda.memory_snapshot()
                  if tuple(seg.get("segment_pool_id") or (0, 0)) == (0, 0)
                  and seg["segment_type"] == "large"
                  for b in seg["blocks"] if b["state"] == "inactive")


def plant_bait(size):
    """Leave a free block of exactly ``size`` bytes in the caching
    allocator (the bait taken, the free rest of its segment taken by a
    filler, the bait freed); returns (planted, the fillers to free after
    the measurement)."""
    fillers = []
    for _ in range(4):
        bait = torch.empty(size, dtype=torch.uint8, device="cuda")
        seg = next(s for s in torch.cuda.memory_snapshot()
                   if s["address"] <= bait.data_ptr()
                   < s["address"] + s["total_size"])
        off = seg["address"]
        for b in seg["blocks"]:
            if off == bait.data_ptr() + size and b["state"] == "inactive":
                fillers.append(torch.empty(b["size"], dtype=torch.uint8,
                                           device="cuda"))
            off += b["size"]
        del bait
        if size in free_large_blocks():
            return True, fillers
    return False, fillers


def timed_rebuilds(eng, out, bait=False):
    """Record each rebuild of ``eng``: its wall ms, its survivors, and
    the card's allocated bytes as it starts (the old arena still held)
    and as it ends (the new one primed), each with the part held in the
    decode graphs' private pools (the old graphs' outputs before it;
    none after it: the next dispatch captures anew). Earlier phases'
    dead engines wait in reference cycles: one collection now, and the
    cyclic collector off inside each rebuild, so a rebuild's bytes are
    its own (a collection inside one freed 201.7 MB of them in one run
    on the card), and the old arena must go by reference counts
    alone. With ``bait``, the first rebuild's record notes the C9 bait
    planted just before it (``plant_bait``: a pool's bytes plus
    C9_BAIT_EXTRA; its filler, held across the measurement, is freed
    after it)."""
    import gc
    gc.collect()
    real = eng._quarantine_rebuild

    def timed(exc=None):
        was = gc.isenabled()
        gc.disable()
        fillers = []
        try:
            torch.cuda.synchronize()
            planted = None
            if bait and not out:
                size = eng._page_store[0].untyped_storage().nbytes() + \
                    C9_BAIT_EXTRA
                ok, fillers = plant_bait(size)
                planted = {"bytes": size, "planted": ok}
            m0, g0, t0 = torch.cuda.memory_allocated(), \
                graph_pool_bytes(), time.perf_counter()
            n = real(exc)
            torch.cuda.synchronize()
            out.append({"wall_ms": 1e3 * (time.perf_counter() - t0),
                        "survivors": n, "allocated_before": m0,
                        "graph_pool_before": g0,
                        "allocated_after": torch.cuda.memory_allocated(),
                        "graph_pool_after": graph_pool_bytes(),
                        "graphs_after": len(eng._graphs),
                        **({"c9_bait": planted} if planted else {})})
        finally:
            del fillers
            if was:
                gc.enable()
        return n
    eng._quarantine_rebuild = timed


def rebuild_kept(b):
    """A rebuild's allocated bytes outside the graph pools, after less
    before (the new arena against the old)."""
    return (b["allocated_after"] - b["graph_pool_after"]) - \
        (b["allocated_before"] - b["graph_pool_before"])


def pool_bytes(eng):
    return sum(t.numel() * t.element_size()
               for t in list(eng._page_store) + list(eng._scale_store or ()))


def serve_survive(device, smi):
    """Phase 4's configuration and traffic (16 requests, 128 new tokens,
    bf16, 8 slots, page 16, prefix cache) driven by hand, over a bf16 and
    an int8 pool: an unperturbed run, then a supervised run with three
    decode faults (``FaultBurstInjector``s at SURVIVE_FAULTS), one
    ``PageExhaustionInjector`` seizure and one seat-window fault. Every
    request's draws hold against the unperturbed run's
    (``explain_flips``: the rng's state exact, the distributions within
    SURVIVE_LOGP, each flip a near-tie the distance explains), the
    rebuilds by cause equal the faults, each rebuild's allocated bytes
    come back to the old arena's (REBUILD_BYTES; the int8 run's first
    rebuild with the C9 bait planted before it), in the supervised
    run's trace every successful dispatch launches the pool's paged
    kernel once a layer (and each capture's warm-up pass), and the
    modeled KV bytes of ``health()`` equal the tally of the kernel's own
    inputs (``kernel_kv_tally``) and the traces' admissions. Then a
    ``decode_retry`` run rides out a transient fault with no rebuild,
    its streams equal to the unperturbed run's, a zero budget fails every waiter
    with the original error and writes a flight record, and tokens/s
    with the registry's handles against the same engine with them made
    no-ops (events and traces off), in turns after a warming run
    (registry, bare, bare, registry, registry, bare)."""
    import shutil
    import tempfile
    from deeplearning4j_tpu_torch.monitoring import events, flightrecorder
    from deeplearning4j_tpu_torch.monitoring.metrics import MetricsRegistry
    from deeplearning4j_tpu_torch.resilience import chaos
    from deeplearning4j_tpu_torch.resilience.retry import (
        RestartBudget, RetryPolicy)
    from deeplearning4j_tpu_torch.serving import EngineSupervisor
    _, net = served_net(device)
    requests = serve_requests(np.random.default_rng(1))
    rec = {"card": smi, "faults": {"decode": list(SURVIVE_FAULTS),
                                   "seize": SURVIVE_SEIZE,
                                   "seat": SURVIVE_SEAT},
           "gap_limit": SURVIVE_GAP}
    plain_outs = {}
    for kv in ("bf16", "int8"):
        key = "paged_attention_quant" if kv == "int8" else "paged_attention"
        eng = survive_engine(net, device, kv)
        plain_draws, draws = {}, {}
        # untraced: the serve phases' traced runs count this path's
        # launches; the supervised run below is traced
        r0, c0 = eng.replay_calls, eng.graph_captures
        hs, run = drive(eng, requests, draws=plain_draws)
        run.update(replays=eng.replay_calls - r0,
                   captures=eng.graph_captures - c0)
        plain = plain_outs[kv] = [h.result(timeout=0) for h in hs]
        r = {"unperturbed": run}
        del eng
        torch.cuda.empty_cache()
        chain = ChaosChain(*[chaos.FaultBurstInjector(n=i, k=1, window=1)
                             for i in SURVIVE_FAULTS])
        reg = MetricsRegistry()
        eng = survive_engine(net, device, kv, registry=reg,
                             supervisor=EngineSupervisor(
                                 budget=RestartBudget(8, 600.0)),
                             decode_chaos=chain,
                             seat_chaos=chaos.RaiseOnBatch(None,
                                                           n=SURVIVE_SEAT))
        seize = chaos.PageExhaustionInjector(eng.page_pool, n=SURVIVE_SEIZE)
        chain.parts.insert(0, seize)
        rebuilds, model = [], {"dispatch_bytes": 0}
        timed_rebuilds(eng, rebuilds, bait=kv == "int8")
        pool = pool_bytes(eng)
        bytes0 = eng.health()["kv_traffic"]["bytes_moved_total"]
        undo = kernel_kv_tally(eng, model)
        try:
            (hs, run), c = counted(eng, lambda: drive(eng, requests,
                                                      draws=draws))
        finally:
            undo()
        run.update(captures=c["captures"], graph_launches=c["graph_launches"],
                   trace_read_s=c["trace_read_s"],
                   opening_spins_recorded=c["opening_spins_recorded"])
        counts = c["launches"]
        outs = [h.result(timeout=0) for h in hs]
        h = eng.health()
        snap = reg.snapshot_compact()
        by_cause = {c: snap.get(f"dl4jtpu_serving_engine_rebuilds_total"
                                f"{{cause={c},model={eng.label}}}")
                    for c in ("decode_fault", "admission_fault")}
        moved = h["kv_traffic"]["bytes_moved_total"] - bytes0
        want_moved = model["dispatch_bytes"] + kv_admission_bytes(hs, kv)
        div, neighbour, bad = explain_flips(plain_draws, draws, plain, outs,
                                            requests)
        # (bf16 only: a one-shot forward reads no int8 pool)
        oneshot, planted = context_readings(
            net, plain, requests, plain_draws) if kv == "bf16" \
            else (None, None)
        r["perturbed"] = rp = {
            **run, "launches": counts[key], "all_launches": counts,
            "rebuilds": rebuilds, "rebuilds_by_cause": by_cause,
            "seizure_fired": seize.faults_fired,
            "supervisor": h["supervisor"], "pool_bytes": pool,
            "kv_bytes_moved": moved, "kv_bytes_model": want_moved,
            "decode_path": h["kv_traffic"]["decode_path"],
            "equal": outs == plain, "divergence": div,
            "logp_max": max(f.get("logp", 0.0) for f in div),
            "logp_limit": SURVIVE_LOGP, "neighbour_logp_min": neighbour,
            "oneshot_logp_max": oneshot, "dropped_first_logp_min": planted}
        log(f"serve_survive {kv}:", json.dumps(
            {k: v for k, v in rp.items() if k not in ("divergence",
                                                       "all_launches")}
            | {"diverged": [f for f in div if f["first"] is not None],
               "unperturbed": r["unperturbed"], "card": smi}))
        failures = []
        if bad:
            failures.append(f"streams left the unperturbed run's "
                            f"unexplained: {bad}")
        if by_cause != {"decode_fault": len(SURVIVE_FAULTS),
                        "admission_fault": 1} or \
                h["supervisor"]["escalations"] or not eng.is_healthy():
            failures.append(f"rebuilds {by_cause}, {h['supervisor']}")
        if seize.faults_fired != 1:
            failures.append("the seizure did not fire")
        if len(rebuilds) != len(SURVIVE_FAULTS) + 1 or any(
                rebuild_kept(b) > REBUILD_BYTES or b["graphs_after"]
                for b in rebuilds):
            failures.append(f"a rebuild kept the old arena: {rebuilds}")
        # one capture a rebuild (each rebuild's next dispatch), none else
        if rp["captures"] != len(rebuilds):
            failures.append(f"{rp['captures']} captures for "
                            f"{len(rebuilds)} rebuilds")
        if moved != want_moved or rp["decode_path"] != "direct-cuda":
            failures.append(f"kv bytes {moved} != the model's {want_moved}")
        # the supervised run's trace: each replay's layers, and each
        # capture's warm-up pass (a faulted dispatch replays nothing)
        u = r["unperturbed"]
        if u["dispatches"] == 0 or u["replays"] != u["dispatches"] or \
                u["captures"]:
            failures.append(f"unperturbed: {u}")
        if rp["dispatches"] == 0 or not trace_holds(
                {key: rp["launches"], "graphs": rp["graph_launches"]},
                {key: LAYERS * (rp["dispatches"] + rp["captures"]),
                 "graphs": rp["dispatches"]}):
            failures.append(f"perturbed: {rp['launches']} {key} launches "
                            f"and {rp['graph_launches']} graph launches in "
                            f"the trace for {rp['dispatches']} dispatches "
                            f"and {rp['captures']} captures")
        if failures:
            raise AssertionError(f"serve_survive {kv}: {failures}")
        rec[kv] = r
        del eng
        torch.cuda.empty_cache()
    # decode_retry: the transient fault retried inside the dispatch
    sup = EngineSupervisor()
    inj = chaos.FaultBurstInjector(n=SURVIVE_RETRY, k=1)
    eng = survive_engine(net, device, "bf16", supervisor=sup,
                         decode_retry=RetryPolicy(
                             max_attempts=3, base_delay=0.0,
                             retry_on=(chaos.InjectedFault,)),
                         decode_chaos=inj)
    hs, run = drive(eng, requests)
    outs = [h.result(timeout=0) for h in hs]
    rec["retry"] = {**run, "rebuilds": sup.rebuilds,
                    "equal": outs == plain_outs["bf16"],
                    "faults_fired": inj.faults_fired}
    log("serve_survive retry:", json.dumps(rec["retry"] | {"card": smi}))
    if sup.rebuilds or not rec["retry"]["equal"] or inj.faults_fired != 1:
        raise AssertionError(f"serve_survive retry: {rec['retry']}")
    del eng
    # a zero budget: the first fault escalates to the fail-all
    tmp = tempfile.mkdtemp(prefix="dl4j_flight_")
    flightrecorder.set_flight_dir(tmp)
    flightrecorder.reset_for_tests()
    try:
        sup = EngineSupervisor(budget=RestartBudget(0, 60.0))
        eng = survive_engine(net, device, "bf16", supervisor=sup,
                             decode_chaos=chaos.FaultBurstInjector(n=10, k=1))
        hs = [eng.submit(p, steps=NEW_TOKENS, rng=np.random.default_rng(i),
                         **kw) for i, (p, kw) in enumerate(requests)]
        eng.run_until_idle()
        errors = {type(h.error).__name__ for h in hs}
        path = flightrecorder.last_record_path()
        header = flightrecorder.read_record(path)["header"] if path else {}
    finally:
        flightrecorder.set_flight_dir(None)
        flightrecorder.reset_for_tests()
        shutil.rmtree(tmp, ignore_errors=True)
    rec["escalation"] = {"errors": sorted(errors),
                         "escalations": sup.escalations,
                         "healthy": eng.is_healthy(),
                         "flight_trigger": header.get("trigger")}
    log("serve_survive escalation:", json.dumps(rec["escalation"]))
    if errors != {"InjectedFault"} or sup.escalations != 1 or \
            eng.is_healthy() or not header:
        raise AssertionError(f"serve_survive escalation: {rec['escalation']}")
    del eng
    torch.cuda.empty_cache()
    # the registry's cost, on one engine, in turns: the handles as
    # shipped, the handles made no-ops (events and traces on), and
    # everything off (no-op handles, events and traces off); then the
    # seconds a dispatch spends inside the shipped handles, each call
    # timed
    eng = survive_engine(net, device, "bf16")
    shipped = {k: getattr(eng, k) for k in HANDLE_ATTRS + ("_handles",)}
    turns = {"registry": [], "handles_off": [], "bare": []}
    null = _NullHandle()
    drive(eng, requests)          # warm the prefix cache for every turn
    for mode in ("registry", "handles_off", "bare", "bare", "handles_off",
                 "registry"):
        for k, v in shipped.items():
            setattr(eng, k, v)
        if mode != "registry":
            swap_handles(eng, lambda h: null)
        prev = events.set_events_enabled(mode != "bare")
        try:
            hs, run = drive(eng, requests)
        finally:
            events.set_events_enabled(prev)
        run["equal"] = [h.result(timeout=0) for h in hs] == \
            plain_outs["bf16"]
        turns[mode].append(run)
    for k, v in shipped.items():
        setattr(eng, k, v)
    acc = [0.0, 0]
    swap_handles(eng, lambda h: _TimedHandle(h, acc))
    _, run = drive(eng, requests)
    rec["registry_cost"] = {
        "turns": turns,
        "tokens_per_s": {m: [t["tokens_per_s"] for t in ts]
                         for m, ts in turns.items()},
        "inside_handles": {"s_per_dispatch": acc[0] / run["dispatches"],
                           "calls_per_dispatch": acc[1] / run["dispatches"],
                           "wall_s_per_dispatch":
                               run["wall_s"] / run["dispatches"]}}
    log("serve_survive registry cost:", json.dumps(
        rec["registry_cost"]["tokens_per_s"]
        | rec["registry_cost"]["inside_handles"] | {"card": smi}))
    del eng, net
    torch.cuda.empty_cache()
    return rec


def rung_moves(events_):
    """Each brownout rung entered and left, from the engine's brownout
    events (level, prev)."""
    entered, left = set(), set()
    for e in events_:
        a = e.attrs
        lo, hi = sorted((a["prev"], a["level"]))
        for r in range(lo + 1, hi + 1):
            (entered if a["level"] > a["prev"] else left).add(r)
    return sorted(entered), sorted(left)


def serve_overload(device, smi):
    """Phase 4's net behind ``OverloadConfig`` (TTFT objective
    OVERLOAD_TTFT_SLO, the brownout ladder at OVERLOAD_FRACS) over a
    pool of OVERLOAD_TOKENS tokens (no prefix cache: its pages would
    hold the pool full; prompts of 290-300 tokens), with speculation (``prompt_lookup_proposer(3)``,
    gamma 4) so the ladder's rungs have work to shed, 8 slots, and 48
    requests of OVERLOAD_NEW new tokens, each with a deadline and a
    priority of 0-2, in two waves (the second once the admission rate
    has calibrated, some with deadlines it cannot meet). Shedding takes
    the lowest priority queued at the time first; every early rejection
    comes after min_samples admissions; every rung is entered and left;
    each greedy request that finished streams as the same request
    through the speculative engine without overload control (under
    SURVIVE_GAP); ``drain()`` in mid-run finishes every active request
    and fails every queued one with ``EngineShutdown``."""
    from deeplearning4j_tpu_torch.monitoring.events import global_event_log
    from deeplearning4j_tpu_torch.serving import (
        EngineShutdown, GenerationEngine, OverloadConfig, PagedKVConfig,
        ServingOverloaded, SpeculationConfig)
    from deeplearning4j_tpu_torch.serving.errors import InferenceTimeout
    from deeplearning4j_tpu_torch.util.decoding import (
        prompt_lookup_proposer)
    _, net = served_net(device)
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(sum(OVERLOAD_WAVES)):
        # repeating motifs (the prompt-lookup draft finds its n-grams),
        # 290-300 tokens: 23 pages a request with its new tokens and the
        # verify's gamma, so 4 fill the pool to its last page (rung 3)
        # and one retirement frees a quarter of it (rung 0)
        motif = [int(t) for t in rng.integers(1, VOCAB, 12)]
        prompt = (motif * 25)[:int(rng.integers(290, 301))]
        reqs.append((prompt, dict(top_k=1), int(i % 3)))
    cfg = OverloadConfig(ttft_slo_s=OVERLOAD_TTFT_SLO, min_samples=4,
                         breach_window=16, brownout_enter_fracs=OVERLOAD_FRACS)
    spec = SpeculationConfig(prompt_lookup_proposer(SPEC_NGRAM),
                             gamma=SPEC_GAMMA)
    eng = GenerationEngine(
        net, VOCAB, slots=SLOTS, device=device, name="engine:overload",
        paging=PagedKVConfig(page_size=PAGE, prefix_cache=False,
                             total_tokens=OVERLOAD_TOKENS),
        speculation=spec, overload=cfg, queue_limit=64)
    eng.warmup(max_prompt_len=300)
    n0 = global_event_log().total_emitted
    handles, rejected = {}, []
    t0 = time.perf_counter()
    first = OVERLOAD_WAVES[0]
    # the first wave before any admission: no rate yet, so even the
    # deadlines no queue could meet (every eighth) are not refused
    for i, (p, kw, prio) in enumerate(reqs[:first]):
        try:
            handles[i] = eng.submit(p, steps=OVERLOAD_NEW, priority=prio,
                                    rng=np.random.default_rng(i),
                                    timeout=0.05 if i % 8 == 7 else 120.0,
                                    **kw)
        except ServingOverloaded:
            rejected.append({"request": i, "admissions": eng.admissions})
    steps = 0
    while eng.admissions < 2 * cfg.min_samples and steps < 20000 and (
            eng.active_slots() or eng.queue_depth()):
        eng.step()
        steps += 1
    for i, (p, kw, prio) in enumerate(reqs[first:], start=first):
        # every other one with a deadline the queue cannot meet
        timeout = 0.05 if i % 2 else 120.0
        try:
            handles[i] = eng.submit(p, steps=OVERLOAD_NEW, priority=prio,
                                    rng=np.random.default_rng(i),
                                    timeout=timeout, **kw)
        except ServingOverloaded:
            rejected.append({"request": i, "admissions": eng.admissions})
    while eng.queue_depth() > 4 and steps < 40000:
        eng.step()
        steps += 1
    ledger = eng.export_ledger(include_queued=True)
    active = [e.request.handle for e in ledger if e.phase == "active"]
    queued = [e.request.handle for e in ledger if e.phase == "queued"]
    drained = eng.drain(timeout=300.0)
    wall = time.perf_counter() - t0
    evs = [e for e in global_event_log().tail()
           if e.seq > n0 and e.attrs.get("engine") == "engine:overload"]
    entered, left = rung_moves([e for e in evs if e.name == "brownout"])
    # shedding: each victim's priority <= that of every request still
    # queued when it was shed
    shed_at = {i: next(r["t"] for r in h.trace().events()
                       if r["event"] == "shed")
               for i, h in handles.items()
               if isinstance(h.error, ServingOverloaded)}
    order_bad = []
    for v, ts in shed_at.items():
        for i, h in handles.items():
            ev = {r["event"]: r["t"] for r in h.trace().events()}
            waiting = ev["submit"] < ts and ev.get(
                "queue_pop", float("inf")) > ts and \
                shed_at.get(i, float("inf")) > ts and i != v and \
                ev.get("retire", float("inf")) > ts
            if waiting and reqs[v][2] > reqs[i][2]:
                order_bad.append((v, i))
    outcomes = {}
    for i, h in handles.items():
        k = ("length" if h.error is None else type(h.error).__name__)
        outcomes[k] = outcomes.get(k, 0) + 1
    rec = {"card": smi, "requests": len(reqs), "wall_s": wall,
           "outcomes": outcomes, "early_rejected": rejected,
           "shed": len(shed_at), "rungs_entered": entered,
           "rungs_left": left, "drained": drained,
           "active_at_drain": len(active), "queued_at_drain": len(queued),
           "health": {k: eng.health().get(k) for k in ("overload",
                                                       "draining")}}
    failures = []
    if not shed_at or order_bad:
        failures.append(f"shedding: {len(shed_at)} shed, out of order "
                        f"{order_bad}")
    if not rejected or any(r["admissions"] < cfg.min_samples
                           for r in rejected):
        failures.append(f"early rejections {rejected}")
    if entered != [1, 2, 3] or left != [1, 2, 3]:
        failures.append(f"rungs entered {entered}, left {left}")
    if not drained or not active or not queued or any(
            h.error is not None for h in active) or any(
            not isinstance(h.error, EngineShutdown) for h in queued):
        failures.append("drain: an active failed or a queued one ran")
    unexpected = {k for k in outcomes if k not in (
        "length", "ServingOverloaded", "EngineShutdown",
        InferenceTimeout.__name__)}
    if unexpected:
        failures.append(f"outcomes {outcomes}")
    del eng
    torch.cuda.empty_cache()
    # the same requests, each alone in spirit: the speculative engine
    # without overload control, ample pages
    done = [i for i, h in handles.items() if h.error is None]
    ref = GenerationEngine(net, VOCAB, slots=SLOTS, device=device,
                           paging=PagedKVConfig(page_size=PAGE),
                           speculation=spec)
    ref.warmup(max_prompt_len=300)
    rh = {i: ref.submit(reqs[i][0], steps=OVERLOAD_NEW,
                        rng=np.random.default_rng(i), **reqs[i][1])
          for i in done}
    ref.run_until_idle()
    div, bad = flips(net, [rh[i].result(timeout=0) for i in done],
                     [handles[i].result(timeout=0) for i in done],
                     [(reqs[i][0], reqs[i][1]) for i in done])
    rec["compared"] = len(done)
    rec["divergence"] = [f for f in div if f["first"] is not None]
    if bad:
        failures.append(f"greedy streams under brownout left the "
                        f"unbrowned run's at wide gaps: {bad}")
    log("serve_overload:", json.dumps(rec))
    if failures:
        raise AssertionError(f"serve_overload: {failures}")
    del ref, net
    torch.cuda.empty_cache()
    return rec


def lstm_engine(net, device, slots=SLOTS):
    from deeplearning4j_tpu_torch.serving import GenerationEngine
    return replay_calls(GenerationEngine(net, LSTM_VOCAB, slots=slots,
                                       device=device, name="engine:lstm"))


def profile_steps(step, steps, wall_unit):
    """``torch.profiler`` over ``steps`` calls of ``step``: ms a call,
    the device's busy share, CUDA kernel launches a call."""
    with traced(cpu=True) as t:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in t.prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and "spin_kernel" not in e.key]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in kernels)
    return {wall_unit: 1e3 * wall / steps,
            "device_busy_share": busy / (wall * 1e6),
            "kernel_launches_per_call": t.kernels / steps,
            "row_launches": t.rows, "opening_spins_recorded": t.warm,
            "row_launches_per_step": {r: n / steps
                                      for r, n in t.rows.items()}}


def serve_lstm(device, smi):
    """The text LSTM (phase 24's net: vocab 128, two GravesLSTM layers of
    256, bf16) behind the engine: 8 slots, 16 greedy requests of 256 new
    tokens after 32-token prompts. Each decode step launches row 17's
    kernel once a layer at batch 8 (and each prime once a layer at batch
    1); each stream equals one-shot ``sample_stream``'s with the same rng
    under SURVIVE_GAP; tokens/s; a profile of 20 engine steps with every
    slot busy against 20 tokens of ``sample_stream`` at batch 1. Then in
    f32 the engine's streams equal ``sample_stream``'s exactly."""
    from deeplearning4j_tpu_torch.util.decoding import sample_stream
    net = text_lstm_net(device, torch.bfloat16)
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, LSTM_VOCAB, LSTM_PROMPT)]
               for _ in range(SERVE_LSTM_N)]
    requests = [(p, dict(top_k=1)) for p in prompts]
    eng = lstm_engine(net, device).warmup(max_prompt_len=LSTM_PROMPT)
    d0, a0, c0 = eng.dispatches, eng.admissions, eng.graph_captures
    (hs, run), c = counted(eng, lambda: drive(eng, requests,
                                              SERVE_LSTM_NEW))
    # the decode steps' replays and the eager primes
    wrapper = {k: c["wrapper"][k] for k in ("lstm_fwd", "lstm_bwd")}
    counts = {k: c["launches"][k] for k in ("lstm_fwd", "lstm_bwd")}
    dispatches, admissions = eng.dispatches - d0, eng.admissions - a0
    captures = eng.graph_captures - c0
    n = sum(len(h.generated) for h in hs)
    outs = [h.result(timeout=0) for h in hs]
    # batch 8 a decode step: the engine's rows; batch 1 a prime
    want_launches = LSTM_LAYERS * (dispatches + admissions)
    t0 = time.perf_counter()
    ref = [sample_stream(net, p, SERVE_LSTM_NEW, LSTM_VOCAB, top_k=1,
                         rng=np.random.default_rng(i), max_length=None)
           for i, p in enumerate(prompts)]
    ref_s = time.perf_counter() - t0
    div, bad = flips(net, ref, outs, requests)
    rec = {"card": smi, "requests": SERVE_LSTM_N,
           "new_tokens": SERVE_LSTM_NEW, "tokens": n, **run,
           "admissions": admissions, "launches": counts,
           "launches_from": "the run's trace: the replays and the eager "
                            "primes",
           "wrapper_launches": wrapper, "captures": captures,
           "graph_launches": c["graph_launches"],
           "trace_read_s": c["trace_read_s"],
           "opening_spins_recorded": c["opening_spins_recorded"],
           "launches_per_decode_step": (counts["lstm_fwd"] - LSTM_LAYERS
                                        * admissions) / dispatches,
           "sample_stream_tokens_per_s": n / ref_s,
           "equal_sample_stream": outs == ref,
           "divergence": [f for f in div if f["first"] is not None]}
    failures = []
    if not trace_holds({**counts, "graphs": c["graph_launches"]},
                       {"lstm_fwd": want_launches, "graphs": dispatches}) or \
            counts["lstm_bwd"] or captures or \
            wrapper["lstm_fwd"] != LSTM_LAYERS * admissions:
        failures.append(f"launched {counts} in the trace (wrapper "
                        f"{wrapper}, {captures} captures, "
                        f"{c['graph_launches']} graph launches for "
                        f"{dispatches} dispatches), want {want_launches} "
                        f"forward")
    if bad:
        failures.append(f"streams left sample_stream's at wide gaps: {bad}")
    # profiles: every slot busy against sample_stream at batch 1 (a new
    # engine: the references above streamed the net)
    eng = lstm_engine(net, device)
    for i in range(SLOTS):
        eng.submit(prompts[i], steps=400, top_k=1)
    for _ in range(3):
        eng.step()
    rec["profile_engine"] = profile_steps(eng.step, 20, "step_ms")
    rec["profile_engine"]["tokens_per_step"] = SLOTS
    if not trace_holds(rec["profile_engine"]["row_launches"],
                       {"lstm_fwd": LSTM_LAYERS * 20}):
        failures.append(f"the replays' window: {rec['profile_engine']}")
    eng.shutdown()
    x1 = np.zeros((1, LSTM_VOCAB, 1), np.float32)
    x1[0, 1, 0] = 1.0
    net.rnn_clear_previous_state()
    net.rnn_time_step(x1)
    rec["profile_sample_stream"] = profile_steps(
        lambda: net.rnn_time_step(x1).float().cpu(), 20, "token_ms")
    net.rnn_clear_previous_state()
    log("serve_lstm:", json.dumps(rec))
    del eng, net
    torch.cuda.empty_cache()
    # f32: exactly sample_stream's
    net = text_lstm_net(device, torch.float32)
    eng = lstm_engine(net, device)
    hs = [eng.submit(p, steps=SERVE_LSTM_REF_NEW, top_k=1,
                     rng=np.random.default_rng(i))
          for i, p in enumerate(prompts[:SERVE_LSTM_REF_N])]
    eng.run_until_idle()
    got = [h.result(timeout=0) for h in hs]
    want = [sample_stream(net, p, SERVE_LSTM_REF_NEW, LSTM_VOCAB, top_k=1,
                          rng=np.random.default_rng(i), max_length=None)
            for i, p in enumerate(prompts[:SERVE_LSTM_REF_N])]
    rec["reference_f32_equal"] = got == want
    if not rec["reference_f32_equal"]:
        failures.append("f32: the engine's streams are not sample_stream's")
    del eng, net
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"serve_lstm: {failures}: {rec}")
    return rec


# ---------------------------------------------------------------------
# phases 41-42: the engine's decode step as one CUDA graph, beam search
# ---------------------------------------------------------------------
#: serve_graph: the supervised run's decode faults (dispatch indices),
#: the profiled window (engine steps with every slot busy), the largest
#: host launch calls a graph step may make
GRAPH_FAULTS = (30, 90)
GRAPH_PROFILE_STEPS = 20
GRAPH_HOST_LAUNCHES = 10
#: beam: the text LSTM's beams, steps, the output layer's weight scale
#: (peaked distributions: no near ties between the kernel's and the
#: plain version's f32 sums), the f32 score's limit against the plain
#: route (a sum of up to BEAM_STEPS log-probabilities)
BEAM_W, BEAM_STEPS, BEAM_PEAK, BEAM_SCORE_ATOL = 4, 64, 4.0, 1e-3


def dispatch_digests(eng, out):
    """Keep a digest of each dispatch's distributions at its active rows
    (a free row reads the null page, whose colliding appends land in no
    defined order)."""
    import hashlib
    real = eng._dispatch

    def kept(chunk):
        active = [s for s, r in enumerate(eng._slots) if r is not None]
        p = real(chunk)
        out.append(hashlib.sha1(np.ascontiguousarray(
            p[active]).tobytes()).hexdigest())
        return p
    eng._dispatch = kept


def stale_table(eng, held):
    """Plant a stale page table in the decode graph: the capture reads a
    copy of the table made at capture time (kept alive in ``held``),
    while the graph's record of what it read names the live one, so no
    recapture hides the fault."""
    real = eng._capture

    def capture(width):
        held.append(eng._tables().clone())
        eng._tables = lambda: held[-1]
        try:
            return real(width)
        finally:
            del eng._tables
    eng._capture = capture


def engine_trace(eng, steps):
    """``steps`` engine steps under ``torch.profiler``, read from its
    Chrome trace: ms a step, the device's busy share (the union of its
    kernel, copy and fill intervals over the wall time), host launch
    calls a step, device kernels a step, graph launches a step, the
    serving rows' kernels a step and the tokens a step commits."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    t0 = eng.tokens_generated
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_session()
        w0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = without_spins([e for e in json.load(f)["traceEvents"]
                                    if e.get("ph") == "X"])
    finally:
        os.remove(path)
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e.get("cat") == "kernel"]
    host = {}
    for e in events:
        if e.get("name") in HOST_LAUNCHES:
            host[e["name"]] = host.get(e["name"], 0) + 1
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in device]
    rows = {row: sum(name in e["name"] and "lstm_bwd" not in e["name"]
                     for e in kernels) for row, name in SERVE_ROWS.items()}
    graphs = host.get("cudaGraphLaunch", 0)
    return {"step_ms": 1e3 * wall / steps,
            "device_busy_share": union_us(spans) / (wall * 1e6),
            "device_busy_ms_per_step": union_us(spans) / 1e3 / steps,
            "host_launches_per_step": sum(host.values()) / steps,
            "host_calls": host,
            "kernel_launches_per_step": len(kernels) / steps,
            "graph_launches_per_step": graphs / steps,
            "row_launches": rows,
            "row_launches_per_step": {r: n / steps for r, n in rows.items()},
            # every replay of a graph runs the kernels it captured
            "row_launches_per_graph_launch": {
                r: n / graphs for r, n in rows.items()} if graphs else None,
            "tokens_per_step": (eng.tokens_generated - t0) / steps}


def graph_configs(device):
    """serve_graph's four engines: phase 4's served net behind a bf16
    pool, an int8 pool and the speculative engine (gamma 4), and the
    text LSTM (phase 24's net, bf16) in the slot arena; each with its
    traffic, warm-up prompt length, paged row and layers."""
    from deeplearning4j_tpu_torch.serving import (
        GenerationEngine, PagedKVConfig)
    _, net = served_net(device)
    lnet = text_lstm_net(device, torch.bfloat16)
    rng = np.random.default_rng(3)
    lreq = [([int(t) for t in rng.integers(0, LSTM_VOCAB, LSTM_PROMPT)],
             dict(top_k=1) if i % 2 == 0 else dict(top_k=40, temperature=0.9))
            for i in range(SERVE_LSTM_N)]
    treq = serve_requests(np.random.default_rng(1))

    def paged(kv):
        return lambda **kw: replay_calls(GenerationEngine(
            net, VOCAB, slots=SLOTS, device=device,
            paging=PagedKVConfig(page_size=PAGE, kv_dtype=kv), **kw))
    return {"bf16": (paged("bf16"), treq, 300, "paged_attention", LAYERS),
            "int8": (paged("int8"), treq, 300, "paged_attention_quant",
                     LAYERS),
            "spec": (lambda: spec_engine(net, device, "bf16", True), treq,
                     300, "paged_attention", LAYERS),
            "lstm": (lambda: lstm_engine(lnet, device), lreq, LSTM_PROMPT,
                     "lstm_fwd", LSTM_LAYERS)}


def graph_turn(make, requests, warm, eager, plant=None):
    """One turn of serve_graph: a fresh engine (the prefix cache empty, as
    in every turn), warmed up, then the traffic driven by hand; graph or
    eager (the engine's measuring seam). Returns the streams, each
    dispatch's digest and the turn's numbers."""
    eng = make()
    if eager:
        eng._measure_eager = True
    held = []
    if plant:
        stale_table(eng, held)
    eng.warmup(max_prompt_len=warm)
    digests = []
    dispatch_digests(eng, digests)
    eng.tpot_s.clear()
    c0 = eng.graph_captures
    hs, run = drive(eng, requests)
    run.update(tpot_p50_ms=1e3 * float(np.median(eng.tpot_s)),
               captures_in_turn=eng.graph_captures - c0,
               captures=eng.graph_captures, widths=sorted(eng._graphs))
    outs = [h.result(timeout=0) for h in hs]
    eng.shutdown()
    return outs, digests, run


def graph_profile(make, requests, warm, eager):
    """``engine_trace`` of GRAPH_PROFILE_STEPS steps with every slot
    busy (long requests from the traffic's prompts), graph or eager."""
    eng = make()
    if eager:
        eng._measure_eager = True
    eng.warmup(max_prompt_len=warm)
    for p, kw in requests[:SLOTS]:
        eng.submit(p[:warm], steps=GRAPH_PROFILE_STEPS * 10, **kw)
    for _ in range(3):
        eng.step()
    rec = engine_trace(eng, GRAPH_PROFILE_STEPS)
    if eng.active_slots() != SLOTS:
        raise AssertionError("serve_graph: the profiled engine stopped "
                             "decoding")
    eng.shutdown()
    return rec


def graph_rebuilds(device, make, requests, warm, failures):
    """A supervised bf16 run with decode faults at GRAPH_FAULTS: one
    capture before them and exactly one more after each rebuild, the
    capture counter (``dl4jtpu_jit_compiles_total``) moved by as many,
    each rebuild's allocated bytes outside the graph pools back to the
    old arena's (at most REBUILD_BYTES over), the graph pools' bytes
    apart."""
    from deeplearning4j_tpu_torch.resilience import chaos
    from deeplearning4j_tpu_torch.resilience.retry import RestartBudget
    from deeplearning4j_tpu_torch.serving import EngineSupervisor
    eng = make(supervisor=EngineSupervisor(budget=RestartBudget(8, 600.0)),
               decode_chaos=ChaosChain(*[chaos.FaultBurstInjector(
                   n=i, k=1, window=1) for i in GRAPH_FAULTS]))
    eng.warmup(max_prompt_len=warm)
    c0, n0 = eng.graph_captures, registry_count("dl4jtpu_jit_compiles_total")
    rebuilds = []
    timed_rebuilds(eng, rebuilds)
    hs, run = drive(eng, requests)
    ok = all(h.done and h.error is None for h in hs)
    rec = {**run, "rebuilds": rebuilds, "finished": ok,
           "captures_before": c0,
           "captures_after_rebuilds": eng.graph_captures - c0,
           "capture_counter_moved": registry_count(
               "dl4jtpu_jit_compiles_total") - n0,
           "kept_bytes": [rebuild_kept(b) for b in rebuilds],
           "graph_pool_bytes": [(b["graph_pool_before"],
                                 b["graph_pool_after"]) for b in rebuilds]}
    eng.shutdown()
    if not ok or len(rebuilds) != len(GRAPH_FAULTS) or c0 != 1 or \
            rec["captures_after_rebuilds"] != len(rebuilds) or \
            rec["capture_counter_moved"] != len(rebuilds) or any(
                k > REBUILD_BYTES for k in rec["kept_bytes"]) or any(
                b["graphs_after"] for b in rebuilds):
        failures.append(f"rebuilds: {rec}")
    return rec


def serve_graph(device, smi):
    """The decode step as one CUDA graph, against the same engine's
    device part run eagerly (its measuring seam), in turns (graph,
    eager, eager, graph), each turn a fresh engine driving the serving
    cell's traffic by hand: bf16 and int8 pools and speculation at gamma
    4 (16 requests of 128 new tokens, greedy and sampled) and the LSTM
    arena (16 of 256, greedy and sampled). Every turn's streams and
    every dispatch's distributions at its active rows are bitwise equal;
    a graph turn captures once (its one width, in the warm-up) and
    replays every dispatch; the eager turns capture nothing. A profile
    of GRAPH_PROFILE_STEPS steps a mode (host launch calls, device
    kernels and the serving row's kernels a step from the trace, busy
    share); the rows launch in the replays as often a step as eagerly
    (6, 6, 6 and 2), the graph's host launch calls at most
    GRAPH_HOST_LAUNCHES a step. A stale table captured (planted) fails
    the equality check. A supervised run's rebuilds (``graph_
    rebuilds``)."""
    configs = graph_configs(device)
    rec = {"card": smi, "faults": list(GRAPH_FAULTS)}
    failures = []
    launches = {}
    for name, (make, requests, warm, row, layers) in configs.items():
        t0 = time.perf_counter()
        turns = {"graph": [], "eager": []}
        outs, digests = {}, {}
        for mode in ("graph", "eager", "eager", "graph"):
            o, d, run = graph_turn(make, requests, warm, mode == "eager")
            turns[mode].append(run)
            if mode in outs and (o != outs[mode] or d != digests[mode]):
                failures.append(f"{name}: two {mode} turns differ")
            outs[mode], digests[mode] = o, d
        equal = outs["graph"] == outs["eager"]
        same = digests["graph"] == digests["eager"]
        first = next((i for i, (a, b) in enumerate(zip(
            digests["graph"], digests["eager"])) if a != b), None)
        prof = {mode: graph_profile(make, requests, warm, mode == "eager")
                for mode in ("graph", "eager")}
        med = {mode: {k: float(np.median([t[k] for t in ts]))
                      for k in ("tokens_per_s", "tpot_p50_ms")}
               for mode, ts in turns.items()}
        r = rec[name] = {
            "streams_equal": equal, "distributions_bitwise": same,
            "dispatches": len(digests["graph"]),
            "first_differing_dispatch": first, "median": med,
            "turns": turns, "profile": prof,
            "host_launches_per_step": {
                m: prof[m]["host_launches_per_step"] for m in prof},
            "kernels_per_step": {m: prof[m]["kernel_launches_per_step"]
                                 for m in prof},
            "busy_share": {m: prof[m]["device_busy_share"] for m in prof},
            "row": row, "row_launches_per_step": {
                m: prof[m]["row_launches_per_step"][row] for m in prof}}
        launches[row] = launches.get(row, 0) + \
            prof["graph"]["row_launches"][row]
        r["wall_s"] = time.perf_counter() - t0
        log(f"serve_graph {name}:", json.dumps(
            {k: v for k, v in r.items() if k not in ("turns", "profile")}
            | {"card": smi}))
        if not (equal and same and len(digests["graph"]) > 0):
            failures.append(f"{name}: graph and eager differ (streams "
                            f"equal {equal}, first differing dispatch "
                            f"{first})")
        if any(t["captures"] != 1 or t["captures_in_turn"]
               for t in turns["graph"]) or any(
                t["captures"] for t in turns["eager"]):
            failures.append(f"{name}: captures {turns}")
        # the trace: the row once a layer a step in both modes (in the
        # graph's, inside its one graph launch a step)
        rows = r["row_launches_per_step"]
        if any(not trace_holds({row: prof[m]["row_launches"][row]},
                               {row: layers * GRAPH_PROFILE_STEPS})
               for m in prof):
            failures.append(f"{name}: {row} a step {rows} in the traces, "
                            f"want {layers}")
        if prof["graph"]["graph_launches_per_step"] != 1 or \
                prof["graph"]["host_launches_per_step"] > \
                GRAPH_HOST_LAUNCHES:
            failures.append(f"{name}: the graph step's host calls "
                            f"{prof['graph']['host_calls']}")
    # the planted fault: a stale table captured (bf16)
    make, requests, warm, _, _ = configs["bf16"]
    eager_o, eager_d, _ = graph_turn(make, requests[:4], warm, True)
    planted_o, planted_d, _ = graph_turn(make, requests[:4], warm, False,
                                         plant=True)
    caught = planted_o != eager_o or planted_d != eager_d
    rec["planted_stale_table"] = {"caught": caught,
                                  "streams_equal": planted_o == eager_o}
    if not caught:
        failures.append("the stale table planted in the graph passed the "
                        "equality check")
    rec["rebuilds"] = graph_rebuilds(device, make, requests, warm, failures)
    rec["launches"] = launches
    log("serve_graph:", json.dumps({k: rec[k] for k in (
        "planted_stale_table", "rebuilds", "launches")} | {"card": smi}))
    del configs
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"serve_graph: {failures}")
    return rec


def beam_phase(device, smi):
    """Beam search on the text LSTM (phase 24's net; the output layer's
    weights scaled by BEAM_PEAK) at W = BEAM_W beams, BEAM_STEPS steps
    from a 32-token prompt: each step's W-row forward launches row 17
    once a layer (2), and the prime once a layer at batch 1; in f32 the
    best sequence equals the plain route's (the recurrence kernels'
    plain versions swapped in) and its score within BEAM_SCORE_ATOL;
    bf16 reported beside it."""
    from deeplearning4j_tpu_torch.util import decoding
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    model = TextGenerationLSTM(vocab_size=LSTM_VOCAB)
    rng = np.random.default_rng(9)
    prompt = [int(t) for t in rng.integers(0, LSTM_VOCAB, LSTM_PROMPT)]
    rec = {"card": smi, "beam_width": BEAM_W, "steps": BEAM_STEPS,
           "peak": BEAM_PEAK}
    failures = []
    for dtype in (torch.bfloat16, torch.float32):
        net = text_lstm_net(device, dtype)
        out_key = str(LSTM_LAYERS)
        with torch.no_grad():
            net.params[out_key]["W"].mul_(BEAM_PEAK)
        net._compute = None
        forwards = [0]
        real = decoding.step_tokens

        def counted(n, tokens):
            forwards[0] += 1
            return real(n, tokens)
        zero_counts()
        decoding.step_tokens = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq, score = model.beam_search(net, prompt, BEAM_STEPS,
                                           beam_width=BEAM_W)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            decoding.step_tokens = real
        c = lstm_counts()
        per_step = (c["lstm_fwd"] - LSTM_LAYERS) / max(1, forwards[0])
        r = {"sequence": seq[LSTM_PROMPT:], "score": score, "wall_s": dt,
             "forwards": forwards[0], "launches": c,
             "launches_per_step": per_step,
             "steps_per_s": forwards[0] / dt}
        if per_step != LSTM_LAYERS or c["lstm_bwd"] or forwards[0] == 0:
            failures.append(f"{dtype}: {c} for {forwards[0]} steps")
        if dtype == torch.float32:
            pseq, pscore = with_swaps(lstm_swapped(), lambda: (
                model.beam_search(net, prompt, BEAM_STEPS,
                                  beam_width=BEAM_W)))
            r["plain_sequence_equal"] = pseq == seq
            r["plain_score_diff"] = abs(pscore - score)
            if pseq != seq or abs(pscore - score) > BEAM_SCORE_ATOL:
                failures.append(f"f32: kernel {seq[LSTM_PROMPT:]} {score} "
                                f"against plain {pseq[LSTM_PROMPT:]} "
                                f"{pscore}")
        rec["bf16" if dtype == torch.bfloat16 else "f32"] = r
        del net
        torch.cuda.empty_cache()
    rec["bf16_equals_f32"] = rec["bf16"]["sequence"] == rec["f32"]["sequence"]
    rec["launches"] = rec["bf16"]["launches"]
    log("beam:", json.dumps(rec))
    if failures:
        raise AssertionError(f"beam: {failures}")
    return rec


#: spec_model: the draft's depth and seed, gamma, the prompt's and the
#: generation's lengths, the sampled runs' temperature; the largest |log
#: p| gap an f32 verify distribution may show against one-shot
#: ``output()`` over the committed ids (sound: ~1e-5; a stale or
#: unrewound cache reads O(1e-1), see SURVIVE_LOGP); the beam part's
#: width, steps, output-layer peak (no near ties in f32) and score limit
SPEC_MODEL_DRAFT, SPEC_MODEL_DRAFT_SEED, SPEC_MODEL_GAMMA = 1, 17, 4
SPEC_MODEL_PROMPT, SPEC_MODEL_TOKENS, SPEC_MODEL_TEMP = 64, 96, 1.0
SPEC_MODEL_LOGP = 1e-3
SPEC_BEAM_W, SPEC_BEAM_STEPS, SPEC_BEAM_PEAK = 4, 24, 4.0
SPEC_BEAM_ATOL = 1e-4


class RecordingRng:
    """A numpy Generator's stand-in for the decoders: forwards
    ``choice`` and ``random`` and keeps the bit generator's state before
    each draw."""

    def __init__(self, seed):
        self.gen = np.random.default_rng(seed)
        self.states = []

    def _keep(self, kind):
        self.states.append(
            f"{kind}:{self.gen.bit_generator.state['state']['state']}")

    def choice(self, *a, **kw):
        self._keep("choice")
        return self.gen.choice(*a, **kw)

    def random(self, *a, **kw):
        self._keep("random")
        return self.gen.random(*a, **kw)


def spec_probe(net):
    """Patch the decoders' ``verify_tokens`` and ``accept_proposals`` to
    keep, for ``net``'s verify forwards, each chunk's first stream
    position, tokens and distributions, and every acceptance walk's
    (proposed, accepted); returns (record, undo)."""
    from deeplearning4j_tpu_torch.util import decoding
    real_v, real_a = decoding.verify_tokens, decoding.accept_proposals
    rec = {"verifies": [], "walks": []}

    def verify(n, chunks):
        pos = max(n._stream_pos_map.values(), default=0) \
            if hasattr(n, "_stream_pos_map") else n._stream_pos
        out = real_v(n, chunks)
        if n is net:
            rec["verifies"].append((pos, np.asarray(chunks)[0].tolist(),
                                    out[0]))
        return out

    def accept(proposals, *a):
        got = real_a(proposals, *a)
        rec["walks"].append((len(proposals), got[0]))
        return got
    decoding.verify_tokens, decoding.accept_proposals = verify, accept

    def undo():
        decoding.verify_tokens, decoding.accept_proposals = real_v, real_a
    return rec, undo


def verify_logp_gap(net, ids, verifies):
    """The largest |log p| difference between each verify forward's
    distribution at a committed context (the chunk's prefix is the
    committed ids there) and one-shot ``output()`` over the ids."""
    from deeplearning4j_tpu_torch.util.decoding import _one_hot
    net.rnn_clear_previous_state()
    ref = net.output(_one_hot(net, [ids[:-1]]))[0].float().cpu().numpy()
    worst, n = 0.0, 0
    for pos, chunk, tp in verifies:
        for j in range(len(chunk)):
            if pos + j + 1 >= len(ids) or chunk[:j + 1] != \
                    ids[pos:pos + j + 1]:
                break
            worst = max(worst, float(np.max(np.abs(
                np.log(np.clip(tp[:, j], 1e-30, None))
                - np.log(np.clip(ref[:, pos + j], 1e-30, None))))))
            n += 1
    return worst, n


def spec_model_phase(device, smi):
    """Model-draft speculation on the one-shot path: phase 4's served
    rope transformer at full width as the target, the same constructor
    with SPEC_MODEL_DRAFT layers and another seed as the draft.
    ``speculative_sample`` at gamma SPEC_MODEL_GAMMA, greedy and sampled:
    in f32 the greedy tokens equal ``sample_stream``'s or first part at a
    top-two gap under SPEC_GAP; every verify distribution at a committed
    context within SPEC_MODEL_LOGP of one-shot ``output()``; two sampled
    runs give the same tokens and the same rng state before every draw.
    Target forwards a committed token, acceptance, and tokens/s against
    ``sample_stream`` in bf16 turns (spec, plain, plain, spec). Then
    ``speculative_beam_search`` at SPEC_BEAM_W beams with the
    prompt-lookup proposer and with the model draft: in f32 (output
    weights peaked by SPEC_BEAM_PEAK) the sequence equal to
    ``beam_search``'s and the score within SPEC_BEAM_ATOL; bf16
    reported."""
    from deeplearning4j_tpu_torch.util import decoding
    rng = np.random.default_rng(13)
    pattern = [int(t) for t in rng.integers(1, VOCAB, 16)]
    prompt = (pattern * (SPEC_MODEL_PROMPT // 16 + 1))[:SPEC_MODEL_PROMPT]
    rec = {"card": smi, "gamma": SPEC_MODEL_GAMMA,
           "draft_layers": SPEC_MODEL_DRAFT, "tokens": SPEC_MODEL_TOKENS,
           "logp_limit": SPEC_MODEL_LOGP}
    failures = []
    modes = {"greedy": {"top_k": 1},
             "sampled": {"temperature": SPEC_MODEL_TEMP}}

    def spec(net, draft, kw, seed=0):
        probe, undo = spec_probe(net)
        r = RecordingRng(seed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = decoding.speculative_sample(
                net, draft, prompt, SPEC_MODEL_TOKENS, VOCAB,
                gamma=SPEC_MODEL_GAMMA, rng=r, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            undo()
        new = len(ids) - len(prompt)
        proposed = sum(p for p, _ in probe["walks"])
        accepted = sum(a for _, a in probe["walks"])
        return ids, {"wall_s": dt, "tokens_per_s": new / dt,
                     "target_forwards": 1 + len(probe["verifies"]),
                     "target_forwards_per_token":
                         (1 + len(probe["verifies"])) / new,
                     "acceptance": accepted / max(1, proposed),
                     "rng_draws": len(r.states)}, probe, r.states

    def plain(net, kw, seed=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = decoding.sample_stream(net, prompt, SPEC_MODEL_TOKENS, VOCAB,
                                     rng=np.random.default_rng(seed), **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return ids, {"wall_s": dt,
                     "tokens_per_s": (len(ids) - len(prompt)) / dt}

    # f32: the correctness gates
    _, net = served_net(device, dtype="float32")
    _, draft = served_net(device, layers=SPEC_MODEL_DRAFT, dtype="float32",
                          seed=SPEC_MODEL_DRAFT_SEED)
    f32 = rec["f32"] = {}
    for mode, kw in modes.items():
        ids, r, probe, states = spec(net, draft, kw)
        gap, n = verify_logp_gap(net, ids, probe["verifies"])
        r.update(verify_logp_max=gap, verify_positions=n)
        if n == 0 or gap > SPEC_MODEL_LOGP:
            failures.append(f"f32 {mode}: verify |log p| {gap} over {n} "
                            "positions")
        if mode == "greedy":
            pids, _ = plain(net, kw)
            d, margin = first_flip(net, pids, ids, prompt, kw, 0)
            r.update(equal_to_sample_stream=ids == pids, first=d,
                     margin=margin)
            if d is not None and margin >= SPEC_GAP:
                failures.append(f"f32 greedy: parts from sample_stream at "
                                f"{d}, top-two gap {margin}")
        else:
            ids2, _, _, states2 = spec(net, draft, kw)
            r.update(repeat_equal=ids2 == ids,
                     rng_states_equal=states2 == states)
            if ids2 != ids or states2 != states:
                failures.append("f32 sampled: a repeat parts (tokens or "
                                "the rng states before the draws)")
        f32[mode] = r
    # the beam search, f32 with peaked output weights
    with torch.no_grad():
        net.params["out"]["W"].mul_(SPEC_BEAM_PEAK)
    net._compute = None
    beam = rec["beam_f32"] = {}
    want = decoding.beam_search(net, prompt, SPEC_BEAM_STEPS, VOCAB,
                                beam_width=SPEC_BEAM_W)
    for name, d in (("lookup", decoding.prompt_lookup_proposer(SPEC_NGRAM)),
                    ("model", draft)):
        probe, undo = spec_probe(net)
        try:
            got = decoding.speculative_beam_search(
                net, d, prompt, SPEC_BEAM_STEPS, VOCAB,
                beam_width=SPEC_BEAM_W, gamma=SPEC_MODEL_GAMMA)
        finally:
            undo()
        beam[name] = {"sequence_equal": got[0] == want[0],
                      "score": got[1], "beam_search_score": want[1],
                      "target_forwards": 1 + len(probe["verifies"])}
        if got[0] != want[0] or abs(got[1] - want[1]) > SPEC_BEAM_ATOL:
            failures.append(f"f32 beam {name}: {got[0][len(prompt):]} "
                            f"{got[1]} against {want[0][len(prompt):]} "
                            f"{want[1]}")
    del net, draft
    torch.cuda.empty_cache()
    # bf16: tokens/s in turns, then the beam search reported
    _, net = served_net(device)
    _, draft = served_net(device, layers=SPEC_MODEL_DRAFT,
                          seed=SPEC_MODEL_DRAFT_SEED)
    spec(net, draft, modes["greedy"])                       # warm
    bf16 = rec["bf16"] = {}
    for mode, kw in modes.items():
        turns = {"spec": [], "plain": []}
        for kind in ("spec", "plain", "plain", "spec"):
            turns[kind].append(spec(net, draft, kw)[1] if kind == "spec"
                               else plain(net, kw)[1])
        bf16[mode] = {
            "spec_tokens_per_s": [t["tokens_per_s"] for t in turns["spec"]],
            "plain_tokens_per_s": [t["tokens_per_s"]
                                   for t in turns["plain"]],
            "target_forwards_per_token":
                turns["spec"][0]["target_forwards_per_token"],
            "acceptance": turns["spec"][0]["acceptance"]}
    with torch.no_grad():
        net.params["out"]["W"].mul_(SPEC_BEAM_PEAK)
    net._compute = None
    want = decoding.beam_search(net, prompt, SPEC_BEAM_STEPS, VOCAB,
                                beam_width=SPEC_BEAM_W)
    rec["beam_bf16"] = {}
    for name, d in (("lookup", decoding.prompt_lookup_proposer(SPEC_NGRAM)),
                    ("model", draft)):
        got = decoding.speculative_beam_search(
            net, d, prompt, SPEC_BEAM_STEPS, VOCAB, beam_width=SPEC_BEAM_W,
            gamma=SPEC_MODEL_GAMMA)
        rec["beam_bf16"][name] = {"sequence_equal": got[0] == want[0],
                                  "score": got[1],
                                  "beam_search_score": want[1]}
    del net, draft
    torch.cuda.empty_cache()
    log("spec_model:", json.dumps(rec))
    if failures:
        raise AssertionError(f"spec_model: {failures}")
    return rec


#: lenet: the batch, the batches a fit, K; the evaluation's examples
LENET_B, LENET_BATCHES, LENET_K, LENET_EVAL = 64, 32, 4, 1024


def lenet_phase(device, smi):
    """LeNet (``zoo/lenet.py``) at full width (28x28x1, 20 and 50
    channels, dense 500, 10 classes) on the synthetic MNIST iterator
    (LENET_BATCHES batches of LENET_B), features through a
    ``NormalizerMinMaxScaler`` fitted on it: two eager fits and a
    ``steps_per_dispatch=LENET_K`` graph fit from the same start, bitwise
    equal (cuDNN deterministic); images/s and ms a step, graph against
    eager in turns (graph, eager, eager, graph); ``evaluate`` on a held-out
    synthetic set above chance; ``feed_forward`` (six activations, the
    last ``output()``'s bitwise); the archive with the normalizer
    embedded restored on the card: parameters, output and the
    normalizer's transform bitwise."""
    import tempfile
    from deeplearning4j_tpu_torch.datasets import (
        ArrayDataSetIterator, MnistDataSetIterator, NormalizerMinMaxScaler)
    from deeplearning4j_tpu_torch.util import model_serializer as ms
    from deeplearning4j_tpu_torch.zoo import LeNet
    it = MnistDataSetIterator(LENET_B, synthetic=True, flatten=False,
                              num_examples=LENET_B * LENET_BATCHES,
                              shuffle=False)
    norm = NormalizerMinMaxScaler().fit(it)
    x, y = norm.transform(it.features), it.labels
    held = MnistDataSetIterator(LENET_B, train=False, synthetic=True,
                                flatten=False, num_examples=LENET_EVAL,
                                seed=7)
    xt, yt = norm.transform(held.features), held.labels
    rec = {"card": smi, "batch": LENET_B, "batches": LENET_BATCHES,
           "k": LENET_K}
    failures = []
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = LeNet().init(device=device)
        init = start_of(net)
        e1 = run_fit(net, x, y, LENET_B, init, 1, 0, True)
        e2 = run_fit(net, x, y, LENET_B, init, 1, 0, True)
        g1 = run_fit(net, x, y, LENET_B, init, LENET_K)
        gate = eager_gate(e1, e2, g1)
        turns = {"graph": [], "eager": []}
        for kind in ("graph", "eager", "eager", "graph"):
            kp = (LENET_K,) if kind == "graph" else (1, 0, True)
            turns[kind].append(run_fit(net, x, y, LENET_B, init, *kp))
        gate_replayed = eager_gate(e1, e2, turns["graph"][0])
    finally:
        torch.backends.cudnn.deterministic = prev
    ms_step = {k: [r["step_ms"] for r in v] for k, v in turns.items()}
    rec.update(gate_first_graph_fit=gate, gate_replayed_graph_fit=gate_replayed,
               step_ms=ms_step,
               images_per_s={k: [1e3 * LENET_B / m for m in v]
                             for k, v in ms_step.items()},
               graph_dispatch=turns["graph"][0]["dispatch"],
               losses=e1["losses"])
    if not (gate["held"] and gate["graph_bitwise"]
            and gate_replayed["held"]):
        failures.append(f"graph fit against eager {gate} {gate_replayed}")
    ev = net.evaluate(ArrayDataSetIterator(xt, yt, 256))
    rec["accuracy"] = ev.accuracy()
    if not rec["accuracy"] > 0.2:
        failures.append(f"accuracy {rec['accuracy']} after one epoch")
    acts = net.feed_forward(xt[:LENET_B])
    out = net.output(xt[:LENET_B])
    rec["feed_forward_shapes"] = [list(a.shape) for a in acts]
    if len(acts) != 6 or not torch.equal(acts[-1], out) or not all(
            bool(torch.isfinite(a).all()) for a in acts):
        failures.append(f"feed_forward {rec['feed_forward_shapes']}")
    with tempfile.TemporaryDirectory(prefix="dl4j_lenet_") as tmp:
        path = os.path.join(tmp, "lenet.zip")
        t0 = time.perf_counter()
        ms.write_model(net, path)
        ms.add_normalizer_to_model(path, norm)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ms.restore_model(path, device=device)
        norm2 = ms.restore_normalizer_from_file(path)
        restore_s = time.perf_counter() - t0
        raw = it.features[:LENET_B]
        same = {
            "params": all(torch.equal(a, b) for a, b in zip(
                tensor_leaves((net.params,)), tensor_leaves((back.params,)),
                strict=True)),
            "output": bool(torch.equal(back.output(xt[:LENET_B]), out)),
            "normalizer": type(norm2).__name__ == type(norm).__name__
            and bool(np.array_equal(norm2.transform(raw),
                                    norm.transform(raw)))}
        rec["archive"] = {"write_s": write_s, "restore_s": restore_s,
                          "bytes": os.path.getsize(path), "bitwise": same}
        if not all(same.values()):
            failures.append(f"archive {same}")
    del net, back
    torch.cuda.empty_cache()
    log("lenet:", json.dumps(rec))
    if failures:
        raise AssertionError(f"lenet: {failures}")
    return rec


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
                       if "registers" in line or "spill" in line
                       or "entry function" in line]
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
            # the units the kernel runs on at the main shape: "tensor_cores"
            # (mma.sync) or "cuda_cores"
            "core_route": k["route"],
            **errors(main), "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "tflops": k["tflops"],
            "library_ms": k["library_ms"],
            **({"library_bwd_ms": k["library_bwd_ms"]}
               if "library_bwd_ms" in k else {}),
            "shape": main["shape"], "dtype": main["dtype"],
            "limits": main["limits"],
            "max_abs_err_all": max(worst(c, "max_abs_err") for c in cases),
            "cases": [{"case": c["case"], **c["kernels"][name], **errors(c),
                       "limits": c["limits"],
                       **({"bitwise_repeat": c["bitwise_repeat"]}
                          if "bitwise_repeat" in c else {})}
                      for c in cases]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every measurement here")
    ap.add_argument("--parent", help="another checkout of the repo (the "
                    "parent commit's tree): phases 3, 3c, 10, 13, 16, 20 "
                    "and the LSTM kernels' build its paged, conv, "
                    "backward, stem, fused and LSTM kernels, time them in "
                    "turns with this one's and show the NaN bar failing "
                    "on them")
    ap.add_argument("--phases", help="a comma-separated subset of the "
                    "phases to run (by their phase_s names; debugging): "
                    "no kernels line and no result line")
    ap.add_argument("--calibrate", action="store_true",
                    help="record serve_int8's measured int8 verdict into "
                    "the kernel-crossover store (KERNEL_CROSSOVER_TORCH."
                    "json) for kv_dtype='auto' (the reference's "
                    "BENCH_CALIBRATE=1 run); off by default")
    ap.add_argument("--durable-child", choices=("kill", "resume"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--durable-dir", help=argparse.SUPPRESS)
    ap.add_argument("--durable-out", help=argparse.SUPPRESS)
    ap.add_argument("--capture-gc-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = set(args.phases.split(",")) if args.phases else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    if args.durable_child:
        return durable_child(args.durable_child, args.durable_dir,
                             args.durable_out)
    if args.capture_gc_child:
        return capture_gc_child()

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

    out = {"card": smi, "build_s": build_s, "build_ptxas": build_logs}
    if args.parent:
        out["parent_build_s"] = build_parent_libraries(args.parent)
        log(f"parent build: {out['parent_build_s']:.2f} s")
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
        out["paged_cases"] = phase("paged", check_paged_kernel, device, rng,
                                   args.parent)
    if want("paged_quant"):
        pq = phase("paged_quant", check_paged_quant_kernel, device,
                   np.random.default_rng(3), args.parent)
        out["paged_quant_cases"], out["paged_quant_sass"] = pq["cases"], \
            pq["sass"]
    if want("flash"):
        out["flash_sass"] = phase("flash_sass", flash_sass)
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
        out["serve_int8"] = phase("serve_int8", serve_int8, device,
                                  args.calibrate)
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
    if want("train_reference_bf16"):
        out["train_reference_bf16"] = phase(
            "train_reference_bf16", train_reference_bf16, device)
    if want("cnn"):
        cnn = phase("cnn", check_cnn_kernels, device, smi, args.parent)
        out["cnn_cases"], out["cnn_fwd_sweep"], out["cnn_sass"] = \
            cnn["cases"], cnn["sweep"], cnn["sass"]
        out["cnn_nan_bar"] = cnn["nan_bar"]
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
        bwd = phase("cnn_bwd", check_cnn_bwd_kernels, device, smi,
                    args.parent)
        out["cnn_bwd_cases"], out["cnn_bwd_sweep"], out["cnn_bwd_sass"] = \
            bwd["cases"], bwd["sweep"], bwd["sass"]
        out["cnn_bwd_nan_bar"] = bwd["nan_bar"]
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
        sb = phase("stem_bwd", check_stem_bwd_kernels, device, args.parent)
        out["stem_bwd_cases"], out["stem_bwd_sass"] = sb["cases"], \
            sb["sass"]
        out["stem_bwd_nan_bar"] = sb["nan_bar"]
        out["stem_dw_launches"], out["stem_dw_guard"] = \
            sb["dw_launches"], sb["dw_guard"]
        out["stem_dx_launches"], out["stem_dx_guard"] = \
            sb["dx_launches"], sb["dx_guard"]
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
            "stem")
    if want("auto_plan"):
        out["auto_plan"] = phase("auto_plan", auto_plan, device)
    if want("fused_kernels"):
        fk = phase("fused_kernels", check_fused_kernels, device,
                   args.parent)
        out["fused_cases"], out["fused_sass"] = fk["cases"], fk["sass"]
        out["fused_nan_bar"] = fk["nan_bar"]
    if want("resnet_fuse_true"):
        rf = out["resnet_fuse_true"] = phase("resnet_fuse_true",
                                             resnet_fuse_true, device)
        log("resnet fuse_true:", json.dumps({
            "inference": {p: rf["inference"]["turns_" + p]
                          ["output_ms_median"] for p in ("fuse_true", "xla")},
            "train": {p: {k: rf["turns_" + p][k] for k in (
                "step_ms_median", "images_per_s",
                "max_memory_allocated_bytes")} for p in ("fuse_true", "xla")},
            "card": smi}))
    if want("resnet_fuse_true_reference"):
        out["resnet_fuse_true_reference"] = phase(
            "resnet_fuse_true_reference", resnet_train_reference, device,
            "fuse_true")
    if want("lstm_kernels"):
        lkc = phase("lstm_kernels", check_lstm_kernels, device, exp_rate,
                    args.parent)
        out["lstm_cases"], out["lstm_sass"] = lkc["cases"], lkc["sass"]
    if want("text_lstm"):
        tl = out["text_lstm"] = phase("text_lstm", text_lstm, device)
        log("text_lstm:", json.dumps({
            "output_ms_median": tl["inference"]["output_ms_median"],
            "stream_tokens_per_s": tl["stream"]["tokens_per_s"],
            "train_step_ms_median": tl["train"]["step_ms_median"],
            "train_tokens_per_s": tl["train"]["tokens_per_s"],
            "max_memory_allocated_bytes":
                tl["train"]["max_memory_allocated_bytes"], "card": smi}))
    if want("text_lstm_reference"):
        out["text_lstm_reference"] = phase("text_lstm_reference",
                                           text_lstm_reference, device)
    if want("serializer"):
        out["serializer"] = phase("serializer", serializer, device)
    if want("regularized_lstm"):
        rl = out["regularized_lstm"] = phase("regularized_lstm",
                                             regularized_lstm, device)
        log("regularized_lstm:", json.dumps({
            "step_ms_median": rl["turns"]["step_ms_median"],
            "peak_bytes": rl["turns"]["peak_bytes"], "card": smi}))

    if want("fit_graph_transformer"):
        out["fit_graph_transformer"] = phase(
            "fit_graph_transformer", fit_graph_transformer, device)
    if want("fit_graph_resnet"):
        out["fit_graph_resnet"] = phase("fit_graph_resnet",
                                        fit_graph_resnet, device)
    if want("fit_graph_sentinel"):
        out["fit_graph_sentinel"] = phase("fit_graph_sentinel",
                                          fit_graph_sentinel, device)
    if want("fit_graph_draws"):
        out["fit_graph_draws"] = phase("fit_graph_draws", fit_graph_draws,
                                       device, smi)
    if want("durable_transformer"):
        out["durable_transformer"] = phase(
            "durable_transformer", durable_transformer, device, smi)
    if want("recovery_resnet"):
        out["recovery_resnet"] = phase("recovery_resnet", recovery_resnet,
                                       device, smi)
    if want("prefetch_lstm"):
        out["prefetch_lstm"] = phase("prefetch_lstm", prefetch_lstm, device)
    if want("evaluate"):
        out["evaluate"] = phase("evaluate", evaluate_phase, device, smi)
    if want("early_stop"):
        out["early_stop"] = phase("early_stop", early_stop, device, smi)
    if want("serve_spec"):
        out["serve_spec"] = phase("serve_spec", serve_spec, device, smi)
    if want("serve_survive"):
        out["serve_survive"] = phase("serve_survive", serve_survive, device,
                                     smi)
    if want("serve_overload"):
        out["serve_overload"] = phase("serve_overload", serve_overload,
                                      device, smi)
    if want("serve_lstm"):
        out["serve_lstm"] = phase("serve_lstm", serve_lstm, device, smi)
    if want("capture_gc"):
        out["capture_gc"] = phase("capture_gc", capture_gc, device, smi)
    if want("serve_graph"):
        out["serve_graph"] = phase("serve_graph", serve_graph, device, smi)
    if want("beam"):
        out["beam"] = phase("beam", beam_phase, device, smi)
    if want("spec_model"):
        out["spec_model"] = phase("spec_model", spec_model_phase, device,
                                  smi)
    if want("lenet"):
        out["lenet"] = phase("lenet", lenet_phase, device, smi)
    graph_recs = {k: out[k] for k in ("fit_graph_transformer",
                                      "fit_graph_resnet") if k in out}
    if graph_recs:
        log("fit graphs:", json.dumps({
            **{k: graph_line(v) for k, v in graph_recs.items()},
            "card": smi}))
    if "prefetch_lstm" in out:
        log("prefetch lstm:", json.dumps({
            k: out["prefetch_lstm"][k] for k in (
                "step_ms_median", "losses_bitwise",
                "h2d_critical_ms_per_step")} | {"card": smi}))

    if only is not None:
        log(f"chip_smoke: phases {sorted(only)} passed in "
            f"{time.perf_counter() - t_start:.1f} s (a partial run: no "
            f"kernels line, no result line)")
        if args.json:
            out.update(phase_s=phase_s)
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


def graph_line(rec):
    """The headline numbers of a graph phase's record (per plan for
    ResNet50)."""
    def one(r):
        t = r["profiled_turns"]
        return {"eager_step_ms": r["eager_step_ms_median"],
                "graph_step_ms": r["graph_step_ms_median"],
                "busy_eager": t["eager"]["device_busy_share"]["values"],
                "busy_graph": t["graph"]["device_busy_share"]["values"],
                "host_launches_per_step": [
                    t["eager"]["host_launches_per_step"]["median"],
                    t["graph"]["host_launches_per_step"]["median"]],
                "captures": r["captures"],
                "gate": r["gate_first_graph_fit"]["rule"]}
    return one(rec) if "captures" in rec else {k: one(v)
                                               for k, v in rec.items()}


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
        "design": "redesigned: row 15's split decode over the int8 pools "
                  "(16 warps a (slot, head), up to 8 blocks at the verify "
                  "shape)",
        "ptxas": out["paged_quant_sass"],
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
            out["resnet"]["launches"][name], out["cnn_cases"],
            out["cnn_fwd_sweep"]))
    for name, line in (("bwd1x1", 301), ("bwd3x3", 403)):
        kernels.append(bwd_entry(
            name, f"deeplearning4j_tpu/nn/layers/bottleneck.py:{line}",
            out["resnet_train"]["launches"][name], out["cnn_bwd_cases"],
            out["cnn_bwd_sweep"]))
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
    for name, line in (("fused_fwd", 75), ("fused_bwd", 85)):
        kernels.append(fused_entry(
            name, f"deeplearning4j_tpu/nn/layers/fused.py:{line}",
            out["resnet_fuse_true"]["launches"][name], out["fused_cases"]))
    # the backward has no TPU twin: it replaces _lstm_bwd, the custom_vjp
    # rule that differentiates through the JAX scan
    for name, line in (("lstm_fwd", 41), ("lstm_bwd", 163)):
        kernels.append(lstm_entry(
            name, f"deeplearning4j_tpu/nn/layers/pallas_kernels.py:{line}",
            out["text_lstm"]["train"]["launches"][name], out["lstm_cases"],
            out["text_lstm"]))
    # the launches of the evaluation, early-stopping and speculation
    # paths (phases 34-36), each counted from 0 over its own run
    paths = {"evaluate": out["evaluate"]["launches"],
             "early_stop": out["early_stop"]["trainer"]["launches"],
             "serve_spec_bf16": out["serve_spec"]["bf16"]["counted_turn"]
             ["launches"],
             "serve_spec_int8": out["serve_spec"]["int8"]["counted_turn"]
             ["launches"],
             # the survivable engine's supervised runs (rebuilds, the
             # seizure and the seat fault in them), the LSTM arena
             "serve_survive_bf16": out["serve_survive"]["bf16"]["perturbed"]
             ["all_launches"],
             "serve_survive_int8": out["serve_survive"]["int8"]["perturbed"]
             ["all_launches"],
             "serve_lstm": out["serve_lstm"]["launches"],
             # the decode graphs' traced windows (every config), and
             # the text LSTM's beams (bf16)
             "serve_graph": out["serve_graph"]["launches"],
             "beam": out["beam"]["launches"]}
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()
                                 if c.get(k["name"])}
        if k["name"] == "lstm_fwd":
            k["serve_lstm_launches_per_decode_step"] = \
                out["serve_lstm"]["launches_per_decode_step"]
    return kernels


if __name__ == "__main__":
    sys.exit(main())
