// The fused BatchNorm -> activation -> 1x1 convolution, for Hopper
// (sm_90a): the forward product with the BN affine (+ relu) as the
// prologue of its input and the bias in its epilogue, and the one-pass
// backward over (y, g).
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/fused.py:
//   fwd <- `_fwd_kernel` (pallas_call in `_pallas_fwd`)
//   bwd <- `_bwd_kernel` (pallas_call in `_pallas_bwd`)
// y [M, C] is the flattened NHWC raw conv output feeding the BN, sc, bb
// [C] the folded BN affine (f32), W [C, K] in y's dtype, b [K] f32. Each
// computes what its TPU kernel computes:
//   fwd: z = act(y sc + bb) in f32 from y's stored values, rounded to
//        W's dtype; out = z W accumulated in f32, plus b, rounded to y's
//        dtype;
//   bwd: z0 = y sc + bb, z = act(z0) recomputed (never stored);
//        dz = g W^T in f32, masked by z0 > 0 under relu;
//        dy = dz sc rounded to y's dtype;
//        dW = sum over rows of (z rounded to g's dtype)^T g, in f32,
//             rounded to W's dtype;
//        dsc = sum dz y, dbb = sum dz, db = sum g, all f32.
// Rows past M are never read and enter no sum.
//
// Translation. The TPU kernels walk row blocks of y on a sequential grid
// with the whole weight resident in VMEM, and the backward carries dW and
// the three sums across the grid in VMEM scratch. Blocks on an H100 run in
// no order, so nothing carries over between them.
//
// What bounds it on an H100. At ResNet50's shapes in bf16 at B=128 the
// s2 group (M = 401,408, C = 64, K = 256) moves y (51 MB) and out (206
// MB) forward, y, g, dy (308 MB) backward: bytes, 0.077 and 0.092 ms at
// 3.35 TB/s, against 13 and 26 GFLOP (0.013, 0.027 ms at 989 TFLOP/s);
// s5 (M = 6,272, C = 512, K = 2048) is bound by its operations.
//
// The bf16 forward, the main path's, runs on the tensor cores: it is the
// bottleneck's conv1x1 as a stride-1 1x1 over M images of one pixel,
// conv_fwd_tc.cuh's fwd_tc_kernel with the bias epilogue (kBias: the f32
// bias added to the f32 sum, rounded once; no sums). That header says
// how the design meets the bound: a persistent grid (its block rows
// planned by fused.py with bottleneck.py's rule) whose cp.async ring runs
// on between 128-row blocks, the prologue converted once per staged
// element, mma.sync tiles fed by ldmatrix, stores 16 bytes a thread. What
// still holds it back: each block's copy, conversion, products and
// stores run one after another at one or two blocks an SM, and
// mma.sync's rate is below wgmma's.
//
// The bf16 backward, the main path's, runs on the tensor cores too: it
// is the bottleneck's bwd1x1 stage (conv_bwd_tc.cuh) in its kFused mode,
// two passes over (y, g) with no float atomics:
//   - the dz pass: 128 rows of M a block and up to 128 channels of C (C
//     > 128: more column tiles); g itself is the A operand, copied 16
//     bytes a thread by cp.async into a 3-stage ring of [128][32 + 8]
//     tiles that ldmatrix reads (no conversion pass, one block barrier a
//     chunk of 32 of K), W [C, K] the B operand; the tensor cores'
//     partials promoted with round-to-nearest adds every 4 k16 steps (at
//     s5 K = 2048 is 128 of them); the epilogue stages the f32 tile in
//     shared memory, masks it by relu'(y sc + bb) on the unrounded z0,
//     sums dz y and dz from the f32 dz into per-block partials and stores
//     dy = dz sc, 16 bytes a thread;
//   - the dW pass: 64 or 128 channels of z by 64 to 256 columns of g a
//     block, over a split of M's 64-row chunks; y copied by cp.async and
//     converted once into z = round(act(y sc + bb)), g's ring tile read
//     by ldmatrix.trans as it landed; promoted every 8 k16 steps; the
//     blocks of the first channel tile also sum g's columns (db) into
//     row C of the partials [splits, C + 1, K];
//   - the sums' partials reduced per channel in a fixed order (f64,
//     conv_gemm.cuh's reduce_partials_kernel), the dW / db partials over
//     the splits in order (f64, fused_finish_kernel below).
// The plan (128-row dz blocks, the dW splits) is fused.py's _bwd_tc_plan,
// the bottleneck's 1x1 plan over M one-pixel images. What still holds
// it back: each pass reads g (and y) once more than one pass would (at
// s2 565 MB against the bound's 308 MB), a block's chain of chunks at
// the small-M stages (s4, s5: 25 and 49 dz blocks a column tile), and
// mma.sync's rate below wgmma's.
//
// The f32 forward and the f32 backward stay on conv_gemm.cuh's f32
// CUDA-core tiles (128 rows x 64 columns, 16-deep reduction steps; exact
// f32, no TF32): the f32 forward's prologue applied as the A tile is
// gathered (conv_gemm.cuh's load_tile), its epilogue adding b. The f32
// backward is two GEMMs over the same tiles. The dz pass: rows M,
// columns C, reduction over K (A = g, B = W^T); its epilogue recomputes
// z0 from y for the relu' mask, stores dy and sums dz y and dz into
// per-block partials, reduced per channel in a fixed order by
// conv_gemm.cuh's second pass. The dW pass: rows C, columns K, reduction
// over M split across the grid's z dimension into f32 partials, z
// recomputed from y as its tile is gathered; one more row of ones (row
// C) makes db = sum g the same product's last row. The splits are merged
// in a fixed order (f64), so two launches on the same inputs give
// bitwise-equal results. One pass over (y, g) for both products, each
// block's g tile and z kept for both (dz = g W^T needs g and W; dW = z^T
// g needs z and g: no dz), is later work (ROADMAP queue B, B3b).
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "conv_bwd_tc.cuh"
#include "conv_fwd_tc.cuh"
#include "conv_gemm.cuh"

#include <climits>

namespace {

using dl4j_conv::block_partials;
using dl4j_conv::from_f32;
using dl4j_conv::Geometry;
using dl4j_conv::kAStride;
using dl4j_conv::kBK;
using dl4j_conv::kBM;
using dl4j_conv::kBN;
using dl4j_conv::kBPerThread;
using dl4j_conv::kRowsPerThread;
using dl4j_conv::kThreads;
using dl4j_conv::round_to;
using dl4j_conv::tile_step;
using dl4j_conv::to_f32;

struct Fused {
  int m, c, k;   // y, dy [m, c]; W, dW [c, k]; g [m, k]
  int relu;      // the prologue's activation (else the identity)
  int tiles;     // the dz pass's partials per channel (>= row blocks)
  int chunk;     // the dW pass: reduction rows per split
  int splits;    // the dW pass: splits of M
};

// ---------------------------------------------------------------------
// forward: out[m, k] = round(sum_c z[m, c] W[c, k] + b[k])
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_fwd_kernel(const T* __restrict__ y, const float* __restrict__ sc,
                     const float* __restrict__ bb, const T* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ out,
                     Geometry g) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int rows = g.n;     // one row of y per "image" of one pixel

  // A loads: reduction offset a_k of rows a_m + 16 j; each row is its
  // own 1 x 1 image, so its anchor pixel is (0, 0)
  const int a_k = tid & 15;
  const int a_m = tid >> 4;
  int img[kRowsPerThread], ah[kRowsPerThread], aw[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int m = m0 + a_m + 16 * j;
    img[j] = m < rows ? m : -1;
    ah[j] = 0;
    aw[j] = 0;
  }
  // B loads: channel b_n, reduction rows b_k + 4 j
  const int b_n = tid & 63;
  const int b_k = tid >> 6;

  float ra[kRowsPerThread], rb[kBPerThread];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  dl4j_conv::load_tile<T, dl4j_conv::kConv1x1>(y, sc, bb, w, g, 0, a_k, img,
                                               ah, aw, b_k, b_n, n0, ra, rb);
  for (int k0 = 0; k0 < g.r; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      As[a_k * kAStride + a_m + 16 * j] = ra[j];
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) Bs[(b_k + 4 * j) * kBN + b_n] = rb[j];
    __syncthreads();
    if (k0 + kBK < g.r)   // in flight during the products
      dl4j_conv::load_tile<T, dl4j_conv::kConv1x1>(
          y, sc, bb, w, g, k0 + kBK, a_k, img, ah, aw, b_k, b_n, n0, ra, rb);
    tile_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // epilogue: the f32 sum plus the f32 bias, rounded once and stored
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= g.k) continue;
    const float bias = b[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m < rows)
        out[static_cast<int64_t>(m) * g.k + col] =
            from_f32<T>(__fadd_rn(acc[i][j], bias));
    }
  }
}

// ---------------------------------------------------------------------
// the dz pass: dz[m, c] = sum_k g[m, k] W[c, k]; the epilogue masks it by
// relu'(z0), stores dy = dz sc and sums dz y (dsc) and dz (dbb)
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dz_kernel(const T* __restrict__ y, const float* __restrict__ sc,
                    const float* __restrict__ bb, const T* __restrict__ w,
                    const T* __restrict__ gr, T* __restrict__ dy,
                    float* __restrict__ part1, float* __restrict__ part2,
                    Fused f) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loads: reduction offset a_k (g's column) of rows a_m + 16 j
  const int a_k = tid & 15;
  const int a_m = tid >> 4;
  // B loads: reduction offset b_k (consecutive threads read consecutive
  // k of one weight row) of columns b_c + 16 j
  const int b_k = tid & 15;
  const int b_c = tid >> 4;

  float ra[kRowsPerThread], rb[kBPerThread];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
    const int ka = k0 + a_k;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int m = m0 + a_m + 16 * j;
      ra[j] = (ka < f.k && m < f.m)
                  ? to_f32(gr[static_cast<int64_t>(m) * f.k + ka])
                  : 0.f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      const int col = n0 + b_c + 16 * j;
      rb[j] = (kb < f.k && col < f.c)
                  ? to_f32(w[static_cast<int64_t>(col) * f.k + kb])
                  : 0.f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < f.k; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      As[a_k * kAStride + a_m + 16 * j] = ra[j];
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) Bs[b_k * kBN + b_c + 16 * j] = rb[j];
    __syncthreads();
    if (k0 + kBK < f.k) load(k0 + kBK);
    tile_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // epilogue: z0 from y (op by op, as the plain version), the mask, the
  // store of dy, the sums of the f32 dz (s1: dz y, s2: dz)
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= f.c) continue;
    const float s = sc[col];
    const float o = bb[col];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + ty * 8 + i;
      if (m >= f.m) continue;
      const int64_t at = static_cast<int64_t>(m) * f.c + col;
      const float yf = to_f32(y[at]);
      float v = acc[i][j];
      if (f.relu && !(__fadd_rn(__fmul_rn(yf, s), o) > 0.f)) v = 0.f;
      dy[at] = from_f32<T>(__fmul_rn(v, s));
      s1[j] += __fmul_rn(v, yf);
      s2[j] += v;
    }
  }
  block_partials(smem, s1, s2, n0, f.c, f.tiles, part1, part2);
}

// ---------------------------------------------------------------------
// the dW pass: P[r, k] = sum_m A[r, m] g[m, k] over one split's rows m,
// r in [0, C]: A = z rounded to g's dtype for r < C, 1 for r = C (so
// P's last row is db); partials [splits, C + 1, K]
// ---------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dw_kernel(const T* __restrict__ y, const float* __restrict__ sc,
                    const float* __restrict__ bb, const T* __restrict__ gr,
                    float* __restrict__ part, Fused f) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int rows_r = f.c + 1;
  const int mb = blockIdx.z * f.chunk;
  const int m_end = min(mb + f.chunk, f.m);

  // A loads: one row r per thread (consecutive threads on consecutive
  // channels), reduction offsets a_k + 2 j
  const int a_r = tid & 127;
  const int a_k = tid >> 7;
  const int r = r0 + a_r;
  const bool is_z = r < f.c;
  const bool is_one = r == f.c;
  const float s = is_z ? sc[r] : 1.f;
  const float o = is_z ? bb[r] : 0.f;
  // B loads: column b_n (consecutive threads on consecutive k),
  // reduction offsets b_k + 4 j
  const int b_n = tid & 63;
  const int b_k = tid >> 6;
  const int col = n0 + b_n;
  const bool col_ok = col < f.k;

  float ra[kRowsPerThread], rb[kBPerThread];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int m = mb + k0 + a_k + 2 * j;
      float z = 0.f;
      if (m < m_end) {
        if (is_z) {
          z = __fadd_rn(__fmul_rn(to_f32(y[static_cast<int64_t>(m) * f.c + r]),
                                  s),
                        o);
          if (f.relu) z = dl4j_nan::relu_nan(z);
          z = round_to<T>(z);
        } else if (is_one) {
          z = 1.f;
        }
      }
      ra[j] = z;
    }
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      const int m = mb + k0 + b_k + 4 * j;
      rb[j] = (col_ok && m < m_end)
                  ? to_f32(gr[static_cast<int64_t>(m) * f.k + col])
                  : 0.f;
    }
  };

  const int len = m_end - mb;
  if (len > 0) load(0);
  for (int k0 = 0; k0 < len; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      As[(a_k + 2 * j) * kAStride + a_r] = ra[j];
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) Bs[(b_k + 4 * j) * kBN + b_n] = rb[j];
    __syncthreads();
    if (k0 + kBK < len) load(k0 + kBK);
    tile_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  float* out = part + static_cast<int64_t>(blockIdx.z) * rows_r * f.k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = r0 + ty * 8 + i;
    if (rr >= rows_r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < f.k) out[static_cast<int64_t>(rr) * f.k + cc] = acc[i][j];
    }
  }
}

// The dW pass's partials [splits, C + 1, K] summed over the splits in
// order (f64), one thread per entry: rows < C rounded to W's dtype into
// dW, row C into db (f32).
constexpr int kFinishThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
    fused_finish_kernel(const float* __restrict__ part, int splits, int c,
                        int k, T* __restrict__ dw, float* __restrict__ db) {
  const int64_t size = static_cast<int64_t>(c + 1) * k;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  if (i >= size) return;
  double a = 0.0;
  for (int z = 0; z < splits; ++z) a += part[z * size + i];
  const float v = static_cast<float>(a);
  const int64_t wsize = static_cast<int64_t>(c) * k;
  if (i < wsize)
    dw[i] = from_f32<T>(v);
  else
    db[i - wsize] = v;
}

// The f32 forward on the CUDA cores.
template <typename T>
int fused_fwd(const void* y, const void* sc, const void* bb, const void* w,
              const void* b, void* out, int m, int c, int k, int relu,
              void* stream) {
  if (m == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  Geometry g{m, 1, 1, c, 1, 1, k, 1, c, relu, 0};
  dim3 grid((m + kBM - 1) / kBM, (k + kBN - 1) / kBN);
  fused_fwd_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(bb), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<T*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forward on the tensor cores: the stride-1 1x1 over M images
// of one pixel on `slots` grid rows (fused.py's plan), the bias epilogue.
// Refuses (cudaErrorInvalidValue, before any launch) slots outside 1 ..
// the 128-row blocks, or a tensor of 2^31 - 1 elements or more (the
// kernel indexes with ints).
int fused_fwd_tc(const void* y, const void* sc, const void* bb,
                 const void* w, const void* b, void* out, int m, int c,
                 int k, int relu, int slots, void* stream) {
  if (static_cast<int64_t>(m) * c >= INT_MAX ||
      static_cast<int64_t>(m) * k >= INT_MAX ||
      static_cast<int64_t>(c) * k >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const int vec = c % 8 == 0 && k % 8 == 0 && dl4j_mma::aligned16(y) &&
                  dl4j_mma::aligned16(w) && dl4j_mma::aligned16(out);
  dl4j_fwd::Fwd s =
      dl4j_fwd::fwd_geometry<1>(m, 1, 1, c, k, 1, relu, vec, 0);
  if (slots < 1 || slots > s.tile.patches)
    return static_cast<int>(cudaErrorInvalidValue);
  s.slots = slots;
  return dl4j_fwd::launch_fwd_for<1, dl4j_fwd::kBias>(
      y, sc, bb, w, b, out, nullptr, nullptr, s,
      static_cast<cudaStream_t>(stream));
}

// Launch the backward's four kernels on `stream`: the dz pass, the sums'
// fixed-order reduction, the dW pass and its split reduction. Refuses
// (cudaErrorInvalidValue, before any launch) partials one row tile short,
// or splits that do not cover M in whole steps.
template <typename T>
int fused_bwd(const void* y, const void* sc, const void* bb, const void* w,
              const void* g, void* dy, void* dsc, void* dbb, void* dw,
              void* db, void* part1, void* part2, void* dw_part, int m,
              int c, int k, int relu, int tiles, int chunk, int splits,
              void* stream) {
  const Fused f{m, c, k, relu, tiles, chunk, splits};
  const int blocks = (m + kBM - 1) / kBM;
  if (m <= 0 || c <= 0 || k <= 0 || blocks > tiles || chunk <= 0 ||
      chunk % kBK || static_cast<int64_t>(chunk) * splits < m ||
      static_cast<int64_t>(chunk) * (splits - 1) >= m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* yp = static_cast<const T*>(y);
  const T* gp = static_cast<const T*>(g);
  const float* scp = static_cast<const float*>(sc);
  const float* bbp = static_cast<const float*>(bb);
  fused_dz_kernel<T><<<dim3(blocks, (c + kBN - 1) / kBN), kThreads, 0, st>>>(
      yp, scp, bbp, static_cast<const T*>(w), gp, static_cast<T*>(dy),
      static_cast<float*>(part1), static_cast<float*>(part2), f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dl4j_conv::reduce_partials_kernel<<<c, dl4j_conv::kReduceThreads, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      blocks, tiles, static_cast<float*>(dsc), static_cast<float*>(dbb));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_w((c + 1 + kBM - 1) / kBM, (k + kBN - 1) / kBN, splits);
  fused_dw_kernel<T><<<grid_w, kThreads, 0, st>>>(
      yp, scp, bbp, gp, static_cast<float*>(dw_part), f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(c + 1) * k;
  fused_finish_kernel<T><<<static_cast<unsigned>((size + kFinishThreads - 1) /
                                           kFinishThreads),
                     kFinishThreads, 0, st>>>(
      static_cast<const float*>(dw_part), splits, c, k, static_cast<T*>(dw),
      static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward on the tensor cores (conv_bwd_tc.cuh's kFused
// kernels): the dz pass, the sums' fixed-order reduction, the dW pass
// (db in its partials' row C) and the splits' reduction. `tiles` must
// cover the dz pass's 128-row blocks and chunk x splits the dW pass's
// 64-row chunks (fused.py's _bwd_tc_plan), and no tensor may hold 2^31 -
// 1 elements or more (the kernels index with ints):
// cudaErrorInvalidValue, before any launch, otherwise.
int fused_bwd_tc(const void* y, const void* sc, const void* bb,
                 const void* w, const void* g, void* dy, void* dsc,
                 void* dbb, void* dw, void* db, void* part1, void* part2,
                 void* dw_part, int m, int c, int k, int relu, int tiles,
                 int chunk, int splits, void* stream) {
  using dl4j_bwd::kDwPixels;
  using dl4j_bwd::kDzPixels;
  using dl4j_bwd::kFused;
  if (m <= 0 || c <= 0 || k <= 0 ||
      static_cast<int64_t>(m) * c >= INT_MAX ||
      static_cast<int64_t>(m) * k >= INT_MAX ||
      static_cast<int64_t>(c + 1) * k >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = c % 8 == 0 && k % 8 == 0 && dl4j_mma::aligned16(y) &&
                  dl4j_mma::aligned16(g) && dl4j_mma::aligned16(w) &&
                  dl4j_mma::aligned16(dy);
  // M images of one pixel: y is the stage's y_{k-1}, g its output
  // gradient, stride 1
  dl4j_bwd::TcStage s{m, 1, 1, c, 1, 1, k, 1, relu, vec,
                      dl4j_mma::Tiling{0, 0, 0, 0}, tiles, chunk};
  dl4j_bwd::TcStage sz = s, sw = s;
  sz.tile.patches = (m + kDzPixels - 1) / kDzPixels;
  sw.tile.patches = (m + kDwPixels - 1) / kDwPixels;
  if (sz.tile.patches > tiles || chunk <= 0 || splits <= 0 ||
      static_cast<int64_t>(chunk) * splits < sw.tile.patches ||
      static_cast<int64_t>(chunk) * (splits - 1) >= sw.tile.patches)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernels' places: yk unused, yprev = y, aff_k = bb, aff_p = sc
  int err = c <= 64 ? dl4j_bwd::launch_dz<1, 2, kFused>(
                          nullptr, g, y, w, bb, sc, dy, part1, part2, sz, st)
                    : dl4j_bwd::launch_dz<1, 4, kFused>(
                          nullptr, g, y, w, bb, sc, dy, part1, part2, sz, st);
  if (err) return err;
  dl4j_conv::reduce_partials_kernel<<<c, dl4j_conv::kReduceThreads, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      sz.tile.patches, tiles, static_cast<float*>(dsc),
      static_cast<float*>(dbb));
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  err = dl4j_bwd::launch_dw_for<1, kFused>(nullptr, g, y, bb, sc, dw_part,
                                           splits, sw, st);
  if (err) return err;
  const int64_t size = static_cast<int64_t>(c + 1) * k;
  fused_finish_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>((size + kFinishThreads - 1) / kFinishThreads),
         kFinishThreads, 0, st>>>(static_cast<const float*>(dw_part), splits,
                                  c, k, static_cast<__nv_bfloat16*>(dw),
                                  static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dl4j_fused_fwd_f32(const void* y, const void* sc, const void* bb,
                       const void* w, const void* b, void* out, int m, int c,
                       int k, int relu, void* stream) {
  return fused_fwd<float>(y, sc, bb, w, b, out, m, c, k, relu, stream);
}

int dl4j_fused_fwd_bf16(const void* y, const void* sc, const void* bb,
                        const void* w, const void* b, void* out, int m, int c,
                        int k, int relu, int slots, void* stream) {
  return fused_fwd_tc(y, sc, bb, w, b, out, m, c, k, relu, slots, stream);
}

int dl4j_fused_bwd_f32(const void* y, const void* sc, const void* bb,
                       const void* w, const void* g, void* dy, void* dsc,
                       void* dbb, void* dw, void* db, void* part1,
                       void* part2, void* dw_part, int m, int c, int k,
                       int relu, int tiles, int chunk, int splits,
                       void* stream) {
  return fused_bwd<float>(y, sc, bb, w, g, dy, dsc, dbb, dw, db, part1, part2,
                          dw_part, m, c, k, relu, tiles, chunk, splits,
                          stream);
}

int dl4j_fused_bwd_bf16(const void* y, const void* sc, const void* bb,
                        const void* w, const void* g, void* dy, void* dsc,
                        void* dbb, void* dw, void* db, void* part1,
                        void* part2, void* dw_part, int m, int c, int k,
                        int relu, int tiles, int chunk, int splits,
                        void* stream) {
  return fused_bwd_tc(y, sc, bb, w, g, dy, dsc, dbb, dw, db, part1, part2,
                      dw_part, m, c, k, relu, tiles, chunk, splits, stream);
}

int dl4j_fused_row_tile() { return kBM; }

// Bytes of dynamic shared memory the bf16 backward's dz and dW passes
// launch with at widths c, k (out[2]).
int dl4j_fused_bwd_tc_smem(int c, int k, int* out) {
  using dl4j_bwd::kFused;
  dl4j_bwd::TcStage s{};
  s.c = c;
  s.k = k;
  out[0] = static_cast<int>(c <= 64 ? dl4j_bwd::dz_smem<1, 2, kFused>(s)
                                    : dl4j_bwd::dz_smem<1, 4, kFused>(s));
  out[1] = static_cast<int>(
      dl4j_bwd::with_dw_shape<1>(s, [&](auto wm, auto wn) {
        return dl4j_bwd::dw_smem<1, decltype(wm)::value, decltype(wn)::value,
                                 kFused>(s);
      }));
  return 0;
}

// Bytes of dynamic shared memory the bf16 forward launches with.
int dl4j_fused_fwd_tc_smem(int m, int k) {
  return static_cast<int>(dl4j_fwd::fwd_smem_for(m, 1, 1, k, 1, 1));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
