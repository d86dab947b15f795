// The fused ResNet bottleneck's backward stages, for Hopper (sm_90a): one
// entry point per stage of a 1x1 conv (stride 1 or 2) or a 3x3 same-pad
// conv, computing the stage's weight gradient, the gradient of the
// previous stage's pre-activation and that stage's BN-backward sums.
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/bottleneck.py:
//   bwd1x1 <- `_bwd1x1_kernel` (pallas_call in `_bwd_stage`)
//   bwd3x3 <- `_bwd3x3_kernel` (pallas_call in `_bwd_stage`)
// Stage k's conv read z_{k-1} = act(y_{k-1} sc_p + bb_p) and wrote y_k.
// Given g = dz0_k and aff_k's rows (sc, bb, inv, mu, m1, m2), each
// computes what its TPU kernel computes:
//   dy   = sc (g - m1 - yhat m2), yhat = (y_k - mu) inv, in f32;
//   dW   = z_{k-1}^T dy, both operands rounded to the stage's dtype,
//          accumulated in f32 (the 3x3: per tap over the zero-padded
//          z_{k-1}, [9, C, K] tap-major, t = kh * 3 + kw);
//   dz   = (dy rounded to w's dtype) W^T, accumulated in f32 (the 3x3:
//          the transposed taps over the zero-padded dy), masked by
//          relu'(z0) on the UNROUNDED f32 z0 = y_{k-1} sc_p + bb_p, and
//          stored rounded; a stride-2 1x1 writes 0 where the conv never
//          read;
//   sums = sum dz, sum dz yhat_{k-1} over the f32 dz BEFORE its rounding
//          (the forward's epilogue sums the stored values instead).
// With the identity prologue (relu = 0: z_{k-1} is the block input) there
// is no affine, no mask and no sums: the caller's zeroed sums stay zero.
// A padded tap reads 0 in both passes, after the prologue: not sc (0 - m1
// - yhat(0) m2) in the dz pass, not relu(bb_p) in the dW pass.
//
// Translation. The TPU kernel holds one image (or a channel slice of it,
// the channel-split variant that exists for the TPU's VMEM budget) per
// grid step and carries dW and the sums along the sequential grid. Here
// a stage is two implicit GEMMs:
//   - the dz pass: rows = the conv's output pixels M = N Ho Wo, columns =
//     C, reduction over K (9K); the relu' mask, the store and the sums
//     run in the epilogue; the sums go through per-block partials and
//     conv_gemm.cuh's fixed-order pass;
//   - the dW pass: rows = C (9C), columns = K, reduction over M. M is
//     large and the output small (the s2 stage c's [64, 256] is one
//     block), so M is split across the grid's z dimension into f32
//     partials, reduced over the splits in a fixed order (f64): the same
//     dW on every run, no float atomics.
// Any shape tiles, so no channel split is needed.
//
// What bounds it on an H100. At B=128 in bf16 the s2 stage c (K=256 ->
// C=64 at 56x56, M = 401,408) reads y_k and g (411 MB) and y_{k-1} (51
// MB) and writes dz (51 MB): 0.153 ms at 3.35 TB/s against 26 GFLOP,
// 0.027 ms at 989 TFLOP/s, so bytes. The s2 3x3 (64 -> 64) moves 206 MB
// (0.061 ms) for 59 GFLOP (0.060 ms): both even. Every 3x3 of ResNet50 is
// 59 GFLOP, 0.88 ms even at the 67 TFLOP/s f32 CUDA-core peak, 0.060 ms
// at the tensor cores' 989 TFLOP/s.
//
// bf16, the training path's dtype, runs on the tensor cores
// (conv_bwd_tc.cuh's kStage kernels, over conv_mma.cuh; moved there
// unchanged so that the fused op's backward shares them): mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32 (SASS
// HMMA.16816.F32.BF16), fed by ldmatrix (.trans for the dW pass, whose
// operands are stored pixels by channels) from bf16 tiles in shared
// memory, 64 x 32 a warp. No bf16 launch reaches the CUDA-core tiles.
//   - The raw operands (g and y_k; y_{k-1}; w) are copied 16 bytes a
//     thread with cp.async into a ring of 2-3 stages (three where a
//     stage takes at most 40 KB), one or two chunks ahead of the one
//     being multiplied; a thread's copies are the same rows in every
//     chunk, their offsets computed once. Their prologues then run once
//     per staged element, in f32, op by op, with the thread's 8 channels'
//     constants in registers: dy from g and y_k, z = relu(y_{k-1} sc +
//     bb), rounded to bf16 where the plain version rounds, so the
//     tensor cores multiply the same operands and only the sums' order
//     differs. A padded tap or a pixel outside reads a zero row.
//   - dz: a block owns 128 output pixels (the 3x3: a TH x TW patch of the
//     images stacked into one tall image, conv_mma.cuh's patch_tiling)
//     and all of C up to 128 channels (2 x 2 or 2 x 4 warps). Per chunk
//     of K (16 channels for the 3x3, 32 for the 1x1) it converts dy for
//     the patch and its one-pixel halo once; the nine taps read shifted
//     windows of it, one ldmatrix row address a lane. dy is recomputed
//     only per 128-channel column tile (C > 128) and for the halo
//     (~1.4x).
//   - The tensor cores' f32 accumulation rounds toward zero: over the
//     3x3's 9 K products (4,608 at s5) its bias reached 1.4e-6 of the
//     sums' terms, beyond their 1e-6 limit. The dz pass promotes its
//     sums into a second set of f32 registers with round-to-nearest adds
//     every 4 to 9 steps of 16 (1.1e-7 after).
//   - dW: a block owns 64 channels of z (the 3x3: all nine taps, one warp
//     a tap over a shared halo tile of z) or 128 (C > 64), and 32 to 256
//     columns of dy (the 1x1 at C = 64: up to 256, so z is computed
//     once), over a split of 64-pixel chunks (the 3x3: 8 x 8-ish
//     patches).
//   - The dz epilogue goes through shared memory: each thread masks,
//     sums and stores 8 channels of a row as 16 bytes, its rows' y_{k-1}
//     loads in flight together, and a stride-2 1x1 writes the three
//     pixels the conv never read as 16-byte zeros.
//   - Widths that are not multiples of 8, or pointers not 16-byte
//     aligned, take element-wise copies and stores on the same path.
// What still holds it back (the measured times and bounds are in
// PERF.md): the issue and conversion work of every 16 bytes staged and
// two block barriers a chunk, which the tensor cores' share of a chunk
// does not cover (the two are even at the s2 3x3, the conversion twice
// the products at a 1x1); a block's chain of chunks, which the small-M
// shapes (s4, s5) cannot spread over enough blocks; mma.sync's rate
// below wgmma's; and the dz and dW passes each reading g and y_k.
// The f32 instantiations stay exact f32 (no TF32) on conv_gemm.cuh's
// CUDA-core tiles (128 x 64 output tiles, 16-deep steps, its tile_step
// the inner loop of both passes), dy and z recomputed as each tile is
// gathered; the whole-network f32 references hold the fused plan to them.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "conv_bwd_tc.cuh"
#include "conv_gemm.cuh"

#include <climits>
#include <type_traits>

namespace {

using dl4j_conv::block_partials;
using dl4j_conv::from_f32;
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

struct Stage {
  int n, h, w, c;    // y_{k-1}, dz [n, h, w, c]
  int ho, wo, k;     // y_k, g [n, ho, wo, k]
  int stride;        // the 1x1 conv's subsample (the 3x3: 1)
  int relu;          // the relu prologue (else the identity)
  int tiles;         // the sums' partials per channel (>= dz row blocks)
  int chunk;         // the dW pass: reduction rows (bf16: patches) a split
  int splits;        // the dW pass: splits of M
};

// aff_k's constants of channel kk: sc, inv, mu, m1, m2.
struct DyAffine {
  float sc, inv, mu, m1, m2;
};

__device__ __forceinline__ DyAffine dy_affine(const float* __restrict__ aff,
                                              int kk, int k) {
  return {aff[kk], aff[2 * k + kk], aff[3 * k + kk], aff[4 * k + kk],
          aff[5 * k + kk]};
}

// dy at element `off` of g / y_k, in f32, op by op as the TPU kernel
// (no fused multiply-add, so the plain version's PyTorch ops agree).
template <typename T>
__device__ __forceinline__ float dy_at(const T* __restrict__ g,
                                       const T* __restrict__ yk, int64_t off,
                                       const DyAffine& a) {
  const float gv = to_f32(g[off]);
  const float yhat = __fmul_rn(__fsub_rn(to_f32(yk[off]), a.mu), a.inv);
  return __fmul_rn(a.sc, __fsub_rn(__fsub_rn(gv, a.m1), __fmul_rn(yhat, a.m2)));
}

// =====================================================================
// f32: the CUDA-core kernels (conv_gemm.cuh's tiles)
// =====================================================================
// ---------------------------------------------------------------------
// the dz pass: dz[m, c] = sum_r A[m, r] B[r, c] over the conv's output
// pixels m; r = (tap, kk), A = dy at the pixel the tap reads (0 outside
// the image), B[r, c] = w[tap, c, kk]
// ---------------------------------------------------------------------
template <typename T, int TAPS>
__device__ __forceinline__ void dz_load(
    const T* __restrict__ yk, const T* __restrict__ g,
    const T* __restrict__ w, const float* __restrict__ aff_k,
    const Stage& s, int k0, int a_k, const int (&img)[kRowsPerThread],
    const int (&ah)[kRowsPerThread], const int (&aw)[kRowsPerThread],
    int b_k, int b_c, int n0, float (&ra)[kRowsPerThread],
    float (&rb)[kBPerThread]) {
  const int red = TAPS * s.k;
  int r = k0 + a_k;
  bool r_ok = r < red;
  int t = 0, kk = r, dh = 0, dw = 0;
  if (TAPS == 9 && r_ok) {
    t = r / s.k;
    kk = r - t * s.k;
    dh = 1 - t / 3;
    dw = 1 - t % 3;
  }
  DyAffine a{1.f, 1.f, 0.f, 0.f, 0.f};
  if (r_ok) a = dy_affine(aff_k, kk, s.k);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    float v = 0.f;
    const int ih = ah[j] + dh;
    const int iw = aw[j] + dw;
    if (r_ok && img[j] >= 0 && ih >= 0 && ih < s.ho && iw >= 0 && iw < s.wo) {
      const int64_t off =
          (static_cast<int64_t>(img[j]) + ih * s.wo + iw) * s.k + kk;
      v = round_to<T>(dy_at(g, yk, off, a));
    }
    ra[j] = v;
  }
  r = k0 + b_k;
  r_ok = r < red;
  t = 0;
  kk = r;
  if (TAPS == 9 && r_ok) {
    t = r / s.k;
    kk = r - t * s.k;
  }
#pragma unroll
  for (int j = 0; j < kBPerThread; ++j) {
    const int col = n0 + b_c + 16 * j;
    rb[j] = (r_ok && col < s.c)
                ? to_f32(w[(static_cast<int64_t>(t) * s.c + col) * s.k + kk])
                : 0.f;
  }
}

template <typename T, int TAPS>
__global__ void __launch_bounds__(kThreads)
    dz_kernel(const T* __restrict__ yk, const T* __restrict__ g,
              const T* __restrict__ yprev, const T* __restrict__ w,
              const float* __restrict__ aff_k,
              const float* __restrict__ aff_p, T* __restrict__ dz,
              float* __restrict__ part1, float* __restrict__ part2,
              Stage s) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw = s.ho * s.wo;
  const int rows = s.n * hw;
  const int red = TAPS * s.k;

  // A loads: reduction offset a_k of rows a_m + 16 j (the dy pixels)
  const int a_k = tid & 15;
  const int a_m = tid >> 4;
  int img[kRowsPerThread], ah[kRowsPerThread], aw[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int m = m0 + a_m + 16 * j;
    if (m < rows) {
      const int nn = m / hw;
      const int rem = m - nn * hw;
      ah[j] = rem / s.wo;
      aw[j] = rem - ah[j] * s.wo;
      img[j] = nn * hw;
    } else {
      img[j] = -1;
      ah[j] = 0;
      aw[j] = 0;
    }
  }
  // B loads: reduction offset b_k (consecutive threads read consecutive
  // kk of one weight row) of columns b_c + 16 j
  const int b_k = tid & 15;
  const int b_c = tid >> 4;

  float ra[kRowsPerThread], rb[kBPerThread];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  dz_load<T, TAPS>(yk, g, w, aff_k, s, 0, a_k, img, ah, aw, b_k, b_c, n0, ra,
                   rb);
  for (int k0 = 0; k0 < red; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      As[a_k * kAStride + a_m + 16 * j] = ra[j];
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) Bs[b_k * kBN + b_c + 16 * j] = rb[j];
    __syncthreads();
    if (k0 + kBK < red)
      dz_load<T, TAPS>(yk, g, w, aff_k, s, k0 + kBK, a_k, img, ah, aw, b_k,
                       b_c, n0, ra, rb);
    tile_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // epilogue: the relu' mask on the unrounded z0, the store (zeros where
  // a stride-2 conv never read), the sums of the f32 values
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
  float scp[4], bbp[4], invp[4], mup[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    const bool ok = s.relu && col < s.c;
    scp[j] = ok ? aff_p[col] : 1.f;
    bbp[j] = ok ? aff_p[s.c + col] : 0.f;
    invp[j] = ok ? aff_p[2 * s.c + col] : 1.f;
    mup[j] = ok ? aff_p[3 * s.c + col] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= rows) continue;
    const int nn = m / hw;
    const int rem = m - nn * hw;
    const int oh = rem / s.wo;
    const int ow = rem - oh * s.wo;
    const int64_t pix =
        (static_cast<int64_t>(nn) * s.h + oh * s.stride) * s.w + ow * s.stride;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= s.c) continue;
      const int64_t at = pix * s.c + col;
      float v = acc[i][j];
      if (s.relu) {
        const float yp = to_f32(yprev[at]);
        const float z0 = __fadd_rn(__fmul_rn(yp, scp[j]), bbp[j]);
        v = z0 > 0.f ? v : 0.f;
        const float yhat = __fmul_rn(__fsub_rn(yp, mup[j]), invp[j]);
        s1[j] += v;
        s2[j] += v * yhat;
      }
      dz[at] = from_f32<T>(v);
      if (s.stride == 2) {
        const T zero = from_f32<T>(0.f);
        const int64_t row = static_cast<int64_t>(s.w) * s.c;
        dz[at + s.c] = zero;
        dz[at + row] = zero;
        dz[at + row + s.c] = zero;
      }
    }
  }
  if (s.relu) block_partials(smem, s1, s2, n0, s.c, s.tiles, part1, part2);
}

// ---------------------------------------------------------------------
// the dW pass: dW[r, kk] = sum_m A[r, m] B[m, kk] over the conv's output
// pixels m of one split; r = (tap, c), A = z_{k-1} at the pixel the tap
// reads (0 outside the image), B = dy; partials [splits, R, K]
// ---------------------------------------------------------------------
template <typename T, int TAPS>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ yk, const T* __restrict__ g,
              const T* __restrict__ yprev, const float* __restrict__ aff_k,
              const float* __restrict__ aff_p, float* __restrict__ part,
              Stage s) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw = s.ho * s.wo;
  const int rows = s.n * hw;
  const int red_r = TAPS * s.c;
  const int mb = blockIdx.z * s.chunk;
  const int m_end = min(mb + s.chunk, rows);

  // A loads: one row r per thread (consecutive threads on consecutive
  // channels), reduction offsets a_k + 2 j
  const int a_r = tid & 127;
  const int a_k = tid >> 7;
  const int r = r0 + a_r;
  const bool r_ok = r < red_r;
  int ch = 0, dh = 0, dw = 0;
  if (r_ok) {
    const int t = r / s.c;
    ch = r - t * s.c;
    if (TAPS == 9) {
      dh = t / 3 - 1;
      dw = t % 3 - 1;
    }
  }
  const float scp = (r_ok && s.relu) ? aff_p[ch] : 1.f;
  const float bbp = (r_ok && s.relu) ? aff_p[s.c + ch] : 0.f;
  // B loads: column b_n (consecutive threads on consecutive kk),
  // reduction offsets b_k + 4 j
  const int b_n = tid & 63;
  const int b_k = tid >> 6;
  const int col = n0 + b_n;
  const bool col_ok = col < s.k;
  DyAffine a{1.f, 1.f, 0.f, 0.f, 0.f};
  if (col_ok) a = dy_affine(aff_k, col, s.k);

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
      if (r_ok && m < m_end) {
        const int nn = m / hw;
        const int rem = m - nn * hw;
        const int oh = rem / s.wo;
        const int ow = rem - oh * s.wo;
        const int ih = oh * s.stride + dh;
        const int iw = ow * s.stride + dw;
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) {
          z = to_f32(yprev[((static_cast<int64_t>(nn) * s.h + ih) * s.w + iw) *
                               s.c +
                           ch]);
          if (s.relu)
            z = dl4j_nan::relu_nan(__fadd_rn(__fmul_rn(z, scp), bbp));
          z = round_to<T>(z);
        }
      }
      ra[j] = z;
    }
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      const int m = mb + k0 + b_k + 4 * j;
      rb[j] = (col_ok && m < m_end)
                  ? round_to<T>(
                        dy_at(g, yk, static_cast<int64_t>(m) * s.k + col, a))
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

  float* out = part + static_cast<int64_t>(blockIdx.z) * red_r * s.k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = r0 + ty * 8 + i;
    if (rr >= red_r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < s.k) out[static_cast<int64_t>(rr) * s.k + cc] = acc[i][j];
    }
  }
}

// Launch one stage's four kernels on `stream`: the dz pass, the sums'
// fixed-order reduction (relu prologue only), the dW pass and its split
// reduction. Refuses (cudaErrorInvalidValue, before any launch) partials
// one row tile short, or splits that do not cover M in whole steps.
template <typename T, int TAPS>
int stage_bwd(const void* yk, const void* g, const void* yprev,
              const void* w, const void* aff_k, const void* aff_p, void* dz,
              void* dw, void* dw_part, void* part1, void* part2, void* s1,
              void* s2, const Stage& s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = s.n * s.ho * s.wo;
  const int blocks = (rows + kBM - 1) / kBM;
  if (blocks > s.tiles || s.chunk <= 0 || s.chunk % kBK ||
      static_cast<int64_t>(s.chunk) * s.splits < rows ||
      static_cast<int64_t>(s.chunk) * (s.splits - 1) >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || s.c == 0 || s.k == 0)
    return static_cast<int>(cudaGetLastError());
  const T* ykp = static_cast<const T*>(yk);
  const T* gp = static_cast<const T*>(g);
  const T* ypp = static_cast<const T*>(yprev);
  const float* akp = static_cast<const float*>(aff_k);
  const float* app = static_cast<const float*>(aff_p);
  dim3 grid(blocks, (s.c + kBN - 1) / kBN);
  dz_kernel<T, TAPS><<<grid, kThreads, 0, st>>>(
      ykp, gp, ypp, static_cast<const T*>(w), akp, app, static_cast<T*>(dz),
      static_cast<float*>(part1), static_cast<float*>(part2), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s.relu) {
    dl4j_conv::reduce_partials_kernel<<<s.c, dl4j_conv::kReduceThreads, 0,
                                        st>>>(
        static_cast<const float*>(part1), static_cast<const float*>(part2),
        blocks, s.tiles, static_cast<float*>(s1), static_cast<float*>(s2));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int red_r = TAPS * s.c;
  dim3 grid_w((red_r + kBM - 1) / kBM, (s.k + kBN - 1) / kBN, s.splits);
  dw_kernel<T, TAPS><<<grid_w, kThreads, 0, st>>>(
      ykp, gp, ypp, akp, app, static_cast<float*>(dw_part), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dl4j_conv::reduce_splits(dw_part, s.splits,
                                  static_cast<int64_t>(red_r) * s.k, dw, st);
}

// =====================================================================
// bf16: the tensor-core kernels (conv_bwd_tc.cuh, over conv_mma.cuh)
// =====================================================================
using dl4j_bwd::kDwPixels;
using dl4j_bwd::kDzPixels;
using dl4j_bwd::kStage;
using dl4j_bwd::launch_dw_for;
using dl4j_bwd::launch_dz;
using dl4j_bwd::TcStage;
using dl4j_mma::aligned16;
using dl4j_mma::Tiling;

// One bf16 stage on the tensor cores: the dz pass, the sums' fixed-order
// reduction (relu prologue only), the dW pass and its split reduction.
// `tiles` must cover the dz pass's patches and chunk x splits the dW
// pass's, and no tensor may hold 2^31 - 1 elements or more (the kernels
// index with ints): cudaErrorInvalidValue, before any launch, otherwise.
template <int TAPS>
int stage_bwd_tc(const void* yk, const void* g, const void* yprev,
                 const void* w, const void* aff_k, const void* aff_p,
                 void* dz, void* dw, void* dw_part, void* part1, void* part2,
                 void* s1, void* s2, const Stage& st, void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  // the kernels index elements with ints
  if (static_cast<int64_t>(st.n) * st.h * st.w * st.c >= INT_MAX ||
      static_cast<int64_t>(st.n) * st.ho * st.wo * st.k >= INT_MAX ||
      static_cast<int64_t>(TAPS) * st.c * st.k >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_m = st.n * st.ho * st.wo;
  const int vec = st.c % 8 == 0 && st.k % 8 == 0 && aligned16(yk) &&
                  aligned16(g) && aligned16(yprev) && aligned16(w) &&
                  aligned16(dz);
  TcStage s{st.n,     st.h,  st.w,   st.c,     st.ho, st.wo, st.k,
            st.stride, st.relu, vec, Tiling{0, 0, 0, 0}, st.tiles, st.chunk};
  TcStage sz = s, sw = s;
  if (TAPS == 9) {
    sz.tile = dl4j_mma::patch_tiling(st.n * st.ho, st.wo, kDzPixels);
    sw.tile = dl4j_mma::patch_tiling(st.n * st.ho, st.wo, kDwPixels);
  } else {
    sz.tile.patches = (rows_m + kDzPixels - 1) / kDzPixels;
    sw.tile.patches = (rows_m + kDwPixels - 1) / kDwPixels;
  }
  if (sz.tile.patches > st.tiles || st.chunk <= 0 || st.splits <= 0 ||
      static_cast<int64_t>(st.chunk) * st.splits < sw.tile.patches ||
      static_cast<int64_t>(st.chunk) * (st.splits - 1) >= sw.tile.patches)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_m == 0 || st.c == 0 || st.k == 0)
    return static_cast<int>(cudaGetLastError());
  int err = st.c <= 64
                ? launch_dz<TAPS, 2, kStage>(yk, g, yprev, w, aff_k, aff_p,
                                             dz, part1, part2, sz, cs)
                : launch_dz<TAPS, 4, kStage>(yk, g, yprev, w, aff_k, aff_p,
                                             dz, part1, part2, sz, cs);
  if (err) return err;
  if (st.relu) {
    dl4j_conv::reduce_partials_kernel<<<st.c, dl4j_conv::kReduceThreads, 0,
                                        cs>>>(
        static_cast<const float*>(part1), static_cast<const float*>(part2),
        sz.tile.patches, st.tiles, static_cast<float*>(s1),
        static_cast<float*>(s2));
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  err = launch_dw_for<TAPS, kStage>(yk, g, yprev, aff_k, aff_p, dw_part,
                                    st.splits, sw, cs);
  if (err) return err;
  return dl4j_conv::reduce_splits(dw_part, st.splits,
                                  static_cast<int64_t>(TAPS) * st.c * st.k,
                                  dw, cs);
}

// f32 on the CUDA cores, bf16 on the tensor cores.
template <typename T, int TAPS>
int stage_any(const void* yk, const void* g, const void* yprev,
              const void* w, const void* aff_k, const void* aff_p, void* dz,
              void* dw, void* dw_part, void* part1, void* part2, void* s1,
              void* s2, const Stage& s, void* stream) {
  if constexpr (std::is_same<T, float>::value)
    return stage_bwd<float, TAPS>(yk, g, yprev, w, aff_k, aff_p, dz, dw,
                                  dw_part, part1, part2, s1, s2, s, stream);
  else
    return stage_bwd_tc<TAPS>(yk, g, yprev, w, aff_k, aff_p, dz, dw, dw_part,
                              part1, part2, s1, s2, s, stream);
}

template <typename T>
int bwd1x1(const void* yk, const void* g, const void* yprev, const void* w,
           const void* aff_k, const void* aff_p, void* dz, void* dw,
           void* dw_part, void* part1, void* part2, void* s1, void* s2, int n,
           int h, int wd, int c, int k, int stride, int relu,
           int tiles, int chunk, int splits, void* stream) {
  if (stride != 1 && stride != 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Stage s{n,    h,        wd,    c,     h / stride, wd / stride, k,
          stride, relu, tiles, chunk, splits};
  return stage_any<T, 1>(yk, g, yprev, w, aff_k, aff_p, dz, dw, dw_part,
                         part1, part2, s1, s2, s, stream);
}

template <typename T>
int bwd3x3(const void* yk, const void* g, const void* yprev, const void* w,
           const void* aff_k, const void* aff_p, void* dz, void* dw,
           void* dw_part, void* part1, void* part2, void* s1, void* s2, int n,
           int h, int wd, int c, int k, int relu, int tiles,
           int chunk, int splits, void* stream) {
  Stage s{n, h, wd, c, h, wd, k, 1, relu, tiles, chunk, splits};
  return stage_any<T, 9>(yk, g, yprev, w, aff_k, aff_p, dz, dw, dw_part,
                         part1, part2, s1, s2, s, stream);
}

}  // namespace

extern "C" {

int dl4j_bwd1x1_f32(const void* yk, const void* g, const void* yprev,
                    const void* w, const void* aff_k, const void* aff_p,
                    void* dz, void* dw, void* dw_part, void* part1,
                    void* part2, void* s1, void* s2, int n, int h, int wd,
                    int c, int k, int stride, int relu,
                    int tiles, int chunk, int splits, void* stream) {
  return bwd1x1<float>(yk, g, yprev, w, aff_k, aff_p, dz, dw, dw_part, part1,
                       part2, s1, s2, n, h, wd, c, k, stride, relu,
                       tiles, chunk, splits, stream);
}

int dl4j_bwd1x1_bf16(const void* yk, const void* g, const void* yprev,
                     const void* w, const void* aff_k, const void* aff_p,
                     void* dz, void* dw, void* dw_part, void* part1,
                     void* part2, void* s1, void* s2, int n, int h, int wd,
                     int c, int k, int stride, int relu,
                     int tiles, int chunk, int splits, void* stream) {
  return bwd1x1<__nv_bfloat16>(yk, g, yprev, w, aff_k, aff_p, dz, dw,
                               dw_part, part1, part2, s1, s2, n, h, wd, c, k,
                               stride, relu, tiles, chunk, splits,
                               stream);
}

int dl4j_bwd3x3_f32(const void* yk, const void* g, const void* yprev,
                    const void* w, const void* aff_k, const void* aff_p,
                    void* dz, void* dw, void* dw_part, void* part1,
                    void* part2, void* s1, void* s2, int n, int h, int wd,
                    int c, int k, int relu, int tiles,
                    int chunk, int splits, void* stream) {
  return bwd3x3<float>(yk, g, yprev, w, aff_k, aff_p, dz, dw, dw_part, part1,
                       part2, s1, s2, n, h, wd, c, k, relu, tiles,
                       chunk, splits, stream);
}

int dl4j_bwd3x3_bf16(const void* yk, const void* g, const void* yprev,
                     const void* w, const void* aff_k, const void* aff_p,
                     void* dz, void* dw, void* dw_part, void* part1,
                     void* part2, void* s1, void* s2, int n, int h, int wd,
                     int c, int k, int relu, int tiles,
                     int chunk, int splits, void* stream) {
  return bwd3x3<__nv_bfloat16>(yk, g, yprev, w, aff_k, aff_p, dz, dw,
                               dw_part, part1, part2, s1, s2, n, h, wd, c, k,
                               relu, tiles, chunk, splits, stream);
}

int dl4j_bwd_row_tile() { return kBM; }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
