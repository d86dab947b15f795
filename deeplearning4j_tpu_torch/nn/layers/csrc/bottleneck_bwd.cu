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
// (conv_mma.cuh): mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32 (SASS
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

#include "conv_gemm.cuh"
#include "conv_mma.cuh"

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
          if (s.relu) z = fmaxf(__fadd_rn(__fmul_rn(z, scp), bbp), 0.f);
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
// bf16: the tensor-core kernels (conv_mma.cuh)
// =====================================================================
using dl4j_mma::aligned16;
using dl4j_mma::bf16;
using dl4j_mma::clamp8;
using dl4j_mma::copy8;
using dl4j_mma::cp_async_commit;
using dl4j_mma::cp_async_wait;
using dl4j_mma::dy8;
using dl4j_mma::dy_constants;
using dl4j_mma::elem;
using dl4j_mma::kFragM;
using dl4j_mma::kFragN;
using dl4j_mma::load8;
using dl4j_mma::pack8;
using dl4j_mma::patch_origin;
using dl4j_mma::set_smem;
using dl4j_mma::smem_addr;
using dl4j_mma::stages_for;
using dl4j_mma::store8;
using dl4j_mma::Tiling;
using dl4j_mma::warp_k16;
using dl4j_mma::z8;
using dl4j_mma::z_constants;

constexpr int kDzPixels = 128;   // the dz pass: output pixels per block
constexpr int kDwPixels = 64;    // the dW pass: pixels per reduction chunk

struct TcStage {
  int n, h, w, c;    // y_{k-1}, dz [n, h, w, c]
  int ho, wo, k;     // y_k, g [n, ho, wo, k]
  int stride, relu;
  int vec;           // 16-byte copies and stores (C, K multiples of 8,
                     // pointers 16-byte aligned)
  Tiling tile;       // this pass's patches (tw = 0: runs of pixels)
  int tiles;         // the dz pass: the sums' partials per channel
  int chunk;         // the dW pass: patches per split
};

// The y_{k-1} pixel (n, oh s, ow s) that output pixel m = (n, oh, ow)
// of a 1x1 reads.
__device__ __forceinline__ int prev_pixel(int m, const TcStage& s) {
  if (s.stride == 1) return m;
  const int hw = s.ho * s.wo;
  const int nn = m / hw;
  const int rem = m - nn * hw;
  const int oh = rem / s.wo;
  const int ow = rem - oh * s.wo;
  return (nn * s.h + oh * s.stride) * s.w + ow * s.stride;
}

// Local pixel q of the 3x3 patch at tall row r0, column col0: its
// output pixel, or -1 (past the patch's TH x TW, or outside the image).
__device__ __forceinline__ int patch_pixel(int q, int r0, int col0,
                                           const TcStage& s) {
  return dl4j_mma::patch_pixel(q, r0, col0, s.tile, s.n * s.ho, s.wo);
}

// Halo pixel r of the 3x3 patch at (r0, col0): its pixel, or -1 outside
// the tall image.
__device__ __forceinline__ int halo_pixel(int r, int r0, int col0,
                                          const TcStage& s) {
  return dl4j_mma::halo_pixel(r, r0, col0, s.tile, s.n * s.ho, s.wo);
}

// ---------------------------------------------------------------------
// the dz pass: dz[m, c] = sum over (tap, kk) of dy at the pixel the
// tap reads times w[tap, c, kk]. A block owns 128 output pixels (the
// 3x3: one TH x TW patch) and BN = 32 WN channels; 2 x WN warps of
// 64 x 32. Per chunk of KC channels kk: g and y_k for the patch and its
// halo, and w for all taps, copied with cp.async S - 1 chunks ahead
// (a ring of S stages); dy computed once from the copy into the operand
// tile (the nine taps read shifted windows of it); the products on the
// tensor cores.
// ---------------------------------------------------------------------
// The dz pass's ring: a stage holds the chunk's g and y_k (the 3x3:
// the halo's, at most 264 pixels) and w for all taps.
template <int TAPS, int WN>
__host__ __device__ constexpr int dz_stages() {
  return stages_for(
      ((TAPS == 9 ? 2 * 264 * 16 : 2 * kDzPixels * 32) +
       TAPS * 32 * WN * ((TAPS == 9 ? 16 : 32) + 8)) * sizeof(bf16));
}

template <int TAPS, int WN>
__global__ void __launch_bounds__(64 * WN)
    dz_tc_kernel(const bf16* __restrict__ yk, const bf16* __restrict__ g,
                 const bf16* __restrict__ yprev, const bf16* __restrict__ w,
                 const float* __restrict__ aff_k,
                 const float* __restrict__ aff_p, bf16* __restrict__ dz,
                 float* __restrict__ part1, float* __restrict__ part2,
                 TcStage s) {
  constexpr int NT = 64 * WN;
  constexpr int BN = 32 * WN;
  constexpr bool kHalo = TAPS == 9;
  constexpr int KC = kHalo ? 16 : 32;   // reduction channels per chunk
  constexpr int G = KC / 8;
  constexpr int AS = KC + 8;            // dy and w tiles' row stride
  constexpr int S = dz_stages<TAPS, WN>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  const int p = blockIdx.x;
  const int c0 = blockIdx.y * BN;
  const Tiling& t = s.tile;
  const int rows_m = s.n * s.ho * s.wo;
  const int rows_a = kHalo ? (t.th + 2) * (t.tw + 2) : kDzPixels;
  const bool vec = s.vec != 0;
  bf16* zero = reinterpret_cast<bf16*>(smem);   // one row of zeros
  bf16* As = zero + AS;                         // [rows_a][AS] dy
  bf16* Bs = As + rows_a * AS;                  // [S][TAPS BN][AS] w
  bf16* Rg = Bs + S * TAPS * BN * AS;           // [S][rows_a][KC] g
  bf16* Ry = Rg + S * rows_a * KC;              // [S][rows_a][KC] y_k

  int r0 = 0, col0 = 0;
  if (kHalo) patch_origin(p, t, r0, col0);
  auto a_pixel = [&](int r) {
    if (kHalo) return halo_pixel(r, r0, col0, s);
    return p * kDzPixels + r < rows_m ? p * kDzPixels + r : -1;
  };
  const int chunks = (s.k + KC - 1) / KC;
  // This thread's items of the copies (item it = tid + j NT: row it / G,
  // the same column group v in every chunk): where each row starts in g
  // and y_k (a_off, -1 outside, -2 past the tile) and in w (w_off), the
  // same for every chunk, so a chunk's copies cost an add and a compare
  // an item. Element offsets fit an int (the launcher checks).
  static_assert(NT % G == 0, "a thread's column group is fixed");
  constexpr int A_ITEMS = ((kHalo ? 264 : kDzPixels) * G + NT - 1) / NT;
  constexpr int W_ITEMS = TAPS * BN * G / NT;
  static_assert(W_ITEMS * NT == TAPS * BN * G, "w items tile the threads");
  const int v = tid % G;
  int a_off[A_ITEMS], w_off[W_ITEMS];
#pragma unroll
  for (int j = 0; j < A_ITEMS; ++j) {
    const int it = tid + j * NT;
    const int px = it < rows_a * G ? a_pixel(it / G) : -1;
    a_off[j] = it < rows_a * G ? (px < 0 ? -1 : px * s.k) : -2;
  }
#pragma unroll
  for (int j = 0; j < W_ITEMS; ++j) {
    const int r = (tid + j * NT) / G;
    const int tap = r / BN;
    const int cc = c0 + r - tap * BN;
    w_off[j] = cc < s.c ? (tap * s.c + cc) * s.k : -1;
  }
  auto issue = [&](int kc) {   // one copy group, empty past the last
    const int buf = kc % S;
    const int ch = kc * KC + 8 * v;
    const int ch_valid = clamp8(s.k - ch);
    if (kc < chunks) {
#pragma unroll
      for (int j = 0; j < A_ITEMS; ++j) {
        if (a_off[j] == -2) continue;
        const int at = buf * rows_a * KC + (tid + j * NT) * 8;
        const int valid = a_off[j] < 0 ? 0 : ch_valid;
        copy8(Rg + at, g, a_off[j] + ch, valid, vec);
        copy8(Ry + at, yk, a_off[j] + ch, valid, vec);
      }
#pragma unroll
      for (int j = 0; j < W_ITEMS; ++j) {
        const int r = (tid + j * NT) / G;
        copy8(Bs + (buf * TAPS * BN + r) * AS + 8 * v, w, w_off[j] + ch,
              w_off[j] < 0 ? 0 : ch_valid, vec);
      }
    }
    cp_async_commit();
  };
  for (int kc = 0; kc < S - 1; ++kc) issue(kc);
  for (int i = tid; i < AS; i += NT) zero[i] = __float2bfloat16_rn(0.f);

  // This lane's A rows: fragment f reads output pixel q = 64 wm + 16 f +
  // (lane & 15). For the 3x3, its halo index and the taps that read
  // inside its image: tap (kh, kw) reads dy at (oh + 1 - kh, ow + 1 - kw);
  // a tap outside, or a pixel outside, reads the zero row.
  int hb[kFragM];
  unsigned taps_ok[kFragM];
#pragma unroll
  for (int f = 0; f < kFragM; ++f) {
    const int q = 64 * wm + 16 * f + (lane & 15);
    hb[f] = q;
    taps_ok[f] = 1u;
    if (kHalo) {
      const int i = q / t.tw;
      const int j = q - i * t.tw;
      hb[f] = (i + 1) * (t.tw + 2) + (j + 1);
      unsigned ok = 0u;
      if (patch_pixel(q, r0, col0, s) >= 0) {
        const int oh = (r0 + i) % s.ho;
        const int ow = col0 + j;
        for (int tap = 0; tap < 9; ++tap) {
          const int sh = oh + 1 - tap / 3;
          const int sw = ow + 1 - tap % 3;
          if (sh >= 0 && sh < s.ho && sw >= 0 && sw < s.wo) ok |= 1u << tap;
        }
      }
      taps_ok[f] = ok;
    }
  }

  // acc: the block's sums, promoted every kPromote chunks (4 to 9 steps
  // of 16) with f32 adds (round to nearest); part: the tensor cores'
  // sums since, whose accumulation rounds toward zero, so that over
  // 9 K products (4,608 at s5) its bias would reach the sums of dz
  // (1.4e-6 of their terms' magnitude)
  constexpr int kPromote = kHalo ? 1 : 2;
  float acc[kFragM][kFragN][4], part[kFragM][kFragN][4];
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][n][e] = part[f][n][e] = 0.f;

  for (int kc = 0; kc < chunks; ++kc) {
    const int buf = kc % S;
    float cst[5][8];
    dy_constants(aff_k, s.k, kc * KC + 8 * v, cst);
    cp_async_wait<S - 2>();
    __syncthreads();   // chunk kc copied; the last products done
    issue(kc + S - 1);
    // dy of chunk kc, once per staged element
    const bf16* rg = Rg + buf * rows_a * KC;
    const bf16* ry = Ry + buf * rows_a * KC;
    const int cvalid = clamp8(s.k - (kc * KC + 8 * v));
#pragma unroll
    for (int j = 0; j < A_ITEMS; ++j) {
      if (a_off[j] == -2) continue;
      const int it = tid + j * NT;
      *reinterpret_cast<uint4*>(As + (it / G) * AS + 8 * v) =
          dy8(*reinterpret_cast<const uint4*>(rg + it * 8),
              *reinterpret_cast<const uint4*>(ry + it * 8), cst,
              a_off[j] < 0 ? 0 : cvalid);
    }
    __syncthreads();
    const bf16* bs = Bs + buf * TAPS * BN * AS;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int toff =
          kHalo ? (1 - tap / 3) * (t.tw + 2) + (1 - tap % 3) : 0;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t a[kFragM], b[kFragN / 2];
        const int col = ks * 16 + dl4j_mma::a_k(lane);
#pragma unroll
        for (int f = 0; f < kFragM; ++f)
          a[f] = ((taps_ok[f] >> tap) & 1u)
                     ? smem_addr(As + (hb[f] + toff) * AS + col)
                     : smem_addr(zero + col);
#pragma unroll
        for (int h2 = 0; h2 < kFragN / 2; ++h2)
          b[h2] = smem_addr(
              bs + (tap * BN + wn * 32 + 16 * h2 + dl4j_mma::b_n(lane)) * AS +
              ks * 16 + dl4j_mma::b_k(lane));
        warp_k16<false, false>(part, a, b);
      }
    }
    if ((kc + 1) % kPromote == 0 || kc + 1 == chunks) {
#pragma unroll
      for (int f = 0; f < kFragM; ++f)
#pragma unroll
        for (int n = 0; n < kFragN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[f][n][e] += part[f][n][e];
            part[f][n][e] = 0.f;
          }
    }
  }
  __syncthreads();   // every product is done: the tiles' memory is free

  // epilogue: the f32 tile through shared memory, then per thread 8
  // channels of a row: the relu' mask on the unrounded z0, the sums of
  // the f32 values, dz stored as 16 bytes (a stride-2 1x1 also stores
  // the zeros of the three pixels the conv never read)
  constexpr int ES = BN + 4;
  float* Es = reinterpret_cast<float*>(smem);   // [128][ES]
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n) {
      const int row = 64 * wm + 16 * f + (lane >> 2);
      const int col = wn * 32 + 8 * n + (lane & 3) * 2;
      *reinterpret_cast<float2*>(Es + row * ES + col) =
          make_float2(acc[f][n][0], acc[f][n][1]);
      *reinterpret_cast<float2*>(Es + (row + 8) * ES + col) =
          make_float2(acc[f][n][2], acc[f][n][3]);
    }
  __syncthreads();
  constexpr int CG = BN / 8;       // column groups of 8
  constexpr int RSTEP = NT / CG;   // rows a pass
  const int u = tid % CG;
  const int cb = c0 + 8 * u;
  const int nvalid = clamp8(s.c - cb);
  float scp[8], bbp[8], invp[8], mup[8];
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const bool ok = s.relu && e < nvalid;
    scp[e] = ok ? __ldg(aff_p + cb + e) : 1.f;
    bbp[e] = ok ? __ldg(aff_p + s.c + cb + e) : 0.f;
    invp[e] = ok ? __ldg(aff_p + 2 * s.c + cb + e) : 1.f;
    mup[e] = ok ? __ldg(aff_p + 3 * s.c + cb + e) : 0.f;
    s1[e] = 0.f;
    s2[e] = 0.f;
  }
  const int64_t wrow = static_cast<int64_t>(s.w) * s.c;
  // this thread's rows, their y_{k-1} loads all in flight at once
  constexpr int ROWS = kDzPixels / RSTEP;
  int64_t at[ROWS];
  uint4 yrs[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int r = tid / CG + j * RSTEP;
    int m = -1;
    if (kHalo) {
      m = patch_pixel(r, r0, col0, s);
    } else if (p * kDzPixels + r < rows_m) {
      m = p * kDzPixels + r;
    }
    at[j] = (m < 0 || nvalid == 0)
                ? -1
                : static_cast<int64_t>(prev_pixel(m, s)) * s.c + cb;
    yrs[j] = (s.relu && at[j] >= 0) ? load8(yprev, at[j], nvalid, vec)
                                    : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (at[j] < 0) continue;
    const int r = tid / CG + j * RSTEP;
    float val[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) val[e] = Es[r * ES + 8 * u + e];
    if (s.relu) {
      const uint4 yr = yrs[j];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < nvalid) {
          const float yp = elem(yr, e);
          const float z0 = __fadd_rn(__fmul_rn(yp, scp[e]), bbp[e]);
          val[e] = z0 > 0.f ? val[e] : 0.f;
          const float yhat = __fmul_rn(__fsub_rn(yp, mup[e]), invp[e]);
          s1[e] += val[e];
          s2[e] += val[e] * yhat;
        }
      }
    }
    store8(dz, at[j], nvalid, vec, pack8(val));
    if (s.stride == 2) {
      const uint4 zz = make_uint4(0u, 0u, 0u, 0u);
      store8(dz, at[j] + s.c, nvalid, vec, zz);
      store8(dz, at[j] + wrow, nvalid, vec, zz);
      store8(dz, at[j] + wrow + s.c, nvalid, vec, zz);
    }
  }
  if (!s.relu) return;
  // the block's partial sums: the RSTEP row groups in order
  __syncthreads();
  float* red1 = Es;                 // [RSTEP][BN]
  float* red2 = Es + RSTEP * BN;    // [RSTEP][BN]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red1[(tid / CG) * BN + 8 * u + e] = s1[e];
    red2[(tid / CG) * BN + 8 * u + e] = s2[e];
  }
  __syncthreads();
  if (tid < BN && c0 + tid < s.c) {
    float a = 0.f, b = 0.f;
    for (int rg = 0; rg < RSTEP; ++rg) {
      a += red1[rg * BN + tid];
      b += red2[rg * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(c0 + tid) * s.tiles + blockIdx.x;
    part1[at] = a;
    part2[at] = b;
  }
}

// Bytes of shared memory the dz pass takes.
template <int TAPS, int WN>
size_t dz_smem(const TcStage& s) {
  constexpr int BN = 32 * WN;
  constexpr int KC = TAPS == 9 ? 16 : 32;
  constexpr int AS = KC + 8;
  constexpr int S = dz_stages<TAPS, WN>();
  const int rows_a =
      TAPS == 9 ? (s.tile.th + 2) * (s.tile.tw + 2) : kDzPixels;
  const size_t tiles =
      (static_cast<size_t>(AS) * (1 + rows_a + S * TAPS * BN) +
       2 * S * static_cast<size_t>(rows_a) * KC) * sizeof(bf16);
  const size_t epilogue =
      static_cast<size_t>(kDzPixels) * (BN + 4) * sizeof(float);
  return tiles > epilogue ? tiles : epilogue;
}

// ---------------------------------------------------------------------
// the dW pass: dW[tap, c, kk] = sum over the pixels m of one split of
// z at the pixel the tap reads times dy[m, kk], into f32 partials
// [splits, TAPS C, K]. A block owns BR channels (all nine taps for the
// 3x3: one warp a tap) and BN = 32 WN columns; per chunk of 64 pixels
// (the 3x3: one TH x TW patch): y_{k-1} for the patch (and its halo),
// g and y_k for the patch, copied with cp.async S - 1 chunks ahead; z
// and dy computed once from the copies into the operand tiles (the nine
// warps read shifted windows of z); A = z read transposed
// (ldmatrix.trans), B = dy transposed.
// ---------------------------------------------------------------------
// The dW pass's ring: a stage holds y_{k-1} for the chunk (the 3x3: its
// halo, at most 198 pixels) and g and y_k.
template <int TAPS, int WM, int WN>
__host__ __device__ constexpr int dw_stages() {
  return stages_for(((TAPS == 9 ? 198 : kDwPixels) *
                         (TAPS == 9 ? 64 : 64 * WM) +
                     2 * kDwPixels * 32 * WN) *
                    sizeof(bf16));
}

template <int TAPS, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
    dw_tc_kernel(const bf16* __restrict__ yk, const bf16* __restrict__ g,
                 const bf16* __restrict__ yprev,
                 const float* __restrict__ aff_k,
                 const float* __restrict__ aff_p, float* __restrict__ part,
                 TcStage s) {
  constexpr int NT = 32 * WM * WN;
  constexpr bool kHalo = TAPS == 9;
  constexpr int BR = kHalo ? 64 : 64 * WM;   // channels of z
  constexpr int BN = 32 * WN;                // columns kk
  constexpr int ZS = BR + 8;
  constexpr int DS = BN + 8;
  constexpr int S = dw_stages<TAPS, WM, WN>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  const int tap = kHalo ? wm : 0;
  const int wc = kHalo ? 0 : 64 * wm;   // the warp's first channel
  const int kh = tap / 3;
  const int kw = tap - kh * 3;
  const int c0 = blockIdx.x * BR;
  const int n0 = blockIdx.y * BN;
  const Tiling& t = s.tile;
  const int rows_m = s.n * s.ho * s.wo;
  const int rows_z = kHalo ? (t.th + 2) * (t.tw + 2) : kDwPixels;
  const bool vec = s.vec != 0;
  bf16* zero = reinterpret_cast<bf16*>(smem);   // one row of zeros
  bf16* Zs = zero + ZS;                         // [rows_z][ZS] z
  bf16* Ds = Zs + rows_z * ZS;                  // [64][DS] dy
  bf16* Rz = Ds + kDwPixels * DS;               // [S][rows_z][BR] y_{k-1}
  bf16* Rg = Rz + S * rows_z * BR;              // [S][64][BN] g
  bf16* Ry = Rg + S * kDwPixels * BN;           // [S][64][BN] y_k
  // the 3x3's totals (below), [warps][16 fragments][32 lanes][4] f32,
  // each thread its own
  float4* tots = reinterpret_cast<float4*>(Ry + S * kDwPixels * BN) +
                 warp * 16 * 32 + lane;

  const int split = static_cast<int>(blockIdx.z);
  const int p_begin = split * s.chunk;
  const int p_end = min(p_begin + s.chunk, t.patches);
  // This thread's items of the copies and conversions (item it = tid + j
  // NT: row it / ZG of z, it / DG of dy, in the same column groups vz and
  // vd in every chunk) by their place in the chunk, which no chunk
  // changes: the halo row and column (3x3) or the pixel, -1 past the
  // tile (-2: a dy row past the patch's TH x TW). A chunk's pixel of an
  // item is then a few adds and compares.
  constexpr int ZG = BR / 8;
  constexpr int DG = BN / 8;
  static_assert(NT % ZG == 0 && NT % DG == 0,
                "a thread's column groups are fixed");
  constexpr int Z_ITEMS = ((kHalo ? 198 : kDwPixels) * ZG + NT - 1) / NT;
  constexpr int D_ITEMS = (kDwPixels * DG + NT - 1) / NT;
  const int vz = tid % ZG;
  const int vd = tid % DG;
  int zloc[Z_ITEMS], dloc[D_ITEMS];
#pragma unroll
  for (int j = 0; j < Z_ITEMS; ++j) {
    const int it = tid + j * NT;
    const int r = it / ZG;
    const int hi = kHalo ? r / (t.tw + 2) : 0;
    zloc[j] = it >= rows_z * ZG ? -1
              : kHalo           ? (hi << 16) | (r - hi * (t.tw + 2))
                                : r;
  }
#pragma unroll
  for (int j = 0; j < D_ITEMS; ++j) {
    const int it = tid + j * NT;
    const int q = it / DG;
    const int i = kHalo ? q / t.tw : 0;
    dloc[j] = it >= kDwPixels * DG ? -1
              : !kHalo             ? q
              : i < t.th           ? (i << 16) | (q - i * t.tw)
                                   : -2;
  }
  // the pixel of chunk p (3x3: the patch at r0, col0) that item j reads
  auto z_pixel = [&](int p, int r0, int col0, int j) {
    if (kHalo) {
      const int row = r0 - 1 + (zloc[j] >> 16);
      const int col = col0 - 1 + (zloc[j] & 0xffff);
      return (row >= 0 && row < s.n * s.ho && col >= 0 && col < s.wo)
                 ? row * s.wo + col
                 : -1;
    }
    const int m = p * kDwPixels + zloc[j];
    return m < rows_m ? prev_pixel(m, s) : -1;
  };
  auto d_pixel = [&](int p, int r0, int col0, int j) {
    if (dloc[j] < 0) return -1;
    if (kHalo) {
      const int row = r0 + (dloc[j] >> 16);
      const int col = col0 + (dloc[j] & 0xffff);
      return (row < s.n * s.ho && col < s.wo) ? row * s.wo + col : -1;
    }
    const int m = p * kDwPixels + dloc[j];
    return m < rows_m ? m : -1;
  };
  const int zch = c0 + 8 * vz;
  const int dch = n0 + 8 * vd;
  const int zvalid = clamp8(s.c - zch);   // channels in C / K
  const int dvalid = clamp8(s.k - dch);
  auto issue = [&](int p) {   // one copy group, empty past the last
    const int buf = (p - p_begin) % S;
    int r0 = 0, col0 = 0;
    if (kHalo && p < p_end) patch_origin(p, t, r0, col0);
    if (p < p_end) {
#pragma unroll
      for (int j = 0; j < Z_ITEMS; ++j) {
        if (zloc[j] == -1) continue;
        const int px = z_pixel(p, r0, col0, j);
        copy8(Rz + buf * rows_z * BR + (tid + j * NT) * 8, yprev,
              px * s.c + zch, px < 0 ? 0 : zvalid, vec);
      }
#pragma unroll
      for (int j = 0; j < D_ITEMS; ++j) {
        if (dloc[j] == -1) continue;
        const int px = d_pixel(p, r0, col0, j);
        const int at = buf * kDwPixels * BN + (tid + j * NT) * 8;
        copy8(Rg + at, g, px * s.k + dch, px < 0 ? 0 : dvalid, vec);
        copy8(Ry + at, yk, px * s.k + dch, px < 0 ? 0 : dvalid, vec);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) issue(p_begin + i);
  for (int i = tid; i < ZS; i += NT) zero[i] = __float2bfloat16_rn(0.f);
  // this thread's constants: z's 8 channels vz and dy's vd (the 3x3's
  // spill a few registers for them, still faster on the H100 than a
  // reload from L1 a chunk)
  float cz[2][8], cd[5][8];
  z_constants(aff_p, s.relu ? s.c : 0, zch, cz);
  dy_constants(aff_k, s.k, dch, cd);
  // this lane's pixel of each 16-pixel step (the A rows it addresses):
  // its patch row i, column j, row within its image less the patch's
  // (i mod Ho), and the halo row its tap reads
  int qi[kDwPixels / 16], qj[kDwPixels / 16], qim[kDwPixels / 16],
      zrow[kDwPixels / 16];
#pragma unroll
  for (int ks = 0; ks < kDwPixels / 16; ++ks) {
    const int q = 16 * ks + dl4j_mma::a_trans_k(lane);
    qi[ks] = kHalo ? q / t.tw : 0;
    qj[ks] = kHalo ? q - qi[ks] * t.tw : 0;
    qim[ks] = kHalo ? qi[ks] % s.ho : 0;
    zrow[ks] = kHalo ? (qi[ks] + kh) * (t.tw + 2) + (qj[ks] + kw) : q;
  }

  // acc: the tensor cores' sums since the last promotion, whose
  // accumulation rounds toward zero (over a split's ~3,000 pixels its
  // bias reached ~4e-6 of dW); tot: the totals, promoted into every
  // kPromote chunks (8 or 16 steps of 16) with f32 adds (round to
  // nearest), in registers for the 1x1 and in shared memory for the 3x3,
  // whose nine warps have no registers to spare
  constexpr int kPromote = kHalo ? 4 : 2;
  float acc[kFragM][kFragN][4], tot[kFragM][kFragN][4];
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[f][n][e] = 0.f;
        tot[f][n][e] = 0.f;
        if (kHalo)
          tots[(f * kFragN + n) * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
  auto promote = [&]() {
#pragma unroll
    for (int f = 0; f < kFragM; ++f)
#pragma unroll
      for (int n = 0; n < kFragN; ++n) {
        if (kHalo) {
          float4 t4 = tots[(f * kFragN + n) * 32];
          t4.x += acc[f][n][0];
          t4.y += acc[f][n][1];
          t4.z += acc[f][n][2];
          t4.w += acc[f][n][3];
          tots[(f * kFragN + n) * 32] = t4;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[f][n][e] += acc[f][n][e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][n][e] = 0.f;
      }
  };

  for (int p = p_begin; p < p_end; ++p) {
    const int buf = (p - p_begin) % S;
    cp_async_wait<S - 2>();
    __syncthreads();   // chunk p copied; the last products done
    issue(p + S - 1);
    int r0 = 0, col0 = 0, r0m = 0;
    if (kHalo) {
      patch_origin(p, t, r0, col0);
      r0m = r0 % s.ho;
    }
    const bf16* rz = Rz + buf * rows_z * BR;
#pragma unroll
    for (int j = 0; j < Z_ITEMS; ++j) {
      if (zloc[j] == -1) continue;
      const int it = tid + j * NT;
      *reinterpret_cast<uint4*>(Zs + (it / ZG) * ZS + 8 * vz) =
          z8(*reinterpret_cast<const uint4*>(rz + it * 8), cz,
             z_pixel(p, r0, col0, j) < 0 ? 0 : zvalid, s.relu);
    }
    const bf16* rg = Rg + buf * kDwPixels * BN;
    const bf16* ry = Ry + buf * kDwPixels * BN;
#pragma unroll
    for (int j = 0; j < D_ITEMS; ++j) {
      if (dloc[j] == -1) continue;
      const int it = tid + j * NT;
      *reinterpret_cast<uint4*>(Ds + (it / DG) * DS + 8 * vd) =
          dy8(*reinterpret_cast<const uint4*>(rg + it * 8),
              *reinterpret_cast<const uint4*>(ry + it * 8), cd,
              d_pixel(p, r0, col0, j) < 0 ? 0 : dvalid);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDwPixels / 16; ++ks) {
      // z at the pixel this lane's tap reads ((oh + kh - 1, ow + kw -
      // 1)), or the zero row outside the image or past the patch
      bool ok = true;
      if (kHalo) {
        int oh = r0m + qim[ks];
        if (oh >= s.ho) oh -= s.ho;
        const int ow = col0 + qj[ks];
        const int sh = oh + kh - 1;
        const int sw = ow + kw - 1;
        ok = qi[ks] < t.th && r0 + qi[ks] < s.n * s.ho && ow < s.wo &&
             sh >= 0 && sh < s.ho && sw >= 0 && sw < s.wo;
      }
      uint32_t a[kFragM], b[kFragN / 2];
#pragma unroll
      for (int f = 0; f < kFragM; ++f) {
        const int col = wc + 16 * f + dl4j_mma::a_trans_r(lane);
        a[f] = ok ? smem_addr(Zs + zrow[ks] * ZS + col)
                  : smem_addr(zero + col);
      }
#pragma unroll
      for (int h2 = 0; h2 < kFragN / 2; ++h2)
        b[h2] = smem_addr(Ds + (16 * ks + dl4j_mma::b_trans_k(lane)) * DS +
                          wn * 32 + 16 * h2 + dl4j_mma::b_trans_n(lane));
      warp_k16<true, true>(acc, a, b);
    }
    if ((p - p_begin + 1) % kPromote == 0) promote();
  }
  promote();
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
      if (kHalo) {
        const float4 t4 = tots[(f * kFragN + n) * 32];
        tot[f][n][0] = t4.x;
        tot[f][n][1] = t4.y;
        tot[f][n][2] = t4.z;
        tot[f][n][3] = t4.w;
      }

  float* out = part + static_cast<int64_t>(split) * TAPS * s.c * s.k;
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + wc + 16 * f + (lane >> 2) + 8 * half;
        const int kk = n0 + wn * 32 + 8 * n + (lane & 3) * 2;
        if (c >= s.c) continue;
        float* row = out + static_cast<int64_t>(tap * s.c + c) * s.k;
        if (kk < s.k) row[kk] = tot[f][n][2 * half];
        if (kk + 1 < s.k) row[kk + 1] = tot[f][n][2 * half + 1];
      }
}

// Bytes of shared memory the dW pass takes.
template <int TAPS, int WM, int WN>
size_t dw_smem(const TcStage& s) {
  constexpr int BR = TAPS == 9 ? 64 : 64 * WM;
  constexpr int BN = 32 * WN;
  constexpr int S = dw_stages<TAPS, WM, WN>();
  const int rows_z =
      TAPS == 9 ? (s.tile.th + 2) * (s.tile.tw + 2) : kDwPixels;
  return (static_cast<size_t>(BR + 8) * (1 + rows_z) +
          static_cast<size_t>(kDwPixels) * (BN + 8) +
          S * static_cast<size_t>(rows_z) * BR +
          2 * S * static_cast<size_t>(kDwPixels) * BN) * sizeof(bf16) +
         (TAPS == 9 ? static_cast<size_t>(WM * WN) * 64 * 32 * sizeof(float)
                    : 0);
}

template <int TAPS, int WN>
int launch_dz(const void* yk, const void* g, const void* yprev,
              const void* w, const void* aff_k, const void* aff_p, void* dz,
              void* part1, void* part2, const TcStage& s, cudaStream_t st) {
  constexpr int BN = 32 * WN;
  const size_t bytes = dz_smem<TAPS, WN>(s);
  auto kernel = dz_tc_kernel<TAPS, WN>;
  static size_t granted = 0;
  int err = set_smem(kernel, bytes, granted);
  if (err) return err;
  dim3 grid(s.tile.patches, (s.c + BN - 1) / BN);
  kernel<<<grid, 64 * WN, bytes, st>>>(
      static_cast<const bf16*>(yk), static_cast<const bf16*>(g),
      static_cast<const bf16*>(yprev), static_cast<const bf16*>(w),
      static_cast<const float*>(aff_k), static_cast<const float*>(aff_p),
      static_cast<bf16*>(dz), static_cast<float*>(part1),
      static_cast<float*>(part2), s);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS, int WM, int WN>
int launch_dw(const void* yk, const void* g, const void* yprev,
              const void* aff_k, const void* aff_p, void* dw_part,
              int splits, const TcStage& s, cudaStream_t st) {
  constexpr int BR = TAPS == 9 ? 64 : 64 * WM;
  constexpr int BN = 32 * WN;
  const size_t bytes = dw_smem<TAPS, WM, WN>(s);
  auto kernel = dw_tc_kernel<TAPS, WM, WN>;
  static size_t granted = 0;
  int err = set_smem(kernel, bytes, granted);
  if (err) return err;
  dim3 grid((s.c + BR - 1) / BR, (s.k + BN - 1) / BN, splits);
  kernel<<<grid, 32 * WM * WN, bytes, st>>>(
      static_cast<const bf16*>(yk), static_cast<const bf16*>(g),
      static_cast<const bf16*>(yprev), static_cast<const float*>(aff_k),
      static_cast<const float*>(aff_p), static_cast<float*>(dw_part), s);
  return static_cast<int>(cudaGetLastError());
}

// The dW pass's block shape: the 3x3 one warp a tap over 64 channels
// and 32 columns; the 1x1 64 channels (C <= 64) or 128, and up to 256
// columns (bottleneck.py's _bwd_tc_plan mirrors it).
template <int TAPS>
int launch_dw_for(const void* yk, const void* g, const void* yprev,
                  const void* aff_k, const void* aff_p, void* dw_part,
                  int splits, const TcStage& s, cudaStream_t st) {
  if constexpr (TAPS == 9) {
    return launch_dw<9, 9, 1>(yk, g, yprev, aff_k, aff_p, dw_part, splits, s,
                              st);
  } else {
    if (s.c <= 64) {
      if (s.k <= 64)
        return launch_dw<1, 1, 2>(yk, g, yprev, aff_k, aff_p, dw_part,
                                  splits, s, st);
      if (s.k <= 128)
        return launch_dw<1, 1, 4>(yk, g, yprev, aff_k, aff_p, dw_part,
                                  splits, s, st);
      return launch_dw<1, 1, 8>(yk, g, yprev, aff_k, aff_p, dw_part, splits,
                                s, st);
    }
    if (s.k <= 64)
      return launch_dw<1, 2, 2>(yk, g, yprev, aff_k, aff_p, dw_part, splits,
                                s, st);
    return launch_dw<1, 2, 4>(yk, g, yprev, aff_k, aff_p, dw_part, splits, s,
                              st);
  }
}

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
  int err = st.c <= 64 ? launch_dz<TAPS, 2>(yk, g, yprev, w, aff_k, aff_p,
                                            dz, part1, part2, sz, cs)
                       : launch_dz<TAPS, 4>(yk, g, yprev, w, aff_k, aff_p,
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
  err = launch_dw_for<TAPS>(yk, g, yprev, aff_k, aff_p, dw_part, st.splits,
                            sw, cs);
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
