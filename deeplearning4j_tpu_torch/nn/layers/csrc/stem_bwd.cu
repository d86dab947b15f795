// The fused ResNet stem's backward, for Hopper (sm_90a): the pool and
// relu backward with the BN-backward sums, the BN backward with the
// weight gradient of the space-to-depth conv, and the input gradient.
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/stem.py:
//   bwd_pool <- `_stem_bwd_pool_kernel` (pallas_call in `_bwd_pool`)
//   bwd_dw   <- `_stem_bwd_dw_kernel`   (pallas_call in `_bwd_dw`)
//   bwd_dx   <- `_stem_bwd_dx_kernel`   (pallas_call in `_bwd_dx`)
// The forward stored y [N, ho, wo, K], the raw conv output, and pooled
// relu(y sc + bb). Given the pooled output's gradient g [N, po, pw, K]
// and the BN rows (sc, bb, inv, mu[, m1, m2]), each computes what its
// TPU kernel computes, at the TPU kernel's rounding points:
//   bwd_pool: z0 = y sc + bb in f32; zc = relu(z0) rounded to y's dtype;
//     dz = the sum of g over the 3x3/2 pad-1 windows that cover the pixel
//     and whose maximum (over the -inf padding) equals its zc, EVERY tied
//     maximum taking the gradient (XLA's and torch's pool pick one),
//     summed in the TPU kernel's window order; dz0 = dz where z0 > 0,
//     else 0, stored in y's dtype; sum dz0 and sum dz0 yhat, yhat = (y -
//     mu) inv, over the STORED dz0 (the dW and dx passes read the rounded
//     tensor; the bottleneck backward sums before its rounding instead);
//   bwd_dw: dy = sc (dz0 - m1 - yhat m2) in f32, stored in y's dtype;
//     dW [64 C, K] f32 = the sum over the output pixels of the
//     space-to-depth window of x (the forward's im2col, pixels outside the
//     image 0) times the STORED dy, the products in f32;
//   bwd_dx: dx [N, H, W, C] = the transposed 4x4 correlation of dy with
//     the [64 C, K] contraction matrix in space-to-depth coordinates, the
//     un-shuffle back to pixels and the crop (the TPU kernel's three
//     steps): input pixel (h, w, c) sums dy[ho, wo, :] . W[(tap, phase,
//     c), :] over the 16 taps (i, j) of its s2d pixel (u, v) = ((h + 3) /
//     2, (w + 3) / 2) with (ho, wo) = (u - i, v - j) inside dy, phase
//     ((h + 3) % 2, (w + 3) % 2); f32 sums, rounded once to dy's dtype.
//
// Translation. The TPU kernels take one image per step of a sequential
// grid and carry dW and the sums along it; the pool backward scatters
// each window's gradient into a padded accumulator with pads and
// reshapes. Here:
//   - bwd_pool is a gather: one thread per (pixel, channel), channels
//     fastest so a warp reads contiguous channels; it finds the <= 4
//     windows that cover its pixel (p with |r - 2p| <= 1), recomputes
//     each window's maximum from y, and adds g where its own zc ties it.
//     No scatter, no atomics. A block covers 256 pixels of 64 channels
//     and writes its per-channel partial sums; conv_gemm.cuh's fixed-
//     order f64 pass reduces them.
//   - bwd_dw is an elementwise dy pass, then an implicit GEMM over
//     conv_gemm.cuh's tiles: rows the 64 C entries of the s2d window
//     (decode_r of the forward conv: the stem's im2col gathered from the
//     raw image), columns K, the reduction over the N ho wo pixels split
//     over the grid's z into f32 partials summed in a fixed order (f64)
//     by conv_gemm.cuh's reduce_splits: the same dW on every run.
//   - bwd_dx is laid out along the pixel axis: one thread per (s2d pixel,
//     4 of its 4 C outputs), so at C = 3 three threads share a pixel and
//     each keeps 4 f32 sums; the [64 C, K] matrix sits in shared memory
//     as f32, tap-major with the 4 C outputs contiguous (one float4 per
//     reduction step), loaded once per block, which then walks the
//     pixels (K is cut into chunks where it does not fit).
//
// What bounds it on an H100. At B=128, 224x224x3 -> 112x112x64 in bf16:
// bwd_pool reads y (206 MB) and g (51 MB) and writes dz0 (206 MB), 0.138
// ms of bytes; bwd_dw reads x (38.5 MB), y and dz0 and writes dy (206 MB
// each), 0.196 ms of bytes against 30.2 GFLOP of the 7x7 taps (0.031 ms
// at 989 TFLOP/s); bwd_dx reads dy and writes dx (38.5 MB), 0.073 ms. All
// three are bound by bytes. This first version runs every product on the
// f32 CUDA cores (67 TFLOP/s: 0.45 ms for either product), recomputes
// each pool window's maximum once per pixel that it covers (2.25 windows
// of 9 loads per pixel, from the caches), and reads dy again for the dW
// GEMM; tensor-core tiles are a later kernel's work.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <algorithm>
#include <cmath>

#include "conv_gemm.cuh"

namespace {

using dl4j_conv::Geometry;
using dl4j_conv::from_f32;
using dl4j_conv::kAStride;
using dl4j_conv::kBK;
using dl4j_conv::kBM;
using dl4j_conv::kBN;
using dl4j_conv::kBPerThread;
using dl4j_conv::kRowsPerThread;
using dl4j_conv::kStemS2d;
using dl4j_conv::kThreads;
using dl4j_conv::round_to;
using dl4j_conv::tile_step;
using dl4j_conv::to_f32;

// ---------------------------------------------------------------------
// bwd_pool
// ---------------------------------------------------------------------
constexpr int kPoolThreads = 256;
constexpr int kPoolLanes = 64;                            // channels
constexpr int kPoolPixLanes = kPoolThreads / kPoolLanes;  // 4
constexpr int kPoolPix = 256;   // pixels per block: the partials' tile

// relu(y sc + bb) rounded to T, in f32 (two roundings, no fused
// multiply-add, as the plain version's PyTorch ops).
template <typename T>
__device__ __forceinline__ float zc_of(T yv, float sc, float bb) {
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(to_f32(yv), sc), bb), 0.f));
}

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
    bwd_pool_kernel(const T* __restrict__ y, const T* __restrict__ g,
                    const float* __restrict__ aff, T* __restrict__ dz,
                    float* __restrict__ part1, float* __restrict__ part2,
                    int n, int ho, int wo, int k, int po, int pw,
                    int tiles) {
  __shared__ float red[2][kPoolPixLanes][kPoolLanes];
  const int lane = threadIdx.x % kPoolLanes;
  const int plane = threadIdx.x / kPoolLanes;
  const int ch = blockIdx.y * kPoolLanes + lane;
  const int64_t hw = static_cast<int64_t>(ho) * wo;
  const int64_t rows = n * hw;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kPoolPix;
  float s1 = 0.f, s2 = 0.f;
  if (ch < k) {
    const float sc = aff[ch];
    const float bb = aff[k + ch];
    const float inv = aff[2 * k + ch];
    const float mu = aff[3 * k + ch];
    for (int j = plane; j < kPoolPix; j += kPoolPixLanes) {
      const int64_t m = m0 + j;
      if (m >= rows) break;
      const int64_t img = m / hw;
      const int rem = static_cast<int>(m - img * hw);
      const int r = rem / wo;
      const int c = rem - r * wo;
      const T* yi = y + img * hw * k + ch;        // channel ch of image img
      const T* gi = g + img * po * pw * k + ch;
      const float yv = to_f32(yi[static_cast<int64_t>(rem) * k]);
      const float z0 = __fadd_rn(__fmul_rn(yv, sc), bb);
      const float zc = round_to<T>(fmaxf(z0, 0.f));
      float acc = 0.f;
      // the windows (p, q) with |r - 2p| <= 1 and |c - 2q| <= 1, in the
      // TPU kernel's order: its window offset r - 2p + 1 ascending
      for (int p = (r + 1) >> 1; p >= (r >> 1); --p) {
        if (p >= po) continue;
        for (int q = (c + 1) >> 1; q >= (c >> 1); --q) {
          if (q >= pw) continue;
          float mx = -INFINITY;
          for (int a = 2 * p - 1; a <= 2 * p + 1; ++a) {
            if (a < 0 || a >= ho) continue;
            for (int b = 2 * q - 1; b <= 2 * q + 1; ++b) {
              if (b < 0 || b >= wo) continue;
              mx = fmaxf(mx, zc_of(yi[(static_cast<int64_t>(a) * wo + b) * k],
                                   sc, bb));
            }
          }
          if (zc == mx)
            acc += to_f32(gi[(static_cast<int64_t>(p) * pw + q) * k]);
        }
      }
      const T stored = from_f32<T>(z0 > 0.f ? acc : 0.f);
      dz[m * k + ch] = stored;
      const float v = to_f32(stored);
      const float yhat = __fmul_rn(__fsub_rn(yv, mu), inv);
      s1 += v;
      s2 += v * yhat;
    }
  }
  // the block's partial sums: the pixel lanes reduced in order
  red[0][plane][lane] = s1;
  red[1][plane][lane] = s2;
  __syncthreads();
  if (plane == 0 && ch < k) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < kPoolPixLanes; ++t) {
      a += red[0][t][lane];
      b += red[1][t][lane];
    }
    const int64_t at = static_cast<int64_t>(ch) * tiles + blockIdx.x;
    part1[at] = a;
    part2[at] = b;
  }
}

template <typename T>
int stem_bwd_pool(const void* y, const void* g, const void* aff, void* dz,
                  void* part1, void* part2, void* s1, void* s2, int n,
                  int ho, int wo, int k, int tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(n) * ho * wo;
  const int64_t blocks = (rows + kPoolPix - 1) / kPoolPix;
  if (blocks > tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const int po = (ho - 1) / 2 + 1;
  const int pw = (wo - 1) / 2 + 1;
  dim3 grid(static_cast<unsigned>(blocks), (k + kPoolLanes - 1) / kPoolLanes);
  bwd_pool_kernel<T><<<grid, kPoolThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const float*>(aff), static_cast<T*>(dz),
      static_cast<float*>(part1), static_cast<float*>(part2), n, ho, wo, k,
      po, pw, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dl4j_conv::reduce_partials_kernel<<<k, dl4j_conv::kReduceThreads, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      static_cast<int>(blocks), tiles, static_cast<float*>(s1),
      static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// bwd_dw: the dy pass, then dW[r, kk] = sum_m A[r, m] dy[m, kk] over the
// output pixels m of one split; r = (tap, phase, c) of the s2d window,
// A = x at the pixel it reads (0 outside the image); partials [splits,
// 64 C, K]
// ---------------------------------------------------------------------
constexpr int kDyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDyThreads)
    dy_kernel(const T* __restrict__ y, const T* __restrict__ dz,
              const float* __restrict__ aff, T* __restrict__ dy,
              int64_t total, int k) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kDyThreads + threadIdx.x;
  if (i >= total) return;
  const int kk = static_cast<int>(i % k);
  const float sc = aff[kk], inv = aff[2 * k + kk], mu = aff[3 * k + kk];
  const float m1 = aff[4 * k + kk], m2 = aff[5 * k + kk];
  const float yhat = __fmul_rn(__fsub_rn(to_f32(y[i]), mu), inv);
  const float d = __fsub_rn(to_f32(dz[i]), m1);
  dy[i] = from_f32<T>(__fmul_rn(sc, __fsub_rn(d, __fmul_rn(yhat, m2))));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              float* __restrict__ part, Geometry g, int chunk) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;
  float* Bs = smem + kBK * kAStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw = g.ho * g.wo;
  const int rows = g.n * hw;
  const int mb = blockIdx.z * chunk;
  const int m_end = min(mb + chunk, rows);

  // A loads: one window entry r per thread (consecutive threads on
  // consecutive channels and phases), reduction offsets a_k + 2 j
  const int a_r = tid & 127;
  const int a_k = tid >> 7;
  const int r = r0 + a_r;
  const bool r_ok = r < g.r;
  int ch = 0, dh = 0, dw = 0;
  if (r_ok) dl4j_conv::decode_r<kStemS2d>(r, g, ch, dh, dw);
  // B loads: column b_n (consecutive threads on consecutive kk),
  // reduction offsets b_k + 4 j
  const int b_n = tid & 63;
  const int b_k = tid >> 6;
  const int col = n0 + b_n;
  const bool col_ok = col < g.k;

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
        const int oh = rem / g.wo;
        const int ow = rem - oh * g.wo;
        const int ih = 2 * oh + dh;
        const int iw = 2 * ow + dw;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          z = to_f32(
              x[((static_cast<int64_t>(nn) * g.h + ih) * g.w + iw) * g.c + ch]);
      }
      ra[j] = z;
    }
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j) {
      const int m = mb + k0 + b_k + 4 * j;
      rb[j] = (col_ok && m < m_end)
                  ? to_f32(dy[static_cast<int64_t>(m) * g.k + col])
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

  float* out = part + static_cast<int64_t>(blockIdx.z) * g.r * g.k;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = r0 + ty * 8 + i;
    if (rr >= g.r) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = n0 + tx * 4 + j;
      if (cc < g.k) out[static_cast<int64_t>(rr) * g.k + cc] = acc[i][j];
    }
  }
}

// dy, then the dW GEMM and its split reduction. Refuses (before any
// launch) splits that do not cover the pixels in whole reduction steps.
template <typename T>
int stem_bwd_dw(const void* x, const void* y, const void* dz,
                const void* aff, void* dy, void* dw, void* dw_part, int n,
                int h, int wd, int c, int k, int chunk, int splits,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ho = (h - 1) / 2 + 1;
  const int wo = (wd - 1) / 2 + 1;
  const int rows = n * ho * wo;
  if (chunk <= 0 || chunk % kBK ||
      static_cast<int64_t>(chunk) * splits < rows ||
      static_cast<int64_t>(chunk) * (splits - 1) >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || c == 0 || k == 0)
    return static_cast<int>(cudaGetLastError());
  const int64_t total = static_cast<int64_t>(rows) * k;
  dy_kernel<T><<<static_cast<unsigned>((total + kDyThreads - 1) / kDyThreads),
                 kDyThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(dz),
      static_cast<const float*>(aff), static_cast<T*>(dy), total, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{n, h, wd, c, ho, wo, k, 2, 64 * c, 0, 0};
  dim3 grid((g.r + kBM - 1) / kBM, (k + kBN - 1) / kBN, splits);
  dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(dw_part), g, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return dl4j_conv::reduce_splits(dw_part, splits,
                                  static_cast<int64_t>(g.r) * k, dw, st);
}

// ---------------------------------------------------------------------
// bwd_dx
// ---------------------------------------------------------------------
constexpr int kDxThreads = 256;
constexpr int kDxSmem = 12288;   // floats (48 KB): a [16, kc, 4 C] chunk
constexpr int kDxBlocksPerSm = 4;

template <typename T>
__global__ void __launch_bounds__(kDxThreads)
    dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
              T* __restrict__ dx, int n, int h, int wd, int c, int k,
              int ho, int wo, int us, int vs, int kc) {
  __shared__ __align__(16) float Ws[kDxSmem];
  const int c4 = 4 * c;
  const int per_block = kDxThreads / c;     // s2d pixels per tile
  const int pl = threadIdx.x / c;
  const int grp = threadIdx.x - pl * c;     // outputs 4 grp .. 4 grp + 3
  const int64_t pixels = static_cast<int64_t>(n) * us * vs;
  const int64_t tiles = (pixels + per_block - 1) / per_block;
  const int chunks = (k + kc - 1) / kc;
  bool loaded = false;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t pix = tile * per_block + pl;
    const bool active = pl < per_block && pix < pixels;
    int img = 0, u = 0, v = 0;
    if (active) {
      img = static_cast<int>(pix / (static_cast<int64_t>(us) * vs));
      const int rem =
          static_cast<int>(pix - static_cast<int64_t>(img) * us * vs);
      u = 1 + rem / vs;              // s2d rows 1 .. us touch the image
      v = 1 + rem % vs;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int chk = 0; chk < chunks; ++chk) {
      const int k0 = chk * kc;
      const int kcur = min(kc, k - k0);
      if (chunks > 1 || !loaded) {
        // the chunk of W as f32 [tap][kk][4 C]: read along kk (coalesced)
        __syncthreads();
        const int total = 64 * c * kcur;
        for (int i = threadIdx.x; i < total; i += kDxThreads) {
          const int kk = i % kcur;
          const int row = i / kcur;          // (tap, phase, channel)
          const int tap = row / c4;
          const int o = row - tap * c4;
          Ws[(tap * kcur + kk) * c4 + o] =
              to_f32(w[static_cast<int64_t>(row) * k + k0 + kk]);
        }
        __syncthreads();
        loaded = true;
      }
      if (!active) continue;
      for (int tap = 0; tap < 16; ++tap) {
        const int du = u - (tap >> 2);
        const int dv = v - (tap & 3);
        if (du < 0 || du >= ho || dv < 0 || dv >= wo) continue;
        const T* d =
            dy + ((static_cast<int64_t>(img) * ho + du) * wo + dv) * k + k0;
        const float* wt = Ws + tap * kcur * c4 + 4 * grp;
        for (int kk = 0; kk < kcur; ++kk) {
          const float dv_ = to_f32(d[kk]);
          const float4 wv = *reinterpret_cast<const float4*>(wt + kk * c4);
          acc[0] = fmaf(dv_, wv.x, acc[0]);
          acc[1] = fmaf(dv_, wv.y, acc[1]);
          acc[2] = fmaf(dv_, wv.z, acc[2]);
          acc[3] = fmaf(dv_, wv.w, acc[3]);
        }
      }
    }
    if (!active) continue;
    // the un-shuffle and crop: output o = phase C + channel
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 4 * grp + e;
      const int phase = o / c;
      const int cc = o - phase * c;
      const int row = 2 * u - 3 + (phase >> 1);
      const int col = 2 * v - 3 + (phase & 1);
      if (row < 0 || row >= h || col < 0 || col >= wd) continue;
      dx[((static_cast<int64_t>(img) * h + row) * wd + col) * c + cc] =
          from_f32<T>(acc[e]);
    }
  }
}

template <typename T>
int stem_bwd_dx(const void* dy, const void* w, void* dx, int n, int h,
                int wd, int c, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c <= 0 || 16 * 4 * c > kDxSmem || c > kDxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pixels =
      static_cast<int64_t>(n) * ((h + 2) >> 1) * ((wd + 2) >> 1);
  if (pixels == 0) return static_cast<int>(cudaGetLastError());
  const int kc = std::min(k, kDxSmem / (64 * c));
  const int per_block = kDxThreads / c;
  const int64_t tiles = (pixels + per_block - 1) / per_block;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid =
      std::min(tiles, static_cast<int64_t>(sms) * kDxBlocksPerSm);
  dx_kernel<T><<<static_cast<unsigned>(grid), kDxThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w),
      static_cast<T*>(dx), n, h, wd, c, k, (h - 1) / 2 + 1, (wd - 1) / 2 + 1,
      (h + 2) >> 1, (wd + 2) >> 1, kc > 0 ? kc : 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dl4j_stem_bwd_pool_f32(const void* y, const void* g, const void* aff,
                           void* dz, void* part1, void* part2, void* s1,
                           void* s2, int n, int ho, int wo, int k, int tiles,
                           void* stream) {
  return stem_bwd_pool<float>(y, g, aff, dz, part1, part2, s1, s2, n, ho, wo,
                              k, tiles, stream);
}

int dl4j_stem_bwd_pool_bf16(const void* y, const void* g, const void* aff,
                            void* dz, void* part1, void* part2, void* s1,
                            void* s2, int n, int ho, int wo, int k,
                            int tiles, void* stream) {
  return stem_bwd_pool<__nv_bfloat16>(y, g, aff, dz, part1, part2, s1, s2, n,
                                      ho, wo, k, tiles, stream);
}

int dl4j_stem_bwd_dw_f32(const void* x, const void* y, const void* dz,
                         const void* aff, void* dy, void* dw, void* dw_part,
                         int n, int h, int wd, int c, int k, int chunk,
                         int splits, void* stream) {
  return stem_bwd_dw<float>(x, y, dz, aff, dy, dw, dw_part, n, h, wd, c, k,
                            chunk, splits, stream);
}

int dl4j_stem_bwd_dw_bf16(const void* x, const void* y, const void* dz,
                          const void* aff, void* dy, void* dw, void* dw_part,
                          int n, int h, int wd, int c, int k, int chunk,
                          int splits, void* stream) {
  return stem_bwd_dw<__nv_bfloat16>(x, y, dz, aff, dy, dw, dw_part, n, h, wd,
                                    c, k, chunk, splits, stream);
}

int dl4j_stem_bwd_dx_f32(const void* dy, const void* w, void* dx, int n,
                         int h, int wd, int c, int k, void* stream) {
  return stem_bwd_dx<float>(dy, w, dx, n, h, wd, c, k, stream);
}

int dl4j_stem_bwd_dx_bf16(const void* dy, const void* w, void* dx, int n,
                          int h, int wd, int c, int k, void* stream) {
  return stem_bwd_dx<__nv_bfloat16>(dy, w, dx, n, h, wd, c, k, stream);
}

int dl4j_stem_bwd_pool_tile() { return kPoolPix; }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
