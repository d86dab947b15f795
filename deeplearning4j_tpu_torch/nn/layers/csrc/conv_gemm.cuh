// Implicit-GEMM convolution with a BN-affine prologue and a per-channel
// sum / sum-of-squares epilogue, shared by the bottleneck kernels
// (bottleneck.cu: 1x1 and 3x3) and the space-to-depth stem conv
// (stem.cu); its tile step and the stem's im2col decode also serve the
// stem's backward passes (stem_bwd.cu) and the f32 bottleneck backward
// (bottleneck_bwd.cu), and its fixed-order reductions (the per-block
// partial sums, the dW splits) every backward kernel. The bf16
// bottleneck backward runs on the tensor cores instead (conv_mma.cuh).
// Layouts are the JAX package's: x NHWC, the weight as the
// contraction matrix [R, K] (R = C for a 1x1 conv, 9C tap-major for the
// 3x3, 64C in the phase-major space-to-depth order for the stem), the
// output NHWC [N, Ho, Wo, K].
//
// One output row m is one output pixel (n, ho, wo); the GEMM is
// out[m, k] = sum_r a(m, r) w[r, k], where a(m, r) is the prologue of
// the input element the row reads at reduction index r:
//   - 1x1 (stride s): pixel (ho s, wo s), channel r (the [::s, ::s]
//     subsample is taken first);
//   - 3x3 same pad: tap t = r / C (kh = t / 3, kw = t % 3), channel
//     r % C, pixel (ho + kh - 1, wo + kw - 1);
//   - stem: tap (i, j) = (r / 4C / 4, r / 4C % 4), phase (pi, pj) from
//     (r % 4C) / C, channel r % C, pixel (2 ho + 2 i + pi - 3,
//     2 wo + 2 j + pj - 3): the 4x4/1 conv over the space-to-depth image
//     of the input padded by 3 at the top and left. The JAX package pads
//     the bottom and right to an even extent (5 or 4 rows); those rows are
//     zeros that only the zero-weighted eighth tap reads, so here every
//     pixel outside the image simply reads 0.
// The prologue is the TPU kernel's: x widened to f32, z = x sc + bb, relu
// when asked, then z rounded to the weight's dtype. z rounds twice (no
// fused multiply-add), as the plain version's two PyTorch ops do, so the
// kernel and its plain version see the same z; XLA on the CPU contracts
// the two into one fused multiply-add, 1 ulp of f32 apart. A pixel outside the image reads
// z = 0: the TPU kernel pads the activated image, so a padded tap gives 0,
// not relu(bb). Without sc/bb the prologue is the identity.
//
// Epilogue: the f32 accumulator rounded to the output dtype and stored;
// the per-channel sums of the STORED (rounded) values, reduced within
// the block in a fixed order into per-block partials, then over the
// blocks in a fixed order by a second kernel (f64 accumulation): the
// same sums on every run, no atomics.
//
// Tiles: a block of 256 threads owns 128 rows x 64 output channels and
// walks R in steps of 16; each thread owns an 8 x 4 strip of the tile in
// registers. The A tile is gathered (with its prologue) and the B tile
// loaded into registers one step ahead, then staged in shared memory as
// f32; every product runs on the f32 CUDA cores (bf16 x bf16 products
// are exact in f32, so bf16 needs no other arithmetic; f32 stays f32, no
// TF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "nan_max.cuh"

namespace dl4j_conv {

constexpr int kBM = 128;        // output rows (pixels) per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 16;         // reduction step
constexpr int kThreads = 256;   // 16 x 16 threads, each 8 rows x 4 channels
constexpr int kAStride = kBM + 4;
constexpr int kRowsPerThread = kBM * kBK / kThreads;   // A loads: 8
constexpr int kBPerThread = kBK * kBN / kThreads;      // B loads: 4

enum Mode : int { kConv1x1 = 0, kConv3x3 = 1, kStemS2d = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Geometry {
  int n, h, w, c;   // input [n, h, w, c]
  int ho, wo, k;    // output [n, ho, wo, k]
  int stride;       // the 1x1 conv's subsample
  int r;            // reduction length: c, 9c or 64c
  int relu;         // prologue activation
  int tiles;        // the partials' length per channel (>= row blocks)
};

// The input pixel and channel that reduction index r of row (oh, ow)
// reads: (dh, dw) offsets the row's anchor, ch is the channel.
template <int MODE>
__device__ __forceinline__ void decode_r(int r, const Geometry& g, int& ch,
                                         int& dh, int& dw) {
  if (MODE == kConv1x1) {
    ch = r;
    dh = 0;
    dw = 0;
  } else if (MODE == kConv3x3) {
    const int t = r / g.c;
    ch = r - t * g.c;
    dh = t / 3 - 1;
    dw = t % 3 - 1;
  } else {
    const int c4 = 4 * g.c;
    const int tap = r / c4;
    const int rem = r - tap * c4;
    const int ph = rem / g.c;
    ch = rem - ph * g.c;
    dh = 2 * (tap >> 2) + (ph >> 1) - 3;
    dw = 2 * (tap & 3) + (ph & 1) - 3;
  }
}

// One reduction step's loads into registers: this thread's A values
// (reduction index k0 + a_k of its rows, prologue applied) and B values
// (reduction rows k0 + b_k + 4 j of channel n0 + b_n).
template <typename T, int MODE>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ x, const float* __restrict__ sc,
    const float* __restrict__ bb, const T* __restrict__ w,
    const Geometry& g, int k0, int a_k, const int (&img)[kRowsPerThread],
    const int (&ah)[kRowsPerThread], const int (&aw)[kRowsPerThread],
    int b_k, int b_n, int n0, float (&ra)[kRowsPerThread],
    float (&rb)[kBPerThread]) {
  const int r = k0 + a_k;
  const bool r_ok = r < g.r;
  int ch = 0, dh = 0, dw = 0;
  if (r_ok) decode_r<MODE>(r, g, ch, dh, dw);
  float s = 1.f, b = 0.f;
  const bool affine = sc != nullptr;
  if (affine && r_ok) {
    s = sc[ch];
    b = bb[ch];
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    float z = 0.f;
    const int ih = ah[j] + dh;
    const int iw = aw[j] + dw;
    if (r_ok && img[j] >= 0 && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w) {
      const int64_t off =
          (static_cast<int64_t>(img[j]) + ih * g.w + iw) * g.c + ch;
      z = to_f32(x[off]);
      if (affine) {
        z = __fadd_rn(__fmul_rn(z, s), b);
        if (g.relu) z = dl4j_nan::relu_nan(z);
      }
      z = round_to<T>(z);
    }
    ra[j] = z;
  }
  const int col = n0 + b_n;
#pragma unroll
  for (int j = 0; j < kBPerThread; ++j) {
    const int rr = k0 + b_k + 4 * j;
    rb[j] = (rr < g.r && col < g.k)
                ? to_f32(w[static_cast<int64_t>(rr) * g.k + col])
                : 0.f;
  }
}

// One reduction step of a tile: each thread's 8 x 4 strip (rows ty * 8,
// channels tx * 4) accumulates the kBK products of the staged A and B.
__device__ __forceinline__ void tile_step(const float* As, const float* Bs,
                                          int ty, int tx,
                                          float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 =
        *reinterpret_cast<const float4*>(&As[kk * kAStride + ty * 8]);
    const float4 a1 =
        *reinterpret_cast<const float4*>(&As[kk * kAStride + ty * 8 + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk * kBN + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
}

// The block's partial sums: each thread's column sums s1, s2 (channels
// n0 + tx * 4 + j of its 8 rows) reduced over the 16 row groups in order
// into part1/part2 [cols][tiles] at row block blockIdx.x. Reuses `smem`
// (2 x 16 x kBN floats), which the caller no longer reads.
__device__ __forceinline__ void block_partials(float* smem,
                                               const float (&s1)[4],
                                               const float (&s2)[4], int n0,
                                               int cols, int tiles,
                                               float* __restrict__ part1,
                                               float* __restrict__ part2) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float* red1 = smem;                  // [16][kBN]
  float* red2 = smem + 16 * kBN;       // [16][kBN]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red1[ty * kBN + tx * 4 + j] = s1[j];
    red2[ty * kBN + tx * 4 + j] = s2[j];
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < cols) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < 16; ++t) {
      a += red1[t * kBN + tid];
      b += red2[t * kBN + tid];
    }
    const int64_t at = static_cast<int64_t>(n0 + tid) * tiles + blockIdx.x;
    part1[at] = a;
    part2[at] = b;
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    conv_gemm_kernel(const T* __restrict__ x, const float* __restrict__ sc,
                     const float* __restrict__ bb, const T* __restrict__ w,
                     T* __restrict__ out, float* __restrict__ part1,
                     float* __restrict__ part2, Geometry g) {
  __shared__ __align__(16) float smem[kBK * kAStride + kBK * kBN];
  float* As = smem;                     // [kBK][kAStride]
  float* Bs = smem + kBK * kAStride;    // [kBK][kBN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;              // channels tx*4 .. +4
  const int ty = tid >> 4;              // rows ty*8 .. +8
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int rows = g.n * g.ho * g.wo;

  // this thread's A loads: reduction offset a_k, rows a_m + 16 j
  const int a_k = tid & 15;
  const int a_m = tid >> 4;
  // each loaded row's image offset (n h w) and anchor pixel, or -1
  int img[kRowsPerThread], ah[kRowsPerThread], aw[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int m = m0 + a_m + 16 * j;
    if (m < rows) {
      const int hw = g.ho * g.wo;
      const int nn = m / hw;
      const int rem = m - nn * hw;
      const int oh = rem / g.wo;
      const int ow = rem - oh * g.wo;
      img[j] = nn * g.h * g.w;
      if (MODE == kConv1x1) {
        ah[j] = oh * g.stride;
        aw[j] = ow * g.stride;
      } else if (MODE == kConv3x3) {
        ah[j] = oh;
        aw[j] = ow;
      } else {
        ah[j] = 2 * oh;
        aw[j] = 2 * ow;
      }
    } else {
      img[j] = -1;
      ah[j] = 0;
      aw[j] = 0;
    }
  }
  // this thread's B loads: channel b_n, reduction rows b_k + 4 j
  const int b_n = tid & 63;
  const int b_k = tid >> 6;

  float ra[kRowsPerThread];
  float rb[kBPerThread];

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_tile<T, MODE>(x, sc, bb, w, g, 0, a_k, img, ah, aw, b_k, b_n, n0, ra,
                     rb);
  for (int k0 = 0; k0 < g.r; k0 += kBK) {
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      As[a_k * kAStride + a_m + 16 * j] = ra[j];
#pragma unroll
    for (int j = 0; j < kBPerThread; ++j)
      Bs[(b_k + 4 * j) * kBN + b_n] = rb[j];
    __syncthreads();
    if (k0 + kBK < g.r)   // in flight during the products
      load_tile<T, MODE>(x, sc, bb, w, g, k0 + kBK, a_k, img, ah, aw, b_k, b_n,
                         n0, ra, rb);
    tile_step(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  // epilogue: store the rounded output, sum the stored values
  float s1[4] = {0.f, 0.f, 0.f, 0.f};
  float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= g.k) continue;
      const T o = from_f32<T>(acc[i][j]);
      out[static_cast<int64_t>(m) * g.k + col] = o;
      const float of = to_f32(o);
      s1[j] += of;
      s2[j] += of * of;
    }
  }
  block_partials(smem, s1, s2, n0, g.k, g.tiles, part1, part2);
}

// The blocks' partial sums, [k][tiles] (the first `blocks` of each row
// written), reduced per channel in a fixed order in f64: each of 256
// threads sums a strided share of the blocks, then a tree over the
// threads. One block per channel.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ part1,
                           const float* __restrict__ part2, int blocks,
                           int tiles, float* __restrict__ s1,
                           float* __restrict__ s2) {
  __shared__ double ra[kReduceThreads], rb[kReduceThreads];
  const int col = blockIdx.x;
  const float* p1 = part1 + static_cast<int64_t>(col) * tiles;
  const float* p2 = part2 + static_cast<int64_t>(col) * tiles;
  double a = 0.0, b = 0.0;
  for (int i = threadIdx.x; i < blocks; i += kReduceThreads) {
    a += p1[i];
    b += p2[i];
  }
  ra[threadIdx.x] = a;
  rb[threadIdx.x] = b;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      ra[threadIdx.x] += ra[threadIdx.x + half];
      rb[threadIdx.x] += rb[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    s1[col] = static_cast<float>(ra[0]);
    s2[col] = static_cast<float>(rb[0]);
  }
}

// A weight gradient split over the pixels into f32 partials [splits,
// size]: summed over the splits in order (f64), one thread per entry, so
// the same result on every run and no float atomics. Used by the
// backward kernels' dW passes (bottleneck_bwd.cu, stem_bwd.cu).
constexpr int kSplitThreads = 256;

__global__ void __launch_bounds__(kSplitThreads)
    reduce_splits_kernel(const float* __restrict__ part, int splits,
                         int64_t size, float* __restrict__ dw) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (i >= size) return;
  double a = 0.0;
  for (int z = 0; z < splits; ++z) a += part[z * size + i];
  dw[i] = static_cast<float>(a);
}

// Launch reduce_splits_kernel over `size` entries on `stream`.
inline int reduce_splits(const void* part, int splits, int64_t size,
                         void* dw, cudaStream_t stream) {
  reduce_splits_kernel<<<static_cast<unsigned>((size + kSplitThreads - 1) /
                                                kSplitThreads),
                         kSplitThreads, 0, stream>>>(
      static_cast<const float*>(part), splits, size,
      static_cast<float*>(dw));
  return static_cast<int>(cudaGetLastError());
}

// The number of row blocks the GEMM launches: the partials' second dim.
inline int row_blocks(const Geometry& g) {
  return (g.n * g.ho * g.wo + kBM - 1) / kBM;
}

// Launch the GEMM and the partials' reduction on `stream`; returns the
// launch error. part1/part2 hold g.k x g.tiles floats each; a g.tiles
// short of row_blocks(g) is refused (cudaErrorInvalidValue) before any
// launch. The caller sizes them from dl4j_conv_row_tile().
template <typename T, int MODE>
int launch(const void* x, const void* sc, const void* bb, const void* w,
           void* out, void* part1, void* part2, void* s1, void* s2,
           const Geometry& g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = row_blocks(g);
  if (blocks > g.tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || g.k == 0) return static_cast<int>(cudaGetLastError());
  dim3 grid(blocks, (g.k + kBN - 1) / kBN);
  conv_gemm_kernel<T, MODE><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(sc),
      static_cast<const float*>(bb), static_cast<const T*>(w),
      static_cast<T*>(out), static_cast<float*>(part1),
      static_cast<float*>(part2), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<g.k, kReduceThreads, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      blocks, g.tiles, static_cast<float*>(s1), static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dl4j_conv
