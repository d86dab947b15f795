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
//     summed in the TPU kernel's window order (relu and maximum
//     NaN-propagating, nan_max.cuh, as jnp.maximum: a NaN in a window
//     makes its maximum NaN, which no zc equals, so that window sends no
//     gradient); dz0 = dz where z0 > 0,
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
//   - bwd_pool is a tiled gather that reads y once from device memory.
//     A block owns 8 x 8 pooled windows of one image (pixel rows 2 p0 ..
//     2 p0 + 15, columns likewise) and 64 channels. It stages the y rows
//     under them with their halo (one pixel row and column before, two
//     after: the next tile's first windows reach into the tile) and the
//     9 x 9 windows' g rows in shared memory, 16-byte cp.async (8 bf16
//     or 4 f32 channels a thread) where K is a whole number of vectors
//     and the pointers are aligned, element by element otherwise (the
//     halo's overlap with the neighbouring tiles comes from L2); converts
//     the halo to zc once (-inf outside the image); writes each window's
//     maximum once; then each thread takes 8 (or 4) channels of a pair of
//     pixels of one row, reads each covering window's maximum and g once
//     for the pair, adds g where a pixel's zc ties the maximum, in the
//     TPU kernel's window order, masks by z0 > 0, and stores 16 bytes of
//     dz0 a pixel. No scatter, no atomics. Each block sums its pixels'
//     stored dz0 and dz0 yhat per channel in a fixed order into one
//     partial; conv_gemm.cuh's fixed-order f64 pass reduces them.
//   - bwd_dw in bf16 at 4 C <= 16 (RGB or RGBA input, the main path's C
//     = 3) is one pass on the tensor cores (dw_tc below): the s2d view
//     makes dW a 16-tap conv's weight gradient, dW[tap (i, j)] = sum over
//     the pixels of s2d[oh + i, ow + j, :4C]^T dy[oh, ow, :]. A block
//     owns 8 x 16-pixel patches of an image and 64 output channels; per
//     patch it stages the x rows under the patch's s2d halo, y and dz
//     (cp.async, a ring two patches ahead), rearranges the raw rows into
//     the padded s2d halo tile, computes dy (the same ops as the plain
//     version) into the product's B tile and stores it, and runs 8 k16
//     steps of mma.sync m16n8k16 (16 taps x 16 channels x 64 columns), the
//     16 taps reading shifted windows of the halo through ldmatrix. The
//     grid is persistent (one block an SM): each block keeps its dW tile
//     in registers over its patches and writes one f32 partial, summed in
//     a fixed order (f64) by conv_gemm.cuh's reduce_splits: the same dW
//     on every run, no atomics. f32, and bf16 at 4 C > 16, keep the
//     CUDA-core route: an elementwise dy pass, then an implicit GEMM over
//     conv_gemm.cuh's tiles (rows the 64 C entries of the s2d window,
//     decode_r of the forward conv; columns K; the pixels split over the
//     grid's z into f32 partials, reduced the same way);
//   - bwd_dx in bf16 at 4 C <= 16 and K <= 64 (the main path's C = 3, K
//     = 64) runs on the tensor cores (dx_tc below): in s2d coordinates
//     it is a 16-tap conv, dS[u, v, :4C] = sum over the taps (i, j) of
//     dy[u - i, v - j, :K] W_tap^T, a GEMM of the s2d pixels by 4 C
//     (padded to 16) over 16 taps x K. A persistent block keeps the
//     whole s2d weight in shared memory (32 KB) and walks 24 x 16-pixel
//     patches, the dy halo under each staged by cp.async a patch ahead;
//     its 16 taps read shifted windows of the halo through ldmatrix,
//     each warp reusing a loaded halo row for the tap rows of its three
//     patch rows, and mma.sync m16n8k16 multiplies;
//     the epilogue un-shuffles the patch's dx into shared memory and
//     stores whole row segments. f32, and wider inputs, keep the
//     CUDA-core pass: one thread per (s2d pixel, 4 of its 4 C outputs),
//     so at C = 3 three threads share a pixel and each keeps 4 f32
//     sums; the [64 C, K] matrix sits in shared memory as f32,
//     tap-major with the 4 C outputs contiguous (one float4 per
//     reduction step), loaded once per block, which then walks the
//     pixels (K is cut into chunks where it does not fit).
//
// What bounds it on an H100. At B=128, 224x224x3 -> 112x112x64 in bf16:
// bwd_pool reads y (206 MB) and g (51 MB) and writes dz0 (206 MB), 0.138
// ms of bytes; bwd_dw reads x (38.5 MB), y and dz0 and writes dy (206 MB
// each), 0.196 ms of bytes against 30.2 GFLOP of the 7x7 taps (0.031 ms
// at 989 TFLOP/s; 52.6 GFLOP with the padded 8x8 window and the four
// zero channels of each tap the tensor cores multiply); bwd_dx reads dy
// and writes dx (38.5 MB), 0.073 ms. All three are bound by bytes.
// bwd_dw's one pass moves those bytes once (dy is never read back) and
// multiplies at the tensor cores' rate; what still holds it back is one
// 8-warp block an SM running each patch's rearrangement and dy, then its
// products, one after the other (two barriers a patch), and mma.sync's
// rate below wgmma's. bwd_dx's tensor-core pass reads dy once from
// device memory (the halo's overlap from L2) and does 64 GFLOP of
// padded products, 0.065 ms at 989 TFLOP/s; what bounds it in practice
// is shared memory: each tap reads its window of the halo again, 1.7 KB
// of ldmatrix a pixel (10 ldmatrix for 24 products; 3.4 GB at B=128
// with the patches' padding), ~0.10 ms at 128 bytes a clock an SM, and
// each patch's copy, products and stores running one after another in
// one 8-warp block an SM. bwd_pool moves its bytes once (y's halo
// rows, 1.4x the tile's, come from L2); what bounds it in practice is
// its instructions, about 30 an element: the halo's conversion to zc
// (1.4x the tile's pixels), the window reads and compares, and each
// pixel's mask, rounding and two sums, in two blocks an SM (113 KB of
// shared memory each in bf16) whose passes wait on each other at their
// barriers. Its copies hide behind the other block's passes; smaller
// tiles (more blocks an SM) cost more in halo than they gain.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <algorithm>
#include <climits>
#include <cmath>

#include "conv_gemm.cuh"
#include "conv_mma.cuh"
#include "stem_s2d.cuh"

namespace {

using dl4j_conv::Geometry;
using dl4j_nan::hmax2_nan_bits;
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
constexpr int kPoolC = 64;        // channels a block (a chunk of K)
constexpr int kPoolWh = 8;        // pooled windows a tile: rows
constexpr int kPoolWw = 8;        //   and columns
// the halo tile of y (and zc): the tile's 2 kPoolWh pixel rows, one
// before and two after (the next tile's first windows), likewise across
constexpr int kPoolHh = 2 * kPoolWh + 3;
constexpr int kPoolHw = 2 * kPoolWw + 3;
// the windows whose maxima and g a tile reads: its own and the next
// tile's first row and column
constexpr int kPoolMh = kPoolWh + 1;
constexpr int kPoolMw = kPoolWw + 1;

template <typename T>
constexpr size_t pool_smem() {
  return sizeof(T) * kPoolC *
         (2 * kPoolHh * kPoolHw + 2 * kPoolMh * kPoolMw);
}

// VEC channels of one pixel: one 16-byte access where VEC x sizeof(T) is
// 16, one element where VEC is 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
constexpr bool kBf16x8 = sizeof(T) == 2 && VEC == 8;

// A pack's values in f32.
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const T* p, float (&f)[VEC]) {
  const Pack<T, VEC> v = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = to_f32(v.v[e]);
}

// f32 values rounded to T (round to nearest even) and stored as a pack
// (bf16: two values a conversion).
template <typename T, int VEC>
__device__ __forceinline__ void pack_store(T* p, const float (&f)[VEC]) {
  if constexpr (kBf16x8<T, VEC>) {
    *reinterpret_cast<uint4*>(p) = dl4j_mma::pack8(f);
  } else {
    Pack<T, VEC> v;
#pragma unroll
    for (int e = 0; e < VEC; ++e) v.v[e] = from_f32<T>(f[e]);
    *reinterpret_cast<Pack<T, VEC>*>(p) = v;
  }
}

// One tile of pooled windows (blockIdx.x: image, tile row, tile column
// of a (down, across) grid) and one chunk of kPoolC channels
// (blockIdx.y); a thread holds the VEC channels cv .. cv + VEC of the
// chunk (VEC = 16 / sizeof(T): the 16-byte route; 1: the element route)
// and takes pixel slot, slot + kPix, ... of each pass.
template <typename T, int VEC>
__global__ void __launch_bounds__(kPoolThreads, 2)
    bwd_pool_kernel(const T* __restrict__ y, const T* __restrict__ g,
                    const float* __restrict__ aff, T* __restrict__ dz,
                    float* __restrict__ part1, float* __restrict__ part2,
                    int ho, int wo, int k, int po, int pw, int down,
                    int across, int tiles) {
  constexpr int kL = kPoolC / VEC;           // threads a pixel
  constexpr int kPix = kPoolThreads / kL;    // pixels a pass
  extern __shared__ __align__(16) unsigned char pool_raw[];
  T* ys = reinterpret_cast<T*>(pool_raw);    // [kPoolHh][kPoolHw][kPoolC]
  T* zs = ys + kPoolHh * kPoolHw * kPoolC;   // the same, zc
  T* ms = zs + kPoolHh * kPoolHw * kPoolC;   // [kPoolMh][kPoolMw][kPoolC]
  T* gs = ms + kPoolMh * kPoolMw * kPoolC;   // the same, g

  const int img = blockIdx.x / (down * across);
  const int rem = blockIdx.x - img * down * across;
  const int tr = rem / across;
  const int p0 = tr * kPoolWh;
  const int q0 = (rem - tr * across) * kPoolWw;
  const int r0 = 2 * p0 - 1, c0 = 2 * q0 - 1;   // the halo's first pixel
  const int ch0 = blockIdx.y * kPoolC;
  const int kc = min(kPoolC, k - ch0);
  const int slot = threadIdx.x / kL;
  const int cv = (threadIdx.x - slot * kL) * VEC;
  // the thread's channels exist (the 16-byte route: K a whole number of
  // vectors, so all VEC of them)
  const bool on = cv < kc;
  const T* yi = y + static_cast<int64_t>(img) * ho * wo * k + ch0 + cv;
  const T* gi = g + static_cast<int64_t>(img) * po * pw * k + ch0 + cv;

  // stage the halo's y and the windows' g
  if (on) {
    for (int px = slot; px < kPoolHh * kPoolHw; px += kPix) {
      const int hr = px / kPoolHw;
      const int r = r0 + hr, c = c0 + px - hr * kPoolHw;
      if (r < 0 || r >= ho || c < 0 || c >= wo) continue;
      const T* src = yi + (static_cast<int64_t>(r) * wo + c) * k;
      T* dst = ys + px * kPoolC + cv;
      if constexpr (VEC > 1)
        dl4j_mma::cp_async16(dst, src, true);
      else
        *dst = *src;
    }
    for (int wx = slot; wx < kPoolMh * kPoolMw; wx += kPix) {
      const int a = wx / kPoolMw, b = wx - a * kPoolMw;
      if (p0 + a >= po || q0 + b >= pw) continue;
      const T* src = gi + (static_cast<int64_t>(p0 + a) * pw + q0 + b) * k;
      T* dst = gs + wx * kPoolC + cv;
      if constexpr (VEC > 1)
        dl4j_mma::cp_async16(dst, src, true);
      else
        *dst = *src;
    }
  }
  dl4j_mma::cp_async_commit();
  float sc[VEC], bb[VEC], inv[VEC], mu[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = ch0 + cv + e;
    sc[e] = on ? aff[ch] : 0.f;
    bb[e] = on ? aff[k + ch] : 0.f;
    inv[e] = on ? aff[2 * k + ch] : 0.f;
    mu[e] = on ? aff[3 * k + ch] : 0.f;
  }
  dl4j_mma::cp_async_wait<0>();
  __syncthreads();

  // zc over the halo, once: relu(y sc + bb) in f32 (two roundings, no
  // fused multiply-add, as the plain version's PyTorch ops) rounded to T;
  // -inf (the pool's padding) outside the image
  if (on) {
    for (int px = slot; px < kPoolHh * kPoolHw; px += kPix) {
      const int hr = px / kPoolHw;
      const int r = r0 + hr, c = c0 + px - hr * kPoolHw;
      const bool in = r >= 0 && r < ho && c >= 0 && c < wo;
      float z[VEC];
      unpack<T, VEC>(ys + px * kPoolC + cv, z);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        z[e] = in ? dl4j_nan::relu_nan(
                        __fadd_rn(__fmul_rn(z[e], sc[e]), bb[e]))
                  : -INFINITY;
      pack_store<T, VEC>(zs + px * kPoolC + cv, z);
    }
  }
  __syncthreads();

  // each window's maximum, once
  if (on) {
    for (int wx = slot; wx < kPoolMh * kPoolMw; wx += kPix) {
      const int a = wx / kPoolMw, b = wx - a * kPoolMw;
      if (p0 + a >= po || q0 + b >= pw) continue;
      const T* z0p = zs + (2 * a * kPoolHw + 2 * b) * kPoolC + cv;
      if constexpr (kBf16x8<T, VEC>) {
        // bf16 pairs: the maximum is one of the values (or NaN) either
        // way
        uint4 m = *reinterpret_cast<const uint4*>(z0p);
#pragma unroll
        for (int t = 1; t < 9; ++t) {
          const uint4 z = *reinterpret_cast<const uint4*>(
              z0p + ((t / 3) * kPoolHw + t % 3) * kPoolC);
          m = make_uint4(hmax2_nan_bits(m.x, z.x), hmax2_nan_bits(m.y, z.y),
                         hmax2_nan_bits(m.z, z.z), hmax2_nan_bits(m.w, z.w));
        }
        *reinterpret_cast<uint4*>(ms + wx * kPoolC + cv) = m;
      } else {
        float mx[VEC], z[VEC];
        unpack<T, VEC>(z0p, mx);
#pragma unroll
        for (int t = 1; t < 9; ++t) {
          unpack<T, VEC>(z0p + ((t / 3) * kPoolHw + t % 3) * kPoolC, z);
#pragma unroll
          for (int e = 0; e < VEC; ++e) mx[e] = dl4j_nan::max_nan(mx[e], z[e]);
        }
        pack_store<T, VEC>(ms + wx * kPoolC + cv, mx);
      }
    }
  }
  __syncthreads();

  // the gather: each pixel of the tile takes g from the <= 4 windows
  // that cover it (p with |r - 2p| <= 1, q likewise) where its zc ties
  // their maximum, in the TPU kernel's order (the window offset r - 2p +
  // 1 ascending, then c - 2q + 1), masked by z0 > 0. A thread takes a
  // pair of pixels of one row, (r, 2q) and (r, 2q + 1): for each window
  // row p that covers r (p = (r + 1) / 2, then r / 2) it reads window (p,
  // q + 1), which covers the odd pixel only, then (p, q), which covers
  // both, each maximum and g once for the pair. The pairs of a row are
  // two warps, so a warp's window loops agree.
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s1[e] = s2[e] = 0.f;
  T* dzi = dz + static_cast<int64_t>(img) * ho * wo * k + ch0 + cv;
  if (on) {
    for (int it = slot; it < 2 * kPoolWh * kPoolWw; it += kPix) {
      const int lr = it / kPoolWw, b = it - lr * kPoolWw;
      const int r = 2 * p0 + lr, c = 2 * (q0 + b);
      if (r >= ho || c >= wo) continue;
      const bool odd_in = c + 1 < wo;     // the pair's second pixel
      const int hx = ((lr + 1) * kPoolHw + 2 * b + 1) * kPoolC + cv;
      float zc0[VEC], zc1[VEC], acc0[VEC], acc1[VEC];
      unpack<T, VEC>(zs + hx, zc0);
      unpack<T, VEC>(zs + hx + kPoolC, zc1);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc0[e] = acc1[e] = 0.f;
      for (int a = (lr + 1) >> 1; a >= (lr >> 1); --a) {
        if (p0 + a >= po) continue;
        const int wx = (a * kPoolMw + b) * kPoolC + cv;
        float mv[VEC], gv[VEC];
        if (q0 + b + 1 < pw) {
          unpack<T, VEC>(ms + wx + kPoolC, mv);
          unpack<T, VEC>(gs + wx + kPoolC, gv);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (zc1[e] == mv[e]) acc1[e] += gv[e];
        }
        unpack<T, VEC>(ms + wx, mv);
        unpack<T, VEC>(gs + wx, gv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (zc1[e] == mv[e]) acc1[e] += gv[e];
          if (zc0[e] == mv[e]) acc0[e] += gv[e];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !odd_in) break;
        float yf[VEC], out[VEC];
        unpack<T, VEC>(ys + hx + u * kPoolC, yf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float z0 = __fadd_rn(__fmul_rn(yf[e], sc[e]), bb[e]);
          out[e] = round_to<T>(z0 > 0.f ? (u ? acc1[e] : acc0[e]) : 0.f);
          s1[e] += out[e];
          s2[e] += out[e] * __fmul_rn(__fsub_rn(yf[e], mu[e]), inv[e]);
        }
        pack_store<T, VEC>(
            dzi + (static_cast<int64_t>(r) * wo + c + u) * k, out);
      }
    }
  }

  // the block's partial sums: the pixel slots reduced in order (the zc
  // tile, no longer read, holds them)
  __syncthreads();
  float* red = reinterpret_cast<float*>(zs);    // [2][kPix][kPoolC]
  if (on) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[slot * kPoolC + cv + e] = s1[e];
      red[(kPix + slot) * kPoolC + cv + e] = s2[e];
    }
  }
  __syncthreads();
  if (threadIdx.x < kc) {
    float a = 0.f, b = 0.f;
    for (int t = 0; t < kPix; ++t) {
      a += red[t * kPoolC + threadIdx.x];
      b += red[(kPix + t) * kPoolC + threadIdx.x];
    }
    const int64_t at =
        static_cast<int64_t>(ch0 + threadIdx.x) * tiles + blockIdx.x;
    part1[at] = a;
    part2[at] = b;
  }
}

template <typename T, int VEC>
int launch_bwd_pool(const T* y, const T* g, const float* aff, T* dz,
                    float* part1, float* part2, int ho, int wo, int k,
                    int po, int pw, int down, int across, int tiles,
                    dim3 grid, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  auto kernel = bwd_pool_kernel<T, VEC>;
  const int err = dl4j_mma::set_smem(kernel, pool_smem<T>(), granted);
  if (err) return err;
  kernel<<<grid, kPoolThreads, pool_smem<T>(), st>>>(
      y, g, aff, dz, part1, part2, ho, wo, k, po, pw, down, across, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The grid: n x down x across tiles of kPoolWh x kPoolWw pooled windows
// (stem.py's _stem_pool_plan mirrors it), ceil(K / 64) channel chunks;
// one partial per tile and channel in part1 / part2 [K, tiles]. Refuses
// partials short of the grid (before any launch).
template <typename T>
int stem_bwd_pool(const void* y, const void* g, const void* aff, void* dz,
                  void* part1, void* part2, void* s1, void* s2, int n,
                  int ho, int wo, int k, int tiles, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int po = (ho - 1) / 2 + 1;
  const int pw = (wo - 1) / 2 + 1;
  const int down = (po + kPoolWh - 1) / kPoolWh;
  const int across = (pw + kPoolWw - 1) / kPoolWw;
  const int64_t blocks = static_cast<int64_t>(n) * down * across;
  if (blocks > tiles || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  const bool vec = k % kVec == 0 && dl4j_mma::aligned16(y) &&
                   dl4j_mma::aligned16(g) && dl4j_mma::aligned16(dz);
  const dim3 grid(static_cast<unsigned>(blocks), (k + kPoolC - 1) / kPoolC);
  const T* yt = static_cast<const T*>(y);
  const T* gt = static_cast<const T*>(g);
  const float* af = static_cast<const float*>(aff);
  T* dzt = static_cast<T*>(dz);
  float* p1 = static_cast<float*>(part1);
  float* p2 = static_cast<float*>(part2);
  const int err =
      vec ? launch_bwd_pool<T, kVec>(yt, gt, af, dzt, p1, p2, ho, wo, k, po,
                                     pw, down, across, tiles, grid, st)
          : launch_bwd_pool<T, 1>(yt, gt, af, dzt, p1, p2, ho, wo, k, po,
                                  pw, down, across, tiles, grid, st);
  if (err != cudaSuccess) return err;
  dl4j_conv::reduce_partials_kernel<<<k, dl4j_conv::kReduceThreads, 0, st>>>(
      p1, p2, static_cast<int>(blocks), tiles, static_cast<float*>(s1),
      static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// the device kernels the weight gradient's launchers started, by kind:
// the dy pass, the CUDA-core GEMM, the tensor-core pass, the split
// reduction (read through dl4j_stem_bwd_dw_kernel_launches)
// ---------------------------------------------------------------------
enum DwKernel : int { kDyPass = 0, kDwGemm = 1, kDwTc = 2, kDwReduce = 3 };
int dw_launched[4] = {0, 0, 0, 0};

// ---------------------------------------------------------------------
// bwd_dw on the CUDA cores (f32; bf16 at 4 C > 16): the dy pass, then
// dW[r, kk] = sum_m A[r, m] dy[m, kk] over the output pixels m of one
// split; r = (tap, phase, c) of the s2d window, A = x at the pixel it
// reads (0 outside the image); partials [splits, 64 C, K]
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
  ++dw_launched[kDyPass];
  Geometry g{n, h, wd, c, ho, wo, k, 2, 64 * c, 0, 0};
  dim3 grid((g.r + kBM - 1) / kBM, (k + kBN - 1) / kBN, splits);
  dw_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<float*>(dw_part), g, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ++dw_launched[kDwGemm];
  const int red = dl4j_conv::reduce_splits(
      dw_part, splits, static_cast<int64_t>(g.r) * k, dw, st);
  if (!red) ++dw_launched[kDwReduce];
  return red;
}

// ---------------------------------------------------------------------
// bwd_dw, bf16 at 4 C <= 16 (RGB, RGBA): one pass on the tensor cores
// ---------------------------------------------------------------------
// dW row (tap (i, j), phase, c) is channel phase C + c of the s2d image
// at tap (i, j) (decode_r<kStemS2d>, stem.py's stem_weight_s2d), so dW of
// tap (i, j) = sum over the output pixels of s2d[oh + i, ow + j, :4C]^T
// dy[oh, ow, :]: a 16-tap conv's weight gradient whose taps read shifted
// windows of one s2d halo tile, each tap's 4C channels padded with zeros
// to 16 (one 32-byte row an s2d pixel, which ldmatrix takes).
namespace dw_tc {

using dl4j_mma::bf16;
using dl4j_mma::clamp8;
using dl4j_mma::copy8;
using dl4j_mma::cp_async_commit;
using dl4j_mma::cp_async_wait;
using dl4j_mma::kFragM;
using dl4j_mma::kFragN;
using dl4j_mma::smem_addr;

using dl4j_s2d::kHalo;
using dl4j_s2d::kHs;
using dl4j_s2d::kHw;
using dl4j_s2d::kMaxC;
using dl4j_s2d::kPatch;
using dl4j_s2d::kRawElems;
using dl4j_s2d::kTh;   // output patch: 8 rows ...
using dl4j_s2d::kTw;   // ... of 16 pixels, one k16 step
constexpr int kCols = 64;                // output channels a block owns
constexpr int kDs = kCols + 8;           // the dy tile's row stride
constexpr int kThreads = 256;            // 8 warps: 4 tap rows x 2 halves
constexpr int kStageElems = kRawElems + 2 * kPatch * kCols;
constexpr int kStages = dl4j_mma::stages_for(kStageElems * sizeof(bf16));
constexpr size_t kSmem =
    (static_cast<size_t>(kHalo) * kHs + kPatch * kDs) * sizeof(bf16) +
    5 * kCols * sizeof(float) +
    static_cast<size_t>(kStages) * kStageElems * sizeof(bf16);

struct Dw {
  int n, h, w, c;       // x [n, h, w, c]
  int ho, wo, k;        // y, dz, dy [n, ho, wo, k]
  int prow, pcol;       // patches an image: down, across
  int patches;          // n prow pcol
  int cols;             // column tiles of kCols output channels
  int slots;            // block rows: slot q walks patches q, q + slots, ..
  int vec;              // y, dz, dy: 16-byte copies and stores
  int vec_x;            // x 16-byte aligned: its rows by cp.async
  int x_elems;          // elements of x
};

// A block owns kCols output channels and walks its slot's patches of 8 x
// 16 output pixels; per patch, from a ring of kStages copies (the x rows
// under the patch's s2d halo, y and dz of its pixels, cp.async, copied
// kStages - 1 patches ahead): the s2d halo tile, rearranged from the raw
// rows (zeros outside the image and past 4C); dy = sc (dz - m1 - yhat
// m2), f32 op by op and rounded, into the B tile and stored; then 8 k16
// steps of warp_k16 (A = the halo's shifted window, B = dy, both stored
// [pixel][channel] and read with ldmatrix.trans). Warp (wm, wn) holds
// the taps (wm, 0..3) x columns 32 wn .. +32 in registers over all its
// patches, the tensor cores' sums promoted every patch (128 products)
// with round-to-nearest adds, and writes them once to its partials
// [slot, 64 C, K].
__global__ void __launch_bounds__(kThreads, 1)
    dw_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                 const bf16* __restrict__ dz,
                 const float* __restrict__ aff, bf16* __restrict__ dy,
                 float* __restrict__ part, Dw s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;   // the tap row i of the warp's four taps
  const int wn = warp & 1;    // its 32 columns
  const int slot = blockIdx.x / s.cols;
  const int k0 = (blockIdx.x - slot * s.cols) * kCols;
  const int mine = (s.patches - slot + s.slots - 1) / s.slots;
  const int per_img = s.prow * s.pcol;
  const bool vec = s.vec != 0;
  const dl4j_s2d::Src src{x, s.h, s.w, s.c, s.x_elems, s.vec_x};
  bf16* Hs = reinterpret_cast<bf16*>(smem);                  // [kHalo][kHs]
  bf16* Ds = Hs + kHalo * kHs;                               // [kPatch][kDs]
  float* Cs = reinterpret_cast<float*>(Ds + kPatch * kDs);   // [5][kCols]
  bf16* Ring = reinterpret_cast<bf16*>(Cs + 5 * kCols);      // [S][stage]

  // the image and first output row and column of patch p
  auto origin = [&](int p, int& img, int& oh0, int& ow0) {
    img = p / per_img;
    const int rem = p - img * per_img;
    const int pr = rem / s.pcol;
    oh0 = pr * kTh;
    ow0 = (rem - pr * s.pcol) * kTw;
  };
  // this thread's pixel items (y, dz, dy): pixel (tid >> 3) + 32 j of
  // the patch, channels ch .. ch + 8
  const int v = tid & 7;
  const int ch = k0 + 8 * v;
  const int dvalid = clamp8(s.k - ch);
  auto pixel = [&](int q, int img, int oh0, int ow0, int& off) {
    const int oh = oh0 + (q >> 4);
    const int ow = ow0 + (q & 15);
    const bool in = oh < s.ho && ow < s.wo;
    off = in ? ((img * s.ho + oh) * s.wo + ow) * s.k + ch : 0;
    return in;
  };
  auto issue = [&](int g) {   // one copy group, empty past the last
    if (g < mine) {
      bf16* st = Ring + (g % kStages) * kStageElems;
      int img, oh0, ow0;
      origin(slot + g * s.slots, img, oh0, ow0);
      // the x rows under the patch's s2d halo
      dl4j_s2d::issue_rows<kThreads>(st, src, img, oh0, ow0, tid);
      // y and dz of the patch's pixels (zeros outside the image)
      bf16* ry = st + kRawElems;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = (tid >> 3) + 32 * j;
        int off;
        const int valid = pixel(q, img, oh0, ow0, off) ? dvalid : 0;
        copy8(ry + q * kCols + 8 * v, y, off, valid, vec);
        copy8(ry + (kPatch + q) * kCols + 8 * v, dz, off, valid, vec);
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  // the dy constants of the block's columns: sc, inv, mu, m1, m2 (aff's
  // rows 0, 2, 3, 4, 5), 0 past K
  for (int i = tid; i < 5 * kCols; i += kThreads) {
    const int r = i / kCols;
    const int col = k0 + i - r * kCols;
    Cs[i] = col < s.k ? __ldg(aff + (r ? r + 1 : 0) * s.k + col) : 0.f;
  }
  // this thread's halo channels (dl4j_s2d::rearrange)
  int code[8];
  dl4j_s2d::channel_codes(s.c, tid & 1, code);

  // acc: the tensor cores' sums of this patch, whose accumulation rounds
  // toward zero; tot: the totals, promoted into every patch with f32 adds
  // (round to nearest)
  float acc[kFragM][kFragN][4], tot[kFragM][kFragN][4];
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][n][e] = tot[f][n][e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    const bf16* st = Ring + (i % kStages) * kStageElems;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // patch i copied; the last products done
    issue(i + kStages - 1);
    int img, oh0, ow0;
    origin(slot + i * s.slots, img, oh0, ow0);
    // the s2d halo tile of the patch
    dl4j_s2d::rearrange<kThreads>(Hs, st, code, src, img, oh0, ow0, tid);
    // dy of the patch's pixels: into the B tile (0 outside the image) and
    // stored
    {
      float cd[5][8];
#pragma unroll
      for (int r = 0; r < 5; ++r)
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(Cs + r * kCols + 8 * v + e);
          cd[r][e] = c4.x;
          cd[r][e + 1] = c4.y;
          cd[r][e + 2] = c4.z;
          cd[r][e + 3] = c4.w;
        }
      const bf16* ry = st + kRawElems;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = (tid >> 3) + 32 * j;
        int off;
        const bool in = pixel(q, img, oh0, ow0, off);
        const uint4 d = dl4j_mma::dy8(
            *reinterpret_cast<const uint4*>(ry + (kPatch + q) * kCols + 8 * v),
            *reinterpret_cast<const uint4*>(ry + q * kCols + 8 * v), cd,
            in ? dvalid : 0);
        *reinterpret_cast<uint4*>(Ds + q * kDs + 8 * v) = d;
        if (in && dvalid) dl4j_mma::store8(dy, off, dvalid, vec, d);
      }
    }
    __syncthreads();
    // the products: step ks is patch row ks; tap (wm, f) reads the halo
    // at (ks + wm, column + f)
#pragma unroll
    for (int ks = 0; ks < kTh; ++ks) {
      uint32_t a[kFragM], b[kFragN / 2];
#pragma unroll
      for (int f = 0; f < kFragM; ++f)
        a[f] = smem_addr(Hs +
                         ((ks + wm) * kHw + dl4j_mma::a_trans_k(lane) + f) *
                             kHs +
                         dl4j_mma::a_trans_r(lane));
#pragma unroll
      for (int h2 = 0; h2 < kFragN / 2; ++h2)
        b[h2] = smem_addr(Ds + (16 * ks + dl4j_mma::b_trans_k(lane)) * kDs +
                          wn * 32 + 16 * h2 + dl4j_mma::b_trans_n(lane));
      dl4j_mma::warp_k16<true, true>(acc, a, b);
    }
#pragma unroll
    for (int f = 0; f < kFragM; ++f)
#pragma unroll
      for (int n = 0; n < kFragN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[f][n][e] += acc[f][n][e];
          acc[f][n][e] = 0.f;
        }
  }

  // the block's partial: dW rows (tap, c16) for c16 < 4 C
  const int c4 = 4 * s.c;
  float* out = part + static_cast<int64_t>(slot) * 16 * c4 * s.k;
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c16 = (lane >> 2) + 8 * half;
        const int kk = k0 + wn * 32 + 8 * n + (lane & 3) * 2;
        if (c16 >= c4) continue;
        float* row = out + static_cast<int64_t>((4 * wm + f) * c4 + c16) * s.k;
        if (kk < s.k) row[kk] = tot[f][n][2 * half];
        if (kk + 1 < s.k) row[kk + 1] = tot[f][n][2 * half + 1];
      }
}

// The geometry and grid of the pass on a card of `sms` SMs: 8 x 16-pixel
// patches of each image, kCols-channel column tiles, and as many block
// rows as the card holds blocks (one an SM: the ring, its registers) over
// the column tiles, at most one a patch (stem.py's _stem_dw_plan mirrors
// it).
inline Dw geometry(int n, int h, int wd, int c, int k, int sms) {
  Dw s{};
  s.n = n;
  s.h = h;
  s.w = wd;
  s.c = c;
  s.ho = (h - 1) / 2 + 1;
  s.wo = (wd - 1) / 2 + 1;
  s.k = k;
  s.prow = (s.ho + kTh - 1) / kTh;
  s.pcol = (s.wo + kTw - 1) / kTw;
  s.patches = n * s.prow * s.pcol;
  s.cols = (k + kCols - 1) / kCols;
  const int q = sms / s.cols;
  s.slots = q < 1 ? 1 : q > s.patches ? s.patches : q;
  return s;
}

// The pass and its fixed-order split reduction. Refuses (before any
// launch) C outside 1 .. 4, `tiles` short of the grid's block rows, and
// any tensor of 2^31 - 1 elements or more (the kernel indexes with ints).
inline int launch(const void* x, const void* y, const void* dz,
                  const void* aff, void* dy, void* dw, void* dw_part, int n,
                  int h, int wd, int c, int k, int tiles, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(n) * ((h - 1) / 2 + 1) *
                       ((wd - 1) / 2 + 1);
  if (c < 1 || c > kMaxC ||
      static_cast<int64_t>(n) * h * wd * c >= INT_MAX ||
      rows * k >= INT_MAX || static_cast<int64_t>(64) * c * k >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Dw s = geometry(n, h, wd, c, k, sms);
  if (tiles < s.slots) return static_cast<int>(cudaErrorInvalidValue);
  if (s.patches == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  s.vec = k % 8 == 0 && dl4j_mma::aligned16(y) && dl4j_mma::aligned16(dz) &&
          dl4j_mma::aligned16(dy);
  s.vec_x = dl4j_mma::aligned16(x);
  s.x_elems = n * h * wd * c;
  static size_t granted = 0;
  int err = dl4j_mma::set_smem(dw_tc_kernel, kSmem, granted);
  if (err) return err;
  dw_tc_kernel<<<static_cast<unsigned>(s.slots) * s.cols, kThreads, kSmem,
                 st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<const bf16*>(dz), static_cast<const float*>(aff),
      static_cast<bf16*>(dy), static_cast<float*>(dw_part), s);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ++dw_launched[kDwTc];
  err = dl4j_conv::reduce_splits(dw_part, s.slots,
                                 static_cast<int64_t>(64) * c * k, dw, st);
  if (!err) ++dw_launched[kDwReduce];
  return err;
}

}  // namespace dw_tc

// ---------------------------------------------------------------------
// the device kernels the input gradient's launchers started, by kind:
// the CUDA-core pass, the tensor-core pass (read through
// dl4j_stem_bwd_dx_kernel_launches)
// ---------------------------------------------------------------------
enum DxKernel : int { kDxCuda = 0, kDxTc = 1 };
int dx_launched[2] = {0, 0};

// ---------------------------------------------------------------------
// bwd_dx, bf16 at 4 C <= 16 and K <= 64: on the tensor cores
// ---------------------------------------------------------------------
// In s2d coordinates dx is a 16-tap conv: dS[u, v, :4C] = sum over the
// taps (i, j) of dy[u - i, v - j, :K] W_tap^T, W_tap the tap's [4C, K]
// block of the s2d weight. A GEMM of M = the s2d pixels, N = 4 C padded
// to 16, a reduction of 16 taps x K (K <= 64, padded to 64).
namespace dx_tc {

using dl4j_mma::bf16;
using dl4j_mma::copy8;
using dl4j_mma::cp_async_commit;
using dl4j_mma::cp_async_wait;
using dl4j_mma::ldsm_x4;
using dl4j_mma::mma_16816;
using dl4j_mma::smem_addr;

constexpr int kRows = 3;                 // patch rows a warp owns
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;    // 256
constexpr int kTh = kRows * kWarps;      // s2d output patch: 24 rows ...
constexpr int kTw = 16;                  // ... of 16 pixels (one m16 row)
constexpr int kHh = kTh + 3;             // the dy halo the 4x4 taps read:
constexpr int kHw = kTw + 3;             //   27 x 19 pixels
constexpr int kHalo = kHh * kHw;
constexpr int kK = 64;                   // dy channels staged (K <= 64)
constexpr int kHs = kK + 8;              // a halo pixel: 144 bytes (no
                                         // ldmatrix bank conflicts)
constexpr int kN = 16;                   // the 4 C outputs, padded
constexpr int kWs = kK + 8;              // a weight row (tap, output)
constexpr int kMaxC = 4;                 // 4 C <= 16
constexpr int kXr = 2 * kTh;             // the patch's dx: 48 rows ...
constexpr int kXc = 2 * kTw;             // ... of 32 pixels
constexpr int kStageElems = kHalo * kHs;
constexpr int kStages = 2;               // one patch copied ahead (three
                                         // stages do not fit)
constexpr size_t kSmem =
    (static_cast<size_t>(16) * kN * kWs + kXr * kXc * kMaxC +
     static_cast<size_t>(kStages) * kStageElems) *
    sizeof(bf16);

struct Dx {
  int n, h, w;          // dx [n, h, w, C]
  int ho, wo, k;        // dy [n, ho, wo, k]
  int prow, pcol;       // patches of the s2d grid an image: down, across
  int patches;          // n prow pcol
  int slots;            // blocks: block q walks patches q, q + slots, ..
  int vec;              // dy: 16-byte copies
};

// A block keeps the whole s2d weight in shared memory (B, [tap][4 C ->
// 16][k], zeros past 4 C and K) and walks its slot's patches of 24 x 16
// s2d pixels (the pixels (u, v), 1 <= u <= (h + 2) / 2, that touch the
// image); per patch, from a ring of kStages copies (the dy halo under
// the patch, cp.async, kStages - 1 patches ahead), warp w computes patch
// rows 3 w .. 3 w + 2 against all 16 columns: for each tap column j and
// k16 step it loads the four tap rows' B fragments once and the six
// halo rows 3 w .. 3 w + 5 (A, [pixel][k], shifted j to the left) once
// each, and halo row 3 w + t is tap row i = e + 3 - t of patch row 3 w +
// e: 24 products from 10 ldmatrix. The tensor cores' sums of a (j, k16)
// step are promoted into the f32 totals with round-to-nearest adds. The
// epilogue un-shuffles the patch's 48 x 32 x C dx values into shared
// memory and stores them as whole row segments, cropped to the image.
// C, the input channels, is a template parameter: the un-shuffle and the
// crop divide by it.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    dx_tc_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, Dx s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int c4 = 4 * C;
  const int mine = (s.patches - static_cast<int>(blockIdx.x) + s.slots - 1) /
                   s.slots;
  const int per_img = s.prow * s.pcol;
  const bool vec = s.vec != 0;
  bf16* Ws = reinterpret_cast<bf16*>(smem);        // [16][kN][kWs]
  bf16* Xs = Ws + 16 * kN * kWs;                    // [kXr][kXc C]
  bf16* Ring = Xs + kXr * kXc * kMaxC;              // [S][kHalo][kHs]

  // the image and first s2d row and column of patch p
  auto origin = [&](int p, int& img, int& u0, int& v0) {
    img = p / per_img;
    const int rem = p - img * per_img;
    const int pr = rem / s.pcol;
    u0 = 1 + pr * kTh;
    v0 = 1 + (rem - pr * s.pcol) * kTw;
  };
  auto issue = [&](int g) {   // one copy group, empty past the last
    if (g < mine) {
      bf16* st = Ring + (g % kStages) * kStageElems;
      int img, u0, v0;
      origin(static_cast<int>(blockIdx.x) + g * s.slots, img, u0, v0);
      // halo pixel (hu, hv) is dy[u0 - 3 + hu, v0 - 3 + hv] (zeros
      // outside dy and past K), 8 channels an item (not unrolled: the
      // registers go to the products)
#pragma unroll 1
      for (int it = tid; it < kHalo * 8; it += kThreads) {
        const int hp = it >> 3;
        const int ch = 8 * (it & 7);
        const int hu = hp / kHw;
        const int du = u0 - 3 + hu;
        const int dv = v0 - 3 + hp - hu * kHw;
        const bool in = du >= 0 && du < s.ho && dv >= 0 && dv < s.wo;
        const int valid = in ? dl4j_mma::clamp8(s.k - ch) : 0;
        copy8(st + hp * kHs + ch, dy,
              in ? ((img * s.ho + du) * s.wo + dv) * s.k + ch : 0, valid,
              vec);
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  // the weight, once: row (tap, o) of tap-major w [16 4C, K], zeros past
  // 4 C and K
  for (int i = tid; i < 16 * kN * kK; i += kThreads) {
    const int kk = i % kK;
    const int row = i / kK;             // tap kN + o
    const int tap = row / kN;
    const int o = row - tap * kN;
    Ws[row * kWs + kk] = (o < c4 && kk < s.k)
                             ? w[(tap * c4 + o) * s.k + kk]
                             : __float2bfloat16(0.f);
  }

  const int r0 = kRows * warp;   // the warp's first patch row
  for (int i = 0; i < mine; ++i) {
    const bf16* Hs = Ring + (i % kStages) * kStageElems;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // patch i copied; the last patch's dx stored
    issue(i + kStages - 1);
    int img, u0, v0;
    origin(static_cast<int>(blockIdx.x) + i * s.slots, img, u0, v0);

    // acc: the tensor cores' sums of one (j, k16) step, whose
    // accumulation rounds toward zero; tot: the totals, promoted into
    // with f32 adds (round to nearest)
    float tot[kRows][2][4];
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[e][n][q] = 0.f;
    // the tap columns one at a time: unrolled, the compiler hoists the
    // whole sequence's fragments and spills
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        uint32_t bfr[4][4];   // tap rows i = 0..3 of column j
#pragma unroll
        for (int ti = 0; ti < 4; ++ti)
          ldsm_x4<false>(smem_addr(Ws + ((ti * 4 + j) * kN +
                                         dl4j_mma::b_n(lane)) * kWs +
                                   16 * ks + dl4j_mma::b_k(lane)),
                         bfr[ti]);
        float acc[kRows][2][4];
#pragma unroll
        for (int e = 0; e < kRows; ++e)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[e][n][q] = 0.f;
#pragma unroll
        for (int t = 0; t < kRows + 3; ++t) {
          uint32_t af[4];
          ldsm_x4<false>(smem_addr(Hs + ((r0 + t) * kHw + (lane & 15) + 3 -
                                         j) * kHs +
                                   16 * ks + dl4j_mma::a_k(lane)),
                         af);
#pragma unroll
          for (int e = 0; e < kRows; ++e) {
            const int ti = e + 3 - t;
            if (ti < 0 || ti > 3) continue;
            mma_16816(acc[e][0], af, bfr[ti][0], bfr[ti][1]);
            mma_16816(acc[e][1], af, bfr[ti][2], bfr[ti][3]);
          }
        }
#pragma unroll
        for (int e = 0; e < kRows; ++e)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) tot[e][n][q] += acc[e][n][q];
      }
    }

    // the un-shuffle: output o = phase C + channel of s2d pixel (pu, pv)
    // is dx pixel (2 pu + phase / 2, 2 pv + phase % 2) of the patch
    constexpr int xrow = kXc * C;
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int o = 8 * n + 2 * (lane & 3) + (q & 1);
          if (o >= c4) continue;
          const int pv = (lane >> 2) + 8 * (q >> 1);
          const int phase = o / C;
          const int cc = o - phase * C;
          Xs[(2 * (r0 + e) + (phase >> 1)) * xrow +
             (2 * pv + (phase & 1)) * C + cc] =
              __float2bfloat16(tot[e][n][q]);
        }
    __syncthreads();
    // the crop: patch row lr is dx row 2 u0 - 3 + lr, column lc dx
    // column 2 v0 - 3 + lc
    const int xr0 = 2 * u0 - 3;
    const int xc0 = 2 * v0 - 3;
#pragma unroll 1
    for (int it = tid; it < kXr * xrow; it += kThreads) {
      const int lr = it / xrow;
      const int rem = it - lr * xrow;
      const int lc = rem / C;
      const int xr = xr0 + lr;
      const int xc = xc0 + lc;
      if (xr < 0 || xr >= s.h || xc < 0 || xc >= s.w) continue;
      dx[((img * s.h + xr) * s.w + xc) * C + rem - lc * C] = Xs[it];
    }
  }
}

// The geometry and grid on a card of `sms` SMs: 24 x 16 patches of the
// s2d pixels that touch the image, and the fewest blocks (one an SM: the
// ring and the weight) that walk them in the fewest rounds (stem.py's
// _stem_dx_plan mirrors it).
inline Dx geometry(int n, int h, int wd, int k, int sms) {
  Dx s{};
  s.n = n;
  s.h = h;
  s.w = wd;
  s.ho = (h - 1) / 2 + 1;
  s.wo = (wd - 1) / 2 + 1;
  s.k = k;
  s.prow = (((h + 2) >> 1) + kTh - 1) / kTh;
  s.pcol = (((wd + 2) >> 1) + kTw - 1) / kTw;
  s.patches = n * s.prow * s.pcol;
  const int rounds = (s.patches + sms - 1) / sms;
  s.slots = rounds > 0 ? (s.patches + rounds - 1) / rounds : 0;
  return s;
}

// Refuses (before any launch) C outside 1 .. 4, K outside 1 .. 64, and
// any tensor of 2^31 - 1 elements or more (the kernel indexes with ints).
inline int launch(const void* dy, const void* w, void* dx, int n, int h,
                  int wd, int c, int k, cudaStream_t st) {
  const int64_t dy_elems = static_cast<int64_t>(n) * ((h - 1) / 2 + 1) *
                           ((wd - 1) / 2 + 1) * k;
  if (c < 1 || c > kMaxC || k < 1 || k > kK ||
      static_cast<int64_t>(n) * h * wd * c >= INT_MAX ||
      dy_elems >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  Dx s = geometry(n, h, wd, k, sms);
  if (s.patches == 0) return static_cast<int>(cudaGetLastError());
  s.vec = k % 8 == 0 && dl4j_mma::aligned16(dy);
  static size_t granted[kMaxC] = {0, 0, 0, 0};
  auto kernel = c == 1 ? dx_tc_kernel<1>
                : c == 2 ? dx_tc_kernel<2>
                : c == 3 ? dx_tc_kernel<3>
                         : dx_tc_kernel<4>;
  int err = dl4j_mma::set_smem(kernel, kSmem, granted[c - 1]);
  if (err) return err;
  kernel<<<static_cast<unsigned>(s.slots), kThreads, kSmem, st>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), s);
  err = static_cast<int>(cudaGetLastError());
  if (!err) ++dx_launched[kDxTc];
  return err;
}

}  // namespace dx_tc

// ---------------------------------------------------------------------
// bwd_dx on the CUDA cores (f32; bf16 at 4 C > 16 or K > 64)
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
  err = cudaGetLastError();
  if (err == cudaSuccess) ++dx_launched[kDxCuda];
  return static_cast<int>(err);
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

int dl4j_stem_bwd_dw_bf16_mma(const void* x, const void* y, const void* dz,
                              const void* aff, void* dy, void* dw,
                              void* dw_part, int n, int h, int wd, int c,
                              int k, int tiles, void* stream) {
  return dw_tc::launch(x, y, dz, aff, dy, dw, dw_part, n, h, wd, c, k, tiles,
                       static_cast<cudaStream_t>(stream));
}

int dl4j_stem_bwd_dx_f32(const void* dy, const void* w, void* dx, int n,
                         int h, int wd, int c, int k, void* stream) {
  return stem_bwd_dx<float>(dy, w, dx, n, h, wd, c, k, stream);
}

int dl4j_stem_bwd_dx_bf16(const void* dy, const void* w, void* dx, int n,
                          int h, int wd, int c, int k, void* stream) {
  return stem_bwd_dx<__nv_bfloat16>(dy, w, dx, n, h, wd, c, k, stream);
}

int dl4j_stem_bwd_dx_bf16_mma(const void* dy, const void* w, void* dx,
                              int n, int h, int wd, int c, int k,
                              void* stream) {
  return dx_tc::launch(dy, w, dx, n, h, wd, c, k,
                       static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory the pool backward launches with, f32
// and bf16 (out[2]).
int dl4j_stem_bwd_pool_smem(int* out) {
  out[0] = static_cast<int>(pool_smem<float>());
  out[1] = static_cast<int>(pool_smem<__nv_bfloat16>());
  return 0;
}

// The weight gradient's device kernels started so far, by kind (out[4]:
// the dy pass, the CUDA-core GEMM, the tensor-core pass, the split
// reduction): what one call of each route launches.
int dl4j_stem_bwd_dw_kernel_launches(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = dw_launched[i];
  return 0;
}

// The input gradient's device kernels started so far, by kind (out[2]:
// the CUDA-core pass, the tensor-core pass).
int dl4j_stem_bwd_dx_kernel_launches(int* out) {
  for (int i = 0; i < 2; ++i) out[i] = dx_launched[i];
  return 0;
}

// Bytes of dynamic shared memory the bf16 dW pass launches with.
int dl4j_stem_bwd_dw_tc_smem() { return static_cast<int>(dw_tc::kSmem); }

// Bytes of dynamic shared memory the bf16 dx pass launches with.
int dl4j_stem_bwd_dx_tc_smem() { return static_cast<int>(dx_tc::kSmem); }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
