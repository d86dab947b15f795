// The fused ResNet stem's forward, for Hopper (sm_90a): the 7x7/2 conv
// as one GEMM over the space-to-depth im2col, with the per-channel sum /
// sum-of-squares epilogue, and the output stage (BN affine, relu, 3x3/2
// pad-1 max pool) in one read of the conv output.
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/stem.py:
//   stem_conv <- `_stem_conv_kernel` (pallas_call in `_conv_stats`)
//   stem_pool <- `_stem_pool_kernel` (pallas_call in `_pool`)
// stem_conv computes y = s2d-im2col(x) rounded to w's dtype, times the
// [64C, K] contraction matrix of `stem_weight_s2d`, accumulated in f32,
// rounded to x's dtype; sum y and sum y^2 over the stored values.
// stem_pool computes max over the 3x3/2 window (padding -inf, after the
// relu) of relu(y sc + bb) in f32, stored in y's dtype.
//
// Translation. The TPU kernel materializes each image's padded
// space-to-depth grid and its [ho wo, 64C] im2col in VMEM. Here no s2d
// tensor or im2col reaches device memory, and pixels of the padding read
// 0. The conv has two routes (stem.py's stem_conv_route):
//   - bf16 at 4 C <= 16 (RGB or RGBA input, the main path's C = 3) runs
//     on the tensor cores (conv_tc below). In s2d coordinates the conv is
//     a 16-tap conv, y[oh, ow, :K] = sum over the taps (i, j) of s2d[oh +
//     i, ow + j, :4C] W_tap(i, j), each tap one k16 step of mma.sync
//     m16n8k16 (its 4C channels padded with zeros to 16). A persistent
//     block (two an SM) keeps the whole s2d weight in shared memory (16
//     taps x 16 x 64 bf16) and walks 8 x 16-pixel output patches: a
//     cp.async ring stages the raw x rows under the next patches' s2d
//     halo while this one multiplies; the rows are rearranged into the
//     padded 16-channel s2d halo tile (stem_s2d.cuh, shared with the
//     weight gradient's kernel); each tap's A rows are a shifted
//     ldmatrix window of the tile, a warp loading each halo row once for
//     the tap rows of its four patch rows. The tensor cores' sums of a
//     tap column (4 taps) are promoted into the f32 totals with
//     round-to-nearest adds (their own accumulation rounds toward zero).
//     The epilogue rounds the patch to bf16 through shared memory and
//     stores whole 128-byte pixel rows, and sums the stored values per
//     channel in registers over the block's patches: one partial a
//     block, reduced by conv_gemm.cuh's fixed-order f64 pass (the same
//     bits on every run, no atomics);
//   - f32, and wider inputs, take the implicit GEMM of conv_gemm.cuh
//     (mode kStemS2d), which gathers the A tiles element by element from
//     the raw NHWC image and multiplies on the f32 CUDA cores.
// The pool (fwd_pool below) reads y once and never forms relu(y sc + bb)
// for a pixel: for finite sc that function of y is monotone in f32
// (multiply, then add, each rounded to nearest: non-decreasing for sc >=
// 0, non-increasing for sc <= 0), so a window's largest relu value is
// relu(max(z(max y), z(min y))), z(v) = v sc + bb, bit-equal to taking
// it pixel by pixel for every sign of sc. The window's raw maximum and
// minimum are NaN-propagating (bf16 pairs: __hmax2_nan / __hmin2_nan;
// f32: max.NaN / min.NaN), so a NaN anywhere in a window gives NaN, and
// with sc = 0 a +-inf (0 inf is NaN) does too, at whichever extreme it
// sits, as the plain version's torch.maximum and the JAX kernel's
// jnp.maximum give. Each warp owns 4 pooled columns (a lane group of 8
// each, 8 bf16 or 4 f32 channels a lane: 16-byte loads and stores) of a
// strip of 8 pooled rows of one image and walks it down: pooled row p
// reads image rows 2p and 2p + 1 (each row's 2q, 2q + 1 columns; 2q - 1
// is the left lane group's 2q + 1, shuffled, the warp's first group
// loading it) and keeps row 2p + 1's reduction for p + 1. The window is
// separable: each row is reduced over its three columns, then the three
// rows. Where K is no whole number of 16-byte vectors, or y or the
// output is not 16-byte aligned, the same walk goes element by element
// (a lane one channel).
//
// What bounds it on an H100. At B=128, 224x224x3, K=64 in bf16 the conv
// reads 38.5 MB and writes 206 MB for 30.2 GFLOP (39.5 with the
// zero-weighted taps of the 8x8-extended kernel, 52.6 with the four zero
// channels of each tap the tensor cores multiply): 0.073 ms of bytes
// against 0.053 ms of padded tensor-core flops at 989 TFLOP/s, so bytes.
// What holds the tensor-core route back in practice: mma.sync's rate
// below wgmma's, the ldmatrix reads of the halo (each tap row a window
// read again), and each patch's rearrangement, products and stores in
// turn (three barriers a patch), which the second block of an SM
// overlaps. The f32 route is bound by the f32 FMA rate (19.7 G
// multiply-adds at B=128). The pool reads those 206 MB and writes 51 MB,
// 0.077 ms: bytes. Taken pixel by pixel in each window (a thread an
// output: nine 2-byte loads, each y element loaded and transformed 2.25
// times on average, 231 M loads at B=128) it is bound by instructions
// instead. Here a y element is loaded once, as part of a
// 16-byte vector; the re-reads are the strips' halo rows (one image row
// in 16, 6.25% more rows, read about when the strip above reads them, so
// from L2) and the warps' first columns (one 16-byte load in 8 more,
// the neighbouring warp's, from L1 or L2); the affine runs twice an
// output (0.5 a y element), the window's comparisons 6 bf16 pair
// operations a pair of outputs. What is left is the stream itself: 8
// warps a block, 40-odd warps an SM keeping 2-3 KB of loads each in
// flight.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <climits>
#include <cmath>

#include "conv_gemm.cuh"
#include "conv_mma.cuh"
#include "stem_s2d.cuh"

namespace {

using dl4j_conv::Geometry;
using dl4j_conv::from_f32;
using dl4j_conv::to_f32;

// ---------------------------------------------------------------------
// stem_pool: a strip walk over the raw y, its window max and min once
// ---------------------------------------------------------------------
namespace fwd_pool {

constexpr int kThreads = 256;           // 8 warps
constexpr int kLanes = 8;               // lanes a pixel, VEC channels each
constexpr int kCols = 32 / kLanes;      // pooled columns a warp: 4
constexpr int kRows = 8;                // pooled rows a warp walks

// the pool's device kernels started so far, by route: the 16-byte route,
// the element route (read through dl4j_stem_pool_kernel_launches)
enum Route : int { kVector = 0, kElement = 1 };
int launched[2] = {0, 0};

struct Pool {
  int ho, wo, k;        // y [n, ho, wo, k]
  int po, pw;           // out [n, po, pw, k]
  int strips;           // row strips an image: ceil(po / kRows)
  int quads;            // column quads a pooled row: ceil(pw / kCols)
  int warps;            // n strips quads: one a (strip, quad)
};

// VEC channels of one pixel: one 16-byte access where VEC sizeof(T) is
// 16, one element where VEC is 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
constexpr bool kBf16x8 = sizeof(T) == 2 && VEC == 8;

// The NaN-propagating maximum and minimum (nan_max.cuh): fmaxf and fminf
// return the other operand where one is NaN, which the JAX kernel's
// jnp.maximum and the plain version's torch.maximum do not.
using dl4j_nan::max_nan;
using dl4j_nan::min_nan;

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> vmax(Pack<T, VEC> a,
                                             Pack<T, VEC> b) {
  if constexpr (kBf16x8<T, VEC>) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(a.v);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(b.v);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __hmax2_nan(x[e], y[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      a.v[e] = from_f32<T>(max_nan(to_f32(a.v[e]), to_f32(b.v[e])));
  }
  return a;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> vmin(Pack<T, VEC> a,
                                             Pack<T, VEC> b) {
  if constexpr (kBf16x8<T, VEC>) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(a.v);
    const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(b.v);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __hmin2_nan(x[e], y[e]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      a.v[e] = from_f32<T>(min_nan(to_f32(a.v[e]), to_f32(b.v[e])));
  }
  return a;
}

// A pack from the lane `kLanes` below (the pooled column to the left).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> from_left(Pack<T, VEC> p) {
  constexpr int kWords = (sizeof(p) + 3) / 4;
  uint32_t w[kWords] = {};
  memcpy(w, &p, sizeof(p));
#pragma unroll
  for (int e = 0; e < kWords; ++e)
    w[e] = __shfl_up_sync(0xffffffffu, w[e], kLanes);
  memcpy(&p, w, sizeof(p));
  return p;
}

// One image row's horizontal maximum and minimum over the thread's
// window columns 2q - 1, 2q, 2q + 1. Column 2q is in the image for
// every pooled column q; 2q - 1 is the left neighbour's 2q + 1, taken
// from its lanes (the warp's first column loads it, where q > 0); a
// column outside the image is replaced by column 2q, which changes
// neither extreme.
template <typename T, int VEC>
struct Row {
  Pack<T, VEC> hi, lo;
};

// Loads (all started before any use) of one row: columns 2q, 2q + 1 and,
// for the warp's first pooled column, 2q - 1.
template <typename T, int VEC>
struct Raw {
  Pack<T, VEC> a, b, c;
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_row(const T* row, int k, bool on,
                                                bool first, bool has_a,
                                                bool has_c) {
  using P = Pack<T, VEC>;
  Raw<T, VEC> r;
  if (on) {
    r.b = *reinterpret_cast<const P*>(row);
    r.c = has_c ? *reinterpret_cast<const P*>(row + k) : r.b;
    r.a = first && has_a ? *reinterpret_cast<const P*>(row - k) : r.b;
  } else {
    r.a = r.b = r.c = P{};
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ Row<T, VEC> reduce_row(Raw<T, VEC> r, bool first,
                                                  bool has_a) {
  const Pack<T, VEC> left = from_left(r.c);
  const Pack<T, VEC> a = first ? r.a : has_a ? left : r.b;
  return {vmax(vmax(a, r.b), r.c), vmin(vmin(a, r.b), r.c)};
}

// A warp owns pooled columns 4 u .. 4 u + 3 (u: its quad) of a strip of
// kRows pooled rows of one image, and one chunk of kLanes VEC channels
// (blockIdx.y); lane group g = lane / kLanes takes column q = 4 u + g,
// lane % kLanes its VEC channels. Walking the strip down, pooled row p
// needs image rows 2p - 1, 2p, 2p + 1: the row 2p - 1 is the last
// iteration's 2p + 1 (kept in registers; at the strip's first row it is
// the halo row, loaded), so each image row is read once, the halo row
// twice (once a strip). Each row is reduced across its three window
// columns, then the three rows, giving the raw window maximum and
// minimum (NaN-propagating). relu(y sc + bb) in f32 is monotone in y
// (non-decreasing for sc >= 0, non-increasing for sc <= 0; with sc = 0
// a +-inf gives NaN, at whichever extreme it sits), so the window's
// largest value is relu(max(z(hi), z(lo))) exactly: the affine twice an
// output, the result rounded to T once.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
    fwd_pool_kernel(const T* __restrict__ y, const float* __restrict__ sc,
                    const float* __restrict__ bb, T* __restrict__ out,
                    Pool s) {
  using P = Pack<T, VEC>;
  // the chunk's sc and bb, read by each output (registers are what
  // limits the warps an SM keeps loading)
  __shared__ __align__(16) float aff[2][kLanes * VEC];
  const int c0 = blockIdx.y * kLanes * VEC;
  for (int t = threadIdx.x; t < kLanes * VEC; t += kThreads) {
    const bool ok = c0 + t < s.k;
    aff[0][t] = ok ? sc[c0 + t] : 0.f;
    aff[1][t] = ok ? bb[c0 + t] : 0.f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (gw >= s.warps) return;            // a whole warp: shuffles stay full
  const int quad = gw % s.quads;
  const int rest = gw / s.quads;
  const int strip = rest % s.strips;
  const int img = rest / s.strips;
  const int grp = lane / kLanes;
  const int q = quad * kCols + grp;
  const int cl = (lane % kLanes) * VEC;   // the lane's first channel
  const int cv = c0 + cl;
  // the thread's outputs exist (the 16-byte route: K a whole number of
  // vectors, so all VEC of them)
  const bool on = q < s.pw && cv < s.k;
  const bool first = grp == 0;
  const bool has_a = q > 0;
  const bool has_c = 2 * q + 1 < s.wo;
  const int64_t pitch = static_cast<int64_t>(s.wo) * s.k;
  const T* yc = y + static_cast<int64_t>(img) * s.ho * pitch +
                static_cast<int64_t>(2 * q) * s.k + cv;
  T* oc = out + (static_cast<int64_t>(img) * s.po * s.pw + q) * s.k + cv;
  const int p0 = strip * kRows;
  const int p1 = min(p0 + kRows, s.po);

  Row<T, VEC> up{};                      // image row 2p - 1, reduced
  if (p0 > 0)
    up = reduce_row<T, VEC>(
        load_row<T, VEC>(yc + (2 * p0 - 1) * pitch, s.k, on, first, has_a,
                         has_c),
        first, has_a);
  for (int p = p0; p < p1; ++p) {
    const bool has_dn = 2 * p + 1 < s.ho;
    const Raw<T, VEC> r0 =
        load_row<T, VEC>(yc + 2 * p * pitch, s.k, on, first, has_a, has_c);
    const Raw<T, VEC> r1 =
        has_dn ? load_row<T, VEC>(yc + (2 * p + 1) * pitch, s.k, on, first,
                                  has_a, has_c)
               : r0;
    const Row<T, VEC> mid = reduce_row(r0, first, has_a);
    const Row<T, VEC> dn = has_dn ? reduce_row(r1, first, has_a) : mid;
    const Row<T, VEC> u = p > 0 ? up : mid;
    const P hi = vmax(vmax(u.hi, mid.hi), dn.hi);
    const P lo = vmin(vmin(u.lo, mid.lo), dn.lo);
    up = dn;
    if (!on) continue;
    float res[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a = aff[0][cl + e], b = aff[1][cl + e];
      const float z1 = __fadd_rn(__fmul_rn(to_f32(hi.v[e]), a), b);
      const float z2 = __fadd_rn(__fmul_rn(to_f32(lo.v[e]), a), b);
      res[e] = max_nan(max_nan(z1, z2), 0.f);
    }
    T* o = oc + static_cast<int64_t>(p) * s.pw * s.k;
    if constexpr (kBf16x8<T, VEC>) {
      *reinterpret_cast<uint4*>(o) = dl4j_mma::pack8(res);
    } else {
      P v;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v.v[e] = from_f32<T>(res[e]);
      *reinterpret_cast<P*>(o) = v;
    }
  }
}

// The grid (stem.py's _stem_fwd_pool_plan mirrors it): one warp a strip
// of kRows pooled rows by kCols pooled columns of an image, 8 warps a
// block along (image, strip, quad), quads fastest; grid.y the chunks of
// kLanes VEC channels.
inline Pool geometry(int n, int ho, int wo, int k, int64_t* warps) {
  Pool s{};
  s.ho = ho;
  s.wo = wo;
  s.k = k;
  s.po = (ho - 1) / 2 + 1;
  s.pw = (wo - 1) / 2 + 1;
  s.strips = (s.po + kRows - 1) / kRows;
  s.quads = (s.pw + kCols - 1) / kCols;
  *warps = static_cast<int64_t>(n) * s.strips * s.quads;
  return s;
}

inline dim3 grid_of(const Pool& s, int vec) {
  const int per = kThreads / 32;
  return dim3(static_cast<unsigned>(
                  (static_cast<int64_t>(s.warps) + per - 1) / per),
              static_cast<unsigned>((s.k + kLanes * vec - 1) /
                                    (kLanes * vec)));
}

template <typename T, int VEC>
int launch(const T* y, const float* sc, const float* bb, T* out,
           const Pool& s, cudaStream_t st) {
  const dim3 grid = grid_of(s, VEC);
  fwd_pool_kernel<T, VEC><<<grid, kThreads, 0, st>>>(y, sc, bb, out, s);
  const int err = static_cast<int>(cudaGetLastError());
  if (!err) ++launched[VEC > 1 ? kVector : kElement];
  return err;
}

// The 16-byte route where K is a whole number of 16-byte vectors and y
// and out are 16-byte aligned, else the element route. Refuses (before
// any launch) 2^31 - 1 warps or more (the kernel's warp index is an
// int).
template <typename T>
int stem_pool(const void* y, const void* sc, const void* bb, void* out,
              int n, int ho, int wo, int k, void* stream) {
  int64_t warps = 0;
  Pool s = geometry(n, ho, wo, k, &warps);
  if (warps == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  if (warps >= INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  s.warps = static_cast<int>(warps);
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  const float* s_ = static_cast<const float*>(sc);
  const float* b_ = static_cast<const float*>(bb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k % kVec == 0 && dl4j_mma::aligned16(y) && dl4j_mma::aligned16(out))
    return launch<T, kVec>(yt, s_, b_, ot, s, st);
  return launch<T, 1>(yt, s_, b_, ot, s, st);
}

}  // namespace fwd_pool

// ---------------------------------------------------------------------
// the device kernels the conv's launchers started, by kind: the CUDA-core
// GEMM, the tensor-core pass (read through dl4j_stem_conv_kernel_launches)
// ---------------------------------------------------------------------
enum ConvKernel : int { kConvCuda = 0, kConvTc = 1 };
int conv_launched[2] = {0, 0};

// ---------------------------------------------------------------------
// stem_conv, bf16 at 4 C <= 16: on the tensor cores
// ---------------------------------------------------------------------
namespace conv_tc {

using dl4j_mma::bf16;
using dl4j_mma::cp_async_commit;
using dl4j_mma::cp_async_wait;
using dl4j_mma::ldsm_x4;
using dl4j_mma::mma_16816;
using dl4j_mma::smem_addr;
using dl4j_s2d::kHalo;
using dl4j_s2d::kHs;
using dl4j_s2d::kHw;
using dl4j_s2d::kMaxC;
using dl4j_s2d::kPatch;
using dl4j_s2d::kRawElems;
using dl4j_s2d::kTh;
using dl4j_s2d::kTw;

constexpr int kCols = 64;                // output channels a block owns
constexpr int kThreads = 128;            // 4 warps: 2 row halves x 2
                                         // column halves
constexpr int kRows = 4;                 // patch rows a warp owns
constexpr int kWs = kCols + 8;           // a weight row (tap, channel):
                                         // 144 bytes
constexpr int kOs = kCols + 8;           // the output tile's row stride
constexpr int kStages = 3;               // two patches copied ahead
constexpr int kGroups = kThreads / 8;    // the epilogue's row groups
constexpr size_t kSmem =
    (static_cast<size_t>(kHalo) * kHs + 16 * 16 * kWs + kPatch * kOs +
     static_cast<size_t>(kStages) * kRawElems) *
    sizeof(bf16);
static_assert(2 * kGroups * kCols * sizeof(float) <=
                  kPatch * kOs * sizeof(bf16),
              "the output tile holds the sums' reduction");

struct Conv {
  int n, h, w, c;       // x [n, h, w, c]
  int ho, wo, k;        // y [n, ho, wo, k]
  int prow, pcol;       // patches an image: down, across
  int patches;          // n prow pcol
  int cols;             // column tiles of kCols output channels
  int slots;            // block rows: slot q walks patches q, q + slots, ..
  int tiles;            // the sums' partials a channel (>= slots)
  int vec;              // y: 16-byte stores
  int vec_x;            // x 16-byte aligned: its rows by cp.async
  int x_elems;          // elements of x
};

// A block owns kCols output channels and walks its slot's patches of 8 x
// 16 output pixels. It keeps the s2d weight of its columns in shared
// memory (row (tap, c16), zeros past 4 C and K); per patch, from a ring of
// kStages copies (the x rows under the patch's s2d halo, cp.async, copied
// kStages - 1 patches ahead): the s2d halo tile, rearranged from the raw
// rows; warp (wr, wn) computes patch rows 4 wr .. 4 wr + 3 (16 pixels
// each, one m16 fragment) against columns 32 wn .. + 32: for each tap
// column j it loads the four tap rows' B fragments once and the seven
// halo rows 4 wr .. 4 wr + 6 (A, [pixel][channel], shifted j to the
// right) once each, and halo row 4 wr + t is tap row i = t - e of patch
// row 4 wr + e: 64 products from 15 ldmatrix. The tensor cores' sums of
// a tap column are promoted into the totals with round-to-nearest adds.
// The epilogue rounds the totals to bf16 into shared memory; a thread
// stores 8 channels of a pixel as 16 bytes (8 threads a 128-byte pixel
// row) and sums the stored values, in registers over all the block's
// patches, reduced over the block once in a fixed order into its
// partials [K][tiles] at its slot.
__global__ void __launch_bounds__(kThreads, 2)
    conv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ y, float* __restrict__ part1,
                   float* __restrict__ part2, Conv s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp >> 1;   // patch rows kRows wr .. + kRows
  const int wn = warp & 1;    // columns 32 wn .. + 32
  const int slot = blockIdx.x / s.cols;
  const int k0 = (blockIdx.x - slot * s.cols) * kCols;
  const int mine = (s.patches - slot + s.slots - 1) / s.slots;
  const int per_img = s.prow * s.pcol;
  const dl4j_s2d::Src src{x, s.h, s.w, s.c, s.x_elems, s.vec_x};
  bf16* Hs = reinterpret_cast<bf16*>(smem);   // [kHalo][kHs]
  bf16* Ws = Hs + kHalo * kHs;                // [16 taps][16][kWs]
  bf16* Os = Ws + 16 * 16 * kWs;              // [kPatch][kOs]
  bf16* Ring = Os + kPatch * kOs;             // [S][kRawElems]

  // the image and first output row and column of patch p
  auto origin = [&](int p, int& img, int& oh0, int& ow0) {
    img = p / per_img;
    const int rem = p - img * per_img;
    const int pr = rem / s.pcol;
    oh0 = pr * kTh;
    ow0 = (rem - pr * s.pcol) * kTw;
  };
  auto issue = [&](int g) {   // one copy group, empty past the last
    if (g < mine) {
      int img, oh0, ow0;
      origin(slot + g * s.slots, img, oh0, ow0);
      dl4j_s2d::issue_rows<kThreads>(Ring + (g % kStages) * kRawElems, src,
                                     img, oh0, ow0, tid);
    }
    cp_async_commit();
  };
  for (int g = 0; g < kStages - 1; ++g) issue(g);
  // the weight, once: row (tap, c16) of tap-major w [16 4C, K], columns
  // k0 .. k0 + kCols, zeros past 4 C and K
  const int c4 = 4 * s.c;
  for (int i = tid; i < 16 * 16 * kCols; i += kThreads) {
    const int col = i % kCols;
    const int row = i / kCols;   // tap 16 + c16
    const int tap = row >> 4;
    const int c16 = row & 15;
    Ws[row * kWs + col] = (c16 < c4 && k0 + col < s.k)
                              ? w[(tap * c4 + c16) * s.k + k0 + col]
                              : __float2bfloat16(0.f);
  }
  int code[8];
  dl4j_s2d::channel_codes(s.c, tid & 1, code);
  // the epilogue's share: channels k0 + 8 u .. + 8 of the pixels (tid >>
  // 3) + kGroups jj of each patch, and their sums over the stored values
  const int u = tid & 7;
  const int ch = k0 + 8 * u;
  const int nvalid = dl4j_mma::clamp8(s.k - ch);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // patch i copied; the last patch's products and
                       // stores done
    issue(i + kStages - 1);
    int img, oh0, ow0;
    origin(slot + i * s.slots, img, oh0, ow0);
    dl4j_s2d::rearrange<kThreads>(Hs, Ring + (i % kStages) * kRawElems,
                                  code, src, img, oh0, ow0, tid);
    __syncthreads();

    // acc: the tensor cores' sums of one tap column, whose accumulation
    // rounds toward zero; tot: the totals, promoted into with f32 adds
    // (round to nearest)
    float tot[kRows][4][4];
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[e][n][q] = 0.f;
    // the tap columns one at a time: unrolled, the compiler hoists the
    // whole sequence's fragments
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      uint32_t bfr[4][2][4];   // tap rows i = 0..3 of column j, 32 columns
#pragma unroll
      for (int ti = 0; ti < 4; ++ti)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          ldsm_x4<true>(smem_addr(Ws + ((ti * 4 + j) * 16 +
                                        dl4j_mma::b_trans_k(lane)) * kWs +
                                  wn * 32 + 16 * h2 +
                                  dl4j_mma::b_trans_n(lane)),
                        bfr[ti][h2]);
      float acc[kRows][4][4];
#pragma unroll
      for (int e = 0; e < kRows; ++e)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[e][n][q] = 0.f;
#pragma unroll
      for (int t = 0; t < kRows + 3; ++t) {
        uint32_t af[4];
        ldsm_x4<false>(smem_addr(Hs + ((kRows * wr + t) * kHw +
                                       (lane & 15) + j) * kHs +
                                 dl4j_mma::a_k(lane)),
                       af);
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const int ti = t - e;
          if (ti < 0 || ti > 3) continue;
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_16816(acc[e][n], af, bfr[ti][n >> 1][(n & 1) * 2],
                      bfr[ti][n >> 1][(n & 1) * 2 + 1]);
        }
      }
#pragma unroll
      for (int e = 0; e < kRows; ++e)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) tot[e][n][q] += acc[e][n][q];
    }

    // the epilogue: the totals rounded to bf16 through shared memory
    // (patch pixel 16 row + column), then 16 bytes a thread stored and
    // summed
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int row = (kRows * wr + e) * kTw + (lane >> 2);
        const int col = wn * 32 + 8 * n + (lane & 3) * 2;
        *reinterpret_cast<uint32_t*>(Os + row * kOs + col) =
            dl4j_mma::pack2(tot[e][n][0], tot[e][n][1]);
        *reinterpret_cast<uint32_t*>(Os + (row + 8) * kOs + col) =
            dl4j_mma::pack2(tot[e][n][2], tot[e][n][3]);
      }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kPatch / kGroups; ++jj) {
      const int q = (tid >> 3) + kGroups * jj;
      const int oh = oh0 + q / kTw;
      const int ow = ow0 + q % kTw;
      if (oh >= s.ho || ow >= s.wo || nvalid == 0) continue;
      const uint4 o = *reinterpret_cast<const uint4*>(Os + q * kOs + 8 * u);
      dl4j_mma::store8(y, ((img * s.ho + oh) * s.wo + ow) * s.k + ch, nvalid,
                       s.vec != 0, o);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < nvalid) {
          const float of = dl4j_mma::elem(o, e);
          s1[e] += of;
          s2[e] += of * of;
        }
      }
    }
  }
  // the block's partial sums: the row groups in order (the output tile,
  // no longer read, holds them)
  __syncthreads();
  float* red1 = reinterpret_cast<float*>(Os);   // [kGroups][kCols]
  float* red2 = red1 + kGroups * kCols;         // [kGroups][kCols]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red1[(tid >> 3) * kCols + 8 * u + e] = s1[e];
    red2[(tid >> 3) * kCols + 8 * u + e] = s2[e];
  }
  __syncthreads();
  if (tid < kCols && k0 + tid < s.k) {
    float a = 0.f, b = 0.f;
    for (int gr = 0; gr < kGroups; ++gr) {
      a += red1[gr * kCols + tid];
      b += red2[gr * kCols + tid];
    }
    const int64_t at = static_cast<int64_t>(k0 + tid) * s.tiles + slot;
    part1[at] = a;
    part2[at] = b;
  }
}

// The geometry and grid on a card of `sms` SMs: 8 x 16-pixel patches of
// each image, kCols-channel column tiles, and as many block rows as the
// card holds blocks (two an SM: shared memory and registers) over the
// column tiles, at most one a patch (stem.py's _stem_conv_plan mirrors
// it).
inline Conv geometry(int n, int h, int wd, int c, int k, int sms) {
  Conv s{};
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
  const int q = 2 * sms / s.cols;
  s.slots = q < 1 ? 1 : q > s.patches ? s.patches : q;
  return s;
}

// The pass and the sums' fixed-order reduction. Refuses (before any
// launch) C outside 1 .. 4, `tiles` short of the grid's block rows, and
// any tensor of 2^31 - 1 elements or more (the kernel indexes with
// ints).
inline int launch(const void* x, const void* w, void* y, void* part1,
                  void* part2, void* s1, void* s2, int n, int h, int wd,
                  int c, int k, int tiles, cudaStream_t st) {
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
  Conv s = geometry(n, h, wd, c, k, sms);
  if (tiles < s.slots) return static_cast<int>(cudaErrorInvalidValue);
  if (s.patches == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  s.tiles = tiles;
  s.vec = k % 8 == 0 && dl4j_mma::aligned16(y);
  s.vec_x = dl4j_mma::aligned16(x);
  s.x_elems = n * h * wd * c;
  static size_t granted = 0;
  int err = dl4j_mma::set_smem(conv_tc_kernel, kSmem, granted);
  if (err) return err;
  conv_tc_kernel<<<static_cast<unsigned>(s.slots) * s.cols, kThreads, kSmem,
                   st>>>(static_cast<const bf16*>(x),
                         static_cast<const bf16*>(w), static_cast<bf16*>(y),
                         static_cast<float*>(part1),
                         static_cast<float*>(part2), s);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ++conv_launched[kConvTc];
  dl4j_conv::reduce_partials_kernel<<<k, dl4j_conv::kReduceThreads, 0, st>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      s.slots, tiles, static_cast<float*>(s1), static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv_tc

// ---------------------------------------------------------------------
// stem_conv on the CUDA cores (f32; bf16 at 4 C > 16)
// ---------------------------------------------------------------------
template <typename T>
int stem_conv(const void* x, const void* w, void* out, void* part1,
              void* part2, void* s1, void* s2, int n, int h, int wd, int c,
              int k, int tiles, void* stream) {
  Geometry g{n, h, wd, c, (h - 1) / 2 + 1, (wd - 1) / 2 + 1, k, 2, 64 * c,
             0, tiles};
  const int err = dl4j_conv::launch<T, dl4j_conv::kStemS2d>(
      x, nullptr, nullptr, w, out, part1, part2, s1, s2, g, stream);
  if (!err && dl4j_conv::row_blocks(g) > 0 && k > 0)
    ++conv_launched[kConvCuda];
  return err;
}

}  // namespace

extern "C" {

int dl4j_stem_conv_f32(const void* x, const void* w, void* out, void* part1,
                       void* part2, void* s1, void* s2, int n, int h, int wd,
                       int c, int k, int tiles, void* stream) {
  return stem_conv<float>(x, w, out, part1, part2, s1, s2, n, h, wd, c, k,
                          tiles, stream);
}

int dl4j_stem_conv_bf16(const void* x, const void* w, void* out,
                        void* part1, void* part2, void* s1, void* s2, int n,
                        int h, int wd, int c, int k, int tiles,
                        void* stream) {
  return stem_conv<__nv_bfloat16>(x, w, out, part1, part2, s1, s2, n, h, wd,
                                  c, k, tiles, stream);
}

int dl4j_stem_conv_bf16_mma(const void* x, const void* w, void* out,
                            void* part1, void* part2, void* s1, void* s2,
                            int n, int h, int wd, int c, int k, int tiles,
                            void* stream) {
  return conv_tc::launch(x, w, out, part1, part2, s1, s2, n, h, wd, c, k,
                         tiles, static_cast<cudaStream_t>(stream));
}

int dl4j_stem_pool_f32(const void* y, const void* sc, const void* bb,
                       void* out, int n, int ho, int wo, int k,
                       void* stream) {
  return fwd_pool::stem_pool<float>(y, sc, bb, out, n, ho, wo, k, stream);
}

int dl4j_stem_pool_bf16(const void* y, const void* sc, const void* bb,
                        void* out, int n, int ho, int wo, int k,
                        void* stream) {
  return fwd_pool::stem_pool<__nv_bfloat16>(y, sc, bb, out, n, ho, wo, k,
                                           stream);
}

int dl4j_conv_row_tile() { return dl4j_conv::kBM; }

// The pool's plan for y [n, ho, wo, k] on the route of `vec` channels a
// lane (16 / sizeof(T), or 1): out[5] = grid.x, grid.y, strips an image,
// quads a pooled row, pooled rows a strip (stem.py's
// _stem_fwd_pool_plan).
int dl4j_stem_pool_plan(int n, int ho, int wo, int k, int vec, int* out) {
  int64_t warps = 0;
  fwd_pool::Pool s = fwd_pool::geometry(n, ho, wo, k, &warps);
  if (warps >= INT_MAX || vec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  s.warps = static_cast<int>(warps);
  const dim3 grid = fwd_pool::grid_of(s, vec);
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = s.strips;
  out[3] = s.quads;
  out[4] = fwd_pool::kRows;
  return 0;
}

// The pool's device kernels started so far, by route (out[2]: the
// 16-byte route, the element route).
int dl4j_stem_pool_kernel_launches(int* out) {
  for (int i = 0; i < 2; ++i) out[i] = fwd_pool::launched[i];
  return 0;
}

// The conv's device kernels started so far, by kind (out[2]: the
// CUDA-core GEMM, the tensor-core pass): what one call of each route
// launches besides the sums' reduction.
int dl4j_stem_conv_kernel_launches(int* out) {
  for (int i = 0; i < 2; ++i) out[i] = conv_launched[i];
  return 0;
}

// Bytes of dynamic shared memory the bf16 tensor-core conv launches with.
int dl4j_stem_conv_tc_smem() { return static_cast<int>(conv_tc::kSmem); }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
