// Tensor-core tiles for the bf16 convolution kernels on Hopper (sm_90a):
// mma.sync.aligned.m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix from
// bf16 tiles in shared memory, the loaders that stage those tiles
// through a prologue, and the patch tiling of an NHWC image.
//
// Used by the bottleneck's bf16 kernels: the forward convs
// (bottleneck.cu: conv1x1 and conv3x3) and the backward stages
// (bottleneck_bwd.cu: bwd1x1 and bwd3x3), and by the flash kernels'
// tensor-core tiles (flash_attention.cu). The f32 kernels keep
// conv_gemm.cuh's CUDA-core tile step (exact f32, no TF32).
//
// The pieces:
//   - warp_k16: one 16-deep reduction step of a warp's 64 x 32 output
//     tile (4 x 4 m16n8 fragments, 64 f32 accumulators a thread). Each
//     lane hands ldmatrix.x4 one 16-byte row address per fragment, so a
//     tile whose rows are gathered (a 3x3 tap's shifted window of a halo
//     tile, or a zero row for a tap that falls outside the image) costs
//     no more than a dense one. An operand stored [k][row] (the dW pass:
//     pixels by channels) is read with ldmatrix.trans.
//   - copy8: 8 bf16 copied into shared memory as one 16-byte cp.async
//     (zero-filled past the image or the widths), so the next chunk's
//     loads are in flight while the block converts and multiplies this
//     one; element by element where a width is not a multiple of 8 or a
//     pointer not 16-byte aligned.
//   - dy8, z8: the prologues, from the raw copy to the operand tile, 8
//     channels at a time, their per-channel constants held in registers
//     (a thread converts the same 8 channels of every row it takes): the
//     BN-backward dy and the activated z (the forward's BN affine + relu
//     or the affine alone, the backward's relu or the bare input), in
//     f32 op by op, rounded to bf16 where the plain version rounds. The tensor cores then
//     multiply operands already rounded, so their products are exact
//     and only the f32 sums differ from it.
//   - patch_tiling: a 3x3's pixels cut into TH x TW patches of the
//     "tall" image [N H, W] (the images stacked), chosen so that the
//     patch and its one-pixel halo waste the least; the taps of a pixel
//     whose row crosses into the next image read a zero row instead
//     (patch_pixel, halo_pixel, patch_origin address them).
//   - stages_for, set_smem: the depth of a kernel's copy ring, and the
//     dynamic shared memory above 48 KB granted before a launch.
// Row strides of the tiles are 16 bytes past a multiple of 128, so the
// eight rows of one ldmatrix phase hit eight distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "nan_max.cuh"

namespace dl4j_mma {

using bf16 = __nv_bfloat16;

constexpr int kFragM = 4;   // m16 fragments of a warp tile: 64 rows
constexpr int kFragN = 4;   // n8 fragments: 32 columns

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i addresses row i % 8 of matrix i / 8.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The rows and columns a lane addresses in ldmatrix.x4 (the element
// offsets below are added to the row's address by the caller):
//   A stored [row][k]  (not trans): row lane & 15, k (lane >> 4) * 8
//   A stored [k][row]  (trans):     k a_trans_k(lane), row a_trans_r(lane)
//   B stored [n][k]    (not trans): n b_n(lane), k b_k(lane)
//   B stored [k][n]    (trans):     k b_trans_k(lane), n (lane >> 4) * 8
// Fragment f of A covers rows 16 f .. +16; ldmatrix for B covers 16
// columns, two n8 fragments.
__device__ __forceinline__ int a_k(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int a_trans_k(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int a_trans_r(int lane) {
  return ((lane >> 3) & 1) << 3;
}
__device__ __forceinline__ int b_n(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}
__device__ __forceinline__ int b_k(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int b_trans_k(int lane) {
  return (lane & 7) + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int b_trans_n(int lane) { return (lane >> 4) << 3; }

// One 16-deep step of a 64 x 32 warp tile: a[f] is this lane's shared
// address for A fragment f, b[h] for the B columns 16 h .. +16.
template <bool A_TRANS, bool B_TRANS>
__device__ __forceinline__ void warp_k16(float (&acc)[kFragM][kFragN][4],
                                         const uint32_t (&a)[kFragM],
                                         const uint32_t (&b)[kFragN / 2]) {
  uint32_t af[kFragM][4], bfr[kFragN / 2][4];
#pragma unroll
  for (int f = 0; f < kFragM; ++f) ldsm_x4<A_TRANS>(a[f], af[f]);
#pragma unroll
  for (int h = 0; h < kFragN / 2; ++h) ldsm_x4<B_TRANS>(b[h], bfr[h]);
#pragma unroll
  for (int f = 0; f < kFragM; ++f)
#pragma unroll
    for (int n = 0; n < kFragN; ++n)
      mma_16816(acc[f][n], af[f], bfr[n >> 1][(n & 1) * 2],
                bfr[n >> 1][(n & 1) * 2 + 1]);
}

// ---------------------------------------------------------------------
// 8 bf16 values as one uint4
// ---------------------------------------------------------------------
__device__ __forceinline__ float elem(const uint4& u, int e) {
  const uint32_t w = e < 2 ? u.x : e < 4 ? u.y : e < 6 ? u.z : u.w;
  const unsigned short h =
      static_cast<unsigned short>((e & 1) ? (w >> 16) : (w & 0xffffu));
  return __bfloat162float(__ushort_as_bfloat16(h));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// f32 values rounded to bf16 (round to nearest even), packed
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// The first `valid` (0..8) of 8 elements at p + off, the rest 0: one
// 16-byte load where `vec` (then valid is 0 or 8 and p + off aligned).
__device__ __forceinline__ uint4 load8(const bf16* p, int64_t off, int valid,
                                       bool vec) {
  if (vec)
    return valid ? __ldg(reinterpret_cast<const uint4*>(p + off))
                 : make_uint4(0u, 0u, 0u, 0u);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (i < valid)
      w[i >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[off + i]))
                   << ((i & 1) * 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Store the first `valid` of 8 elements at p + off.
__device__ __forceinline__ void store8(bf16* p, int64_t off, int valid,
                                       bool vec, const uint4& v) {
  if (vec) {
    if (valid) *reinterpret_cast<uint4*>(p + off) = v;
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >= valid) break;
    const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    p[off + i] = __ushort_as_bfloat16(
        static_cast<unsigned short>((i & 1) ? (w >> 16) : (w & 0xffffu)));
  }
}

__device__ __forceinline__ int clamp8(int n) {
  return n < 0 ? 0 : n > 8 ? 8 : n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy 8 bf16 from src + off to dst: the first `valid`, zeros after. A
// 16-byte cp.async (zero-filled where valid is 0), which the caller
// waits for, where `vec` (then valid is 0 or 8 and both ends are 16-byte
// aligned); else element by element, done on return.
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src,
                                      int64_t off, int valid, bool vec) {
  if (vec)
    cp_async16(dst, valid ? src + off : src, valid != 0);
  else
    *reinterpret_cast<uint4*>(dst) = load8(src, off, valid, false);
}

// The BN-backward constants (sc, inv, mu, m1, m2: aff_k's rows 0, 2,
// 3, 4, 5) of channels ch .. ch + 8, 0 past K.
__device__ __forceinline__ void dy_constants(const float* aff, int k, int ch,
                                             float (&c)[5][8]) {
#pragma unroll
  for (int row = 0; row < 5; ++row)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      c[row][e] =
          ch + e < k ? __ldg(aff + (row ? row + 1 : 0) * k + ch + e) : 0.f;
}

// The activation constants (sc, bb) of channels ch .. ch + 8, 0 past C.
__device__ __forceinline__ void z_constants(const float* sc, const float* bb,
                                            int c, int ch,
                                            float (&cz)[2][8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    cz[0][e] = ch + e < c ? __ldg(sc + ch + e) : 0.f;
    cz[1][e] = ch + e < c ? __ldg(bb + ch + e) : 0.f;
  }
}

// The same from aff_p's rows 0, 1 (sc, bb).
__device__ __forceinline__ void z_constants(const float* aff, int c, int ch,
                                            float (&cz)[2][8]) {
  z_constants(aff, aff + c, c, ch, cz);
}

// The BN-backward prologue of 8 channels: dy = sc (g - m1 - yhat m2),
// yhat = (y - mu) inv, f32 op by op as the TPU kernel (no fused
// multiply-add), rounded to bf16; the first `valid` elements, the rest
// 0 (a padded tap reads 0 after the prologue).
__device__ __forceinline__ uint4 dy8(const uint4& gr, const uint4& yr,
                                     const float (&c)[5][8], int valid) {
  float out[8];
  auto dy = [&](int e) {
    const float yhat = __fmul_rn(__fsub_rn(elem(yr, e), c[2][e]), c[1][e]);
    return __fmul_rn(c[0][e], __fsub_rn(__fsub_rn(elem(gr, e), c[3][e]),
                                        __fmul_rn(yhat, c[4][e])));
  };
  if (valid == 8) {   // the common case, unpredicated
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = dy(e);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = e < valid ? dy(e) : 0.f;
  }
  return pack8(out);
}

// The activation prologue of 8 channels: z = relu(y sc + bb) (two
// roundings; the relu NaN-propagating, nan_max.cuh); with relu = 0,
// y sc + bb where `affine` (the forward's identity prologue), else y
// itself (the backward's); rounded to bf16; the first `valid` elements,
// the rest 0.
__device__ __forceinline__ uint4 z8(const uint4& yr, const float (&c)[2][8],
                                    int valid, int relu,
                                    bool affine = false) {
  if (!relu && !affine && valid == 8) return yr;   // y itself
  float out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float z = e < valid ? elem(yr, e) : 0.f;
    if ((relu || affine) && e < valid) {
      z = __fadd_rn(__fmul_rn(z, c[0][e]), c[1][e]);
      if (relu) z = dl4j_nan::relu_nan(z);
    }
    out[e] = z;
  }
  return pack8(out);
}

// ---------------------------------------------------------------------
// patches of the tall image [rows, wo] (rows = N H): TH x TW pixels
// ---------------------------------------------------------------------
struct Tiling {
  int tw, th;      // patch width and height (pixels)
  int cols;        // patches across the width
  int patches;     // patches in all
};

// The patch of at most pp pixels (TH <= 64, TW <= 16) whose useful
// pixels per halo pixel are the most: TH / (cols (TH + 2)(TW + 2)),
// compared exactly in integers, ties to the wider patch. The port's
// Python planner (bottleneck.py, _patch_tiling) makes the same choice.
inline Tiling patch_tiling(int rows, int wo, int pp) {
  Tiling best{0, 0, 0, 0};
  int64_t best_halo = 0;
  const int top = wo < 16 ? wo : 16;
  for (int d = 1; d <= top; ++d) {
    const int th = pp / d < 64 ? pp / d : 64;
    const int cols = (wo + d - 1) / d;
    const int64_t halo = static_cast<int64_t>(th + 2) * (d + 2);
    if (d == 1 || static_cast<int64_t>(th) * best.cols * best_halo >=
                      static_cast<int64_t>(best.th) * cols * halo) {
      best = Tiling{d, th, cols, 0};
      best_halo = halo;
    }
  }
  best.patches = ((rows + best.th - 1) / best.th) * best.cols;
  return best;
}

// The first tall row and column of patch p.
__host__ __device__ __forceinline__ void patch_origin(int p, const Tiling& t,
                                                      int& r0, int& col0) {
  const int pr = p / t.cols;
  r0 = pr * t.th;
  col0 = (p - pr * t.cols) * t.tw;
}

// Local pixel q of the patch at tall row r0, column col0 of the tall
// image [rows, wo]: its pixel, or -1 (past the patch's TH x TW, or
// outside the image).
__device__ __forceinline__ int patch_pixel(int q, int r0, int col0,
                                           const Tiling& t, int rows,
                                           int wo) {
  const int i = q / t.tw;
  const int row = r0 + i;
  const int col = col0 + q - i * t.tw;
  return (i < t.th && row < rows && col < wo) ? row * wo + col : -1;
}

// Halo pixel r (the patch grown by one pixel each side) of the patch at
// (r0, col0): its pixel, or -1 outside the tall image [rows, wo].
__device__ __forceinline__ int halo_pixel(int r, int r0, int col0,
                                          const Tiling& t, int rows,
                                          int wo) {
  const int hw = t.tw + 2;
  const int hi = r / hw;
  const int row = r0 - 1 + hi;
  const int col = col0 - 1 + r - hi * hw;
  return (row >= 0 && row < rows && col >= 0 && col < wo) ? row * wo + col
                                                          : -1;
}

// ---------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------
// Copy stages in flight: three where a stage's copies take at most 40 KB
// of shared memory, else two.
__host__ __device__ constexpr int stages_for(size_t bytes) {
  return bytes <= 40 * 1024 ? 3 : 2;
}

// Let `kernel` take `bytes` of dynamic shared memory; `granted` (one per
// kernel) remembers the most already granted, so a launch pays the call
// only when it needs more.
template <class K>
int set_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  if (!err) granted = bytes;
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace dl4j_mma
