// The bf16 backward of a 1x1 / 3x3 convolution on Hopper's tensor cores,
// shared by two libraries:
//   - bottleneck_bwd.cu: the bottleneck's backward stages bwd1x1 (stride 1
//     or 2) and bwd3x3 (kStage): dz = (dy rounded) W^T with dy = sc (g -
//     m1 - yhat m2) made from g and y_k, masked by relu'(y_{k-1} sc_p +
//     bb_p), stored, its sums (sum dz, sum dz yhat_{k-1}); dW = z_{k-1}^T
//     dy; bottleneck_bwd.cu's source note says what each computes, what
//     bounds it and how the design meets the bound;
//   - fused.cu: the fused bn -> act -> 1x1 conv's backward (kFused), a
//     stride-1 1x1 over [M, C] (M = N H W rows of one pixel each): dz = g
//     W^T on the RAW g (no prologue), masked by relu'(y sc + bb), dy = dz
//     sc stored rounded once, the sums dsc = sum dz y and dbb = sum dz of
//     the f32 dz; dW = (z rounded)^T g with z = act(y sc + bb); db = sum g
//     from the g tiles the dW pass stages (the first channel tile's
//     blocks), as row C of its partials.
// In kFused the dz pass's A operand is g itself, copied by cp.async into
// the ring and read by ldmatrix with no conversion pass (one block barrier
// a chunk), and the dW pass's B operand is g's ring tile, read with
// ldmatrix.trans; the kernels' arguments carry the fused op's operands in
// the stage's places: g, yprev = y, w, aff_p = sc [C], aff_k = bb [C]
// (yk unused).
// Both modes promote the tensor cores' partial sums (accumulated toward
// zero) with round-to-nearest adds, take no float atomics (the sums and dW
// go through partials reduced in a fixed order), and take element-wise
// copies and stores where a width is not a multiple of 8 or a pointer not
// 16-byte aligned. Element offsets are 32-bit: the callers refuse a
// tensor of 2^31 - 1 elements or more before any launch.

#pragma once

#include "conv_mma.cuh"

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace dl4j_bwd {

// what a launch computes: a bottleneck stage, or the fused op's backward
enum Mode : int { kStage = 0, kFused = 1 };

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
// tensor cores. kFused (TAPS 1): g itself is the operand, copied into
// a ring of [128][KC + 8] tiles that ldmatrix reads; the epilogue stores
// dy = dz sc and sums dz y and dz.
// ---------------------------------------------------------------------
// The dz pass's ring: a stage holds the chunk's g and y_k (the 3x3:
// the halo's, at most 264 pixels) and w for all taps; kFused g's
// operand tile and w.
template <int TAPS, int WN, int MODE>
__host__ __device__ constexpr int dz_stages() {
  return MODE == kFused
             ? stages_for((kDzPixels + 32 * WN) * (32 + 8) * sizeof(bf16))
             : stages_for(((TAPS == 9 ? 2 * 264 * 16 : 2 * kDzPixels * 32) +
                           TAPS * 32 * WN * ((TAPS == 9 ? 16 : 32) + 8)) *
                          sizeof(bf16));
}

template <int TAPS, int WN, int MODE>
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
  constexpr int S = dz_stages<TAPS, WN, MODE>();
  constexpr bool kFusedOp = MODE == kFused;
  static_assert(!kFusedOp || TAPS == 1, "the fused op is a 1x1");
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
  bf16* As = zero + AS;   // [rows_a][AS] dy; kFused [S][rows_a][AS] g
  bf16* Bs = As + (kFusedOp ? S : 1) * rows_a * AS;   // [S][TAPS BN][AS] w
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
        const int valid = a_off[j] < 0 ? 0 : ch_valid;
        if constexpr (kFusedOp) {
          copy8(As + (buf * rows_a + (tid + j * NT) / G) * AS + 8 * v, g,
                a_off[j] + ch, valid, vec);
          continue;
        }
        const int at = buf * rows_a * KC + (tid + j * NT) * 8;
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
    const bf16* as = As;   // kFused: the ring's tile of chunk kc
    if constexpr (kFusedOp) {
      cp_async_wait<S - 2>();
      __syncthreads();   // chunk kc copied; the last products done
      issue(kc + S - 1);
      as = As + buf * rows_a * AS;
    } else {
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
    }
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
                     ? smem_addr(as + (hb[f] + toff) * AS + col)
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
  // the zeros of the three pixels the conv never read); kFused: the mask
  // by relu'(y sc + bb), the sums dz y and dz of the f32 dz, dy = dz sc
  // stored rounded once
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
    const bool ok = (kFusedOp || s.relu) && e < nvalid;
    scp[e] = ok ? __ldg(aff_p + cb + e) : 1.f;
    bbp[e] = ok ? __ldg(kFusedOp ? aff_k + cb + e : aff_p + s.c + cb + e)
                : 0.f;
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
    yrs[j] = ((kFusedOp || s.relu) && at[j] >= 0)
                 ? load8(yprev, at[j], nvalid, vec)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (at[j] < 0) continue;
    const int r = tid / CG + j * RSTEP;
    float val[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) val[e] = Es[r * ES + 8 * u + e];
    if constexpr (kFusedOp) {
      const uint4 yr = yrs[j];
      float dyv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e < nvalid) {
          const float yv = elem(yr, e);
          if (s.relu &&
              !(__fadd_rn(__fmul_rn(yv, scp[e]), bbp[e]) > 0.f))
            val[e] = 0.f;
          s1[e] += __fmul_rn(val[e], yv);
          s2[e] += val[e];
        }
        dyv[e] = __fmul_rn(val[e], scp[e]);
      }
      store8(dz, at[j], nvalid, vec, pack8(dyv));
      continue;
    }
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
  if (!kFusedOp && !s.relu) return;
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
template <int TAPS, int WN, int MODE>
size_t dz_smem(const TcStage& s) {
  constexpr int BN = 32 * WN;
  constexpr int KC = TAPS == 9 ? 16 : 32;
  constexpr int AS = KC + 8;
  constexpr int S = dz_stages<TAPS, WN, MODE>();
  const int rows_a =
      TAPS == 9 ? (s.tile.th + 2) * (s.tile.tw + 2) : kDzPixels;
  const size_t tiles =
      MODE == kFused
          ? static_cast<size_t>(AS) * (1 + S * rows_a + S * BN) * sizeof(bf16)
          : (static_cast<size_t>(AS) * (1 + rows_a + S * TAPS * BN) +
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
// (ldmatrix.trans), B = dy transposed. kFused (TAPS 1): B is g's ring
// tile itself ([64][BN + 8], no conversion), partials [splits, C + 1,
// K]; the blocks of the first channel tile also sum g's columns over
// their split into row C (db).
// ---------------------------------------------------------------------
// The dW pass's ring: a stage holds y_{k-1} for the chunk (the 3x3: its
// halo, at most 198 pixels) and g and y_k; kFused y and g's operand tile.
template <int TAPS, int WM, int WN, int MODE>
__host__ __device__ constexpr int dw_stages() {
  return MODE == kFused
             ? stages_for((kDwPixels * 64 * WM +
                           kDwPixels * (32 * WN + 8)) * sizeof(bf16))
             : stages_for(((TAPS == 9 ? 198 : kDwPixels) *
                               (TAPS == 9 ? 64 : 64 * WM) +
                           2 * kDwPixels * 32 * WN) *
                          sizeof(bf16));
}

template <int TAPS, int WM, int WN, int MODE>
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
  constexpr int S = dw_stages<TAPS, WM, WN, MODE>();
  constexpr bool kFusedOp = MODE == kFused;
  static_assert(!kFusedOp || TAPS == 1, "the fused op is a 1x1");
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
  bf16* Ds = Zs + rows_z * ZS;                  // [64][DS] dy (kStage)
  bf16* Rz = Ds + (kFusedOp ? 0 : kDwPixels * DS);   // [S][rows_z][BR] y
  bf16* Rg = Rz + S * rows_z * BR;   // [S][64][BN] g; kFused [S][64][DS]
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
        if constexpr (kFusedOp) {
          copy8(Rg + (buf * kDwPixels + (tid + j * NT) / DG) * DS + 8 * vd,
                g, px * s.k + dch, px < 0 ? 0 : dvalid, vec);
          continue;
        }
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
  if constexpr (kFusedOp) {
    z_constants(aff_p, aff_k, s.c, zch, cz);   // sc, bb
  } else {
    z_constants(aff_p, s.relu ? s.c : 0, zch, cz);
    dy_constants(aff_k, s.k, dch, cd);
  }
  // kFused, the first channel tile's blocks: this thread's sums of g's
  // columns dch .. + 8 over its rows of every chunk (row group rgp, rows
  // rgp + RG i), reduced over the row groups in order at the end
  constexpr int RG = NT / DG;
  const int rgp = tid / DG;
  const bool db_sums = kFusedOp && blockIdx.x == 0;
  float dbs[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) dbs[e] = 0.f;
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
             z_pixel(p, r0, col0, j) < 0 ? 0 : zvalid, s.relu, kFusedOp);
    }
    // B: dy converted from the copies (kStage); g's ring tile (kFused)
    const bf16* bt = Ds;
    if constexpr (kFusedOp) {
      bt = Rg + buf * kDwPixels * DS;
      if (db_sums) {
#pragma unroll
        for (int i = 0; i < kDwPixels / RG; ++i) {
          const uint4 gv = *reinterpret_cast<const uint4*>(
              bt + (rgp + RG * i) * DS + 8 * vd);
#pragma unroll
          for (int e = 0; e < 8; ++e) dbs[e] += elem(gv, e);
        }
      }
    } else {
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
        b[h2] = smem_addr(bt + (16 * ks + dl4j_mma::b_trans_k(lane)) * DS +
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

  float* out = part + static_cast<int64_t>(split) *
                          (kFusedOp ? s.c + 1 : TAPS * s.c) * s.k;
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
  if constexpr (kFusedOp) {
    if (db_sums) {   // the block's db partial: the row groups in order
      __syncthreads();   // every product done: the ring is free
      float* red = reinterpret_cast<float*>(Rz);   // [RG][BN]
#pragma unroll
      for (int e = 0; e < 8; ++e) red[rgp * BN + 8 * vd + e] = dbs[e];
      __syncthreads();
      if (tid < BN && n0 + tid < s.k) {
        float a = 0.f;
        for (int r = 0; r < RG; ++r) a += red[r * BN + tid];
        out[static_cast<int64_t>(s.c) * s.k + n0 + tid] = a;
      }
    }
  }
}

// Bytes of shared memory the dW pass takes.
template <int TAPS, int WM, int WN, int MODE>
size_t dw_smem(const TcStage& s) {
  constexpr int BR = TAPS == 9 ? 64 : 64 * WM;
  constexpr int BN = 32 * WN;
  constexpr int S = dw_stages<TAPS, WM, WN, MODE>();
  if (MODE == kFused)
    return (static_cast<size_t>(BR + 8) * (1 + kDwPixels) +
            S * static_cast<size_t>(kDwPixels) * BR +
            S * static_cast<size_t>(kDwPixels) * (BN + 8)) * sizeof(bf16);
  const int rows_z =
      TAPS == 9 ? (s.tile.th + 2) * (s.tile.tw + 2) : kDwPixels;
  return (static_cast<size_t>(BR + 8) * (1 + rows_z) +
          static_cast<size_t>(kDwPixels) * (BN + 8) +
          S * static_cast<size_t>(rows_z) * BR +
          2 * S * static_cast<size_t>(kDwPixels) * BN) * sizeof(bf16) +
         (TAPS == 9 ? static_cast<size_t>(WM * WN) * 64 * 32 * sizeof(float)
                    : 0);
}

template <int TAPS, int WN, int MODE>
int launch_dz(const void* yk, const void* g, const void* yprev,
              const void* w, const void* aff_k, const void* aff_p, void* dz,
              void* part1, void* part2, const TcStage& s, cudaStream_t st) {
  constexpr int BN = 32 * WN;
  const size_t bytes = dz_smem<TAPS, WN, MODE>(s);
  auto kernel = dz_tc_kernel<TAPS, WN, MODE>;
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

template <int TAPS, int WM, int WN, int MODE>
int launch_dw(const void* yk, const void* g, const void* yprev,
              const void* aff_k, const void* aff_p, void* dw_part,
              int splits, const TcStage& s, cudaStream_t st) {
  constexpr int BR = TAPS == 9 ? 64 : 64 * WM;
  constexpr int BN = 32 * WN;
  const size_t bytes = dw_smem<TAPS, WM, WN, MODE>(s);
  auto kernel = dw_tc_kernel<TAPS, WM, WN, MODE>;
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
// columns (bottleneck.py's _bwd_tc_plan mirrors it, and fused.py's
// _bwd_tc_plan through it). Calls f(WM, WN) with the two as
// std::integral_constant.
template <int TAPS, class F>
auto with_dw_shape(const TcStage& s, F f) {
  using std::integral_constant;
  if constexpr (TAPS == 9) {
    return f(integral_constant<int, 9>{}, integral_constant<int, 1>{});
  } else {
    if (s.c <= 64) {
      if (s.k <= 64)
        return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
      if (s.k <= 128)
        return f(integral_constant<int, 1>{}, integral_constant<int, 4>{});
      return f(integral_constant<int, 1>{}, integral_constant<int, 8>{});
    }
    if (s.k <= 64)
      return f(integral_constant<int, 2>{}, integral_constant<int, 2>{});
    return f(integral_constant<int, 2>{}, integral_constant<int, 4>{});
  }
}

template <int TAPS, int MODE>
int launch_dw_for(const void* yk, const void* g, const void* yprev,
                  const void* aff_k, const void* aff_p, void* dw_part,
                  int splits, const TcStage& s, cudaStream_t st) {
  return with_dw_shape<TAPS>(s, [&](auto wm, auto wn) {
    return launch_dw<TAPS, decltype(wm)::value, decltype(wn)::value, MODE>(
        yk, g, yprev, aff_k, aff_p, dw_part, splits, s, st);
  });
}

}  // namespace dl4j_bwd
