// The bf16 forward 1x1 / 3x3 convolution on Hopper's tensor cores, with
// a BN-affine (+ relu) prologue on its input, shared by two libraries:
//   - bottleneck.cu: the bottleneck's conv1x1 (stride 1 or 2) and conv3x3,
//     whose epilogue sums the stored output per channel (kSums);
//   - fused.cu: the fused bn -> act -> 1x1 conv's forward, a stride-1 1x1
//     over [M, C] (M = N H W rows of one pixel each) whose epilogue adds
//     the f32 bias and takes no sums (kBias).
// It replaces, for bf16, the TPU kernels `_fwd1x1_kernel` and
// `_fwd3x3_kernel` (deeplearning4j_tpu/nn/layers/bottleneck.py, pallas_call
// in `_fwd_conv_stats`) and `_fwd_kernel` (nn/layers/fused.py, pallas_call
// in `_pallas_fwd`). Each computes what its TPU kernel computes: o =
// act(x[::s, ::s] sc + bb) rounded to w's dtype, times w [TAPS, C, K],
// accumulated in f32; kSums rounds o to x's dtype, stores it and sums the
// stored values; kBias adds b [K] (f32) to the f32 sum and rounds once.
//
// What bounds it on an H100 (bf16, ResNet50 at B=128). A 1x1 at s2 (64 ->
// 256 channels at 56x56) reads 51 MB and writes 206 MB for 13 GFLOP:
// 0.077 ms at 3.35 TB/s against 0.013 ms at 989 TFLOP/s, so its stores
// bound it; the s2 3x3 (64 -> 64) moves 103 MB (0.031 ms) for 29.6 GFLOP
// (0.030 ms): near even.
//
// The design: mma.sync.aligned.m16n8k16 bf16 x bf16 -> f32 (SASS
// HMMA.16816.F32.BF16) in 64 x 32 warp tiles fed by ldmatrix
// (conv_mma.cuh).
//   - The output is cut into pixel blocks of 128 (the 1x1: runs of output
//     pixels; the 3x3: TH x TW patches of the images stacked into one tall
//     image, patch_tiling) and column tiles of 64 channels (K <= 64: four
//     warps, two blocks an SM) or 128 (eight warps, one block an SM). The
//     grid holds as many blocks as the card runs at once (fwd_slots); each
//     walks its slot's pixel blocks in one column tile. The column tiles
//     of a slot run side by side, so the x one reads is in L2 for the
//     others.
//   - Per chunk of C (64 channels for the 1x1, 16 for the 3x3) the raw x
//     rows (the 3x3: the patch and its one-pixel halo; a stride-2 1x1
//     every other pixel) and the weight's rows of every tap are copied 16
//     bytes a thread with cp.async into a ring of 2-3 stages, one or two
//     chunks ahead of the one being multiplied. The ring runs on through a
//     block's pixel blocks: the next block's first chunks are in flight
//     while this one's last are multiplied and its output stored, so a
//     1x1's short reduction (one chunk at C = 64) does not leave the copy,
//     the products and the stores one after another. z8 converts each
//     staged element once (f32 op by op, rounded to bf16 as the plain
//     version rounds) into the operand tile; the nine taps read shifted
//     windows of it through ldmatrix row addresses, and a tap outside its
//     image (or in the next image of the tall one) reads a zero row. The
//     weight, stored [C][K], is read with ldmatrix.trans.
//   - The tensor cores' f32 accumulation rounds toward zero (over the s5
//     3x3's 4,608 products its bias would move the bf16 roundings): each
//     chunk's products go into zeroed fragments, promoted into a second
//     register set with round-to-nearest adds every 4 (1x1) or 9 (3x3)
//     steps of 16.
//   - The epilogue goes through its own shared memory (the ring stays in
//     flight): the tile (kBias: plus the bias) rounded to bf16, then a
//     thread stores 8 channels of a row as 16 bytes; kSums adds the stored
//     values to its sums, kept in registers over the block's pixel blocks
//     and reduced over the block once, in a fixed order, into its
//     partials (the caller's second pass reduces them: no atomics).
//   - Widths that are not multiples of 8, or pointers not 16-byte
//     aligned, take element-wise copies and stores on the same path.
//     Element offsets are 32-bit: the callers refuse a tensor of 2^31 - 1
//     elements or more before any launch.
// What still holds it back (the measured times are in PERF.md): the issue
// and conversion work of every 16 bytes staged and two block barriers a
// chunk (one more a pixel block for the epilogue), with one or two blocks
// an SM to hide them; mma.sync's rate below wgmma's; and the halo (~1.4x
// the patch) converted again for each 128-channel column tile.

#pragma once

#include "conv_mma.cuh"

#include <climits>
#include <cstdint>

namespace dl4j_fwd {

using dl4j_mma::bf16;
using dl4j_mma::clamp8;
using dl4j_mma::copy8;
using dl4j_mma::cp_async_commit;
using dl4j_mma::cp_async_wait;
using dl4j_mma::elem;
using dl4j_mma::kFragM;
using dl4j_mma::kFragN;
using dl4j_mma::patch_origin;
using dl4j_mma::set_smem;
using dl4j_mma::smem_addr;
using dl4j_mma::stages_for;
using dl4j_mma::store8;
using dl4j_mma::Tiling;
using dl4j_mma::warp_k16;
using dl4j_mma::z8;
using dl4j_mma::z_constants;

constexpr int kPixels = 128;   // output pixels a block owns

// The epilogue: the per-channel sums of the stored output into partials
// (the bottleneck), or the f32 bias added before the rounding (the fused
// op).
enum Epilogue : int { kSums = 0, kBias = 1 };

struct Fwd {
  int n, h, w, c;   // x [n, h, w, c]
  int ho, wo, k;    // out [n, ho, wo, k]
  int stride;       // the 1x1's subsample (the 3x3: 1)
  int relu;         // the prologue's relu (else the affine alone)
  int vec;          // 16-byte copies and stores (C, K multiples of 8,
                    // pointers 16-byte aligned)
  Tiling tile;      // the pixel blocks (the 1x1: runs of kPixels; only
                    // .patches is read)
  int cols;         // column tiles of the output channels
  int slots;        // block rows of the grid: slot q walks the pixel
                    // blocks q, q + slots, ...
  int tiles;        // kSums: the sums' partials per channel (>= slots)
};

// The x pixel (n, oh s, ow s) that output pixel m = (n, oh, ow) of a 1x1
// reads.
__device__ __forceinline__ int in_pixel(int m, const Fwd& s) {
  if (s.stride == 1) return m;
  const int hw = s.ho * s.wo;
  const int nn = m / hw;
  const int rem = m - nn * hw;
  const int oh = rem / s.wo;
  const int ow = rem - oh * s.wo;
  return (nn * s.h + oh * s.stride) * s.w + ow * s.stride;
}

// The chunk of C a stage holds: 64 channels for the 1x1, 16 for the 3x3.
template <int TAPS>
__host__ __device__ constexpr int fwd_kc() {
  return TAPS == 9 ? 16 : 64;
}

// The ring's depth: a stage holds the chunk's raw x (the 3x3: its halo,
// at most 264 pixels) and the weight's rows of every tap.
template <int TAPS, int WN>
__host__ __device__ constexpr int fwd_stages() {
  return stages_for(((TAPS == 9 ? 264 : kPixels) * fwd_kc<TAPS>() +
                     TAPS * fwd_kc<TAPS>() * (32 * WN + 8)) *
                    sizeof(bf16));
}

// ---------------------------------------------------------------------
// out[m, kk] = sum over (tap, ch) of z at the pixel the tap reads times
// w[tap, ch, kk] (kBias: + b[kk]). A block owns BN = 32 WN output
// channels and walks its slot's pixel blocks of 128 output pixels (the
// 3x3: TH x TW patches); 2 x WN warps of 64 x 32. The copy ring runs
// through the chunks of all its pixel blocks, so the next block's first
// chunks are in flight while this one's last are multiplied and its
// output stored.
// ---------------------------------------------------------------------
template <int TAPS, int WN, int EPI>
__global__ void __launch_bounds__(64 * WN)
    fwd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ sc,
                  const float* __restrict__ bb, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  float* __restrict__ part1, float* __restrict__ part2,
                  Fwd s) {
  constexpr int NT = 64 * WN;
  constexpr int BN = 32 * WN;
  constexpr bool kHalo = TAPS == 9;
  constexpr bool kSum = EPI == kSums;
  constexpr int KC = fwd_kc<TAPS>();
  constexpr int G = KC / 8;        // 8-channel groups of a chunk
  constexpr int CB = BN / 8;       // 8-channel groups of the columns
  constexpr int AS = KC + 8;       // the z tile's row stride
  constexpr int BS = BN + 8;       // the weight tile's row stride
  constexpr int OS = BN + 8;       // the output tile's row stride
  constexpr int S = fwd_stages<TAPS, WN>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN;
  const int wn = warp - wm * WN;
  const int slot = blockIdx.x / s.cols;
  const int k0 = (blockIdx.x - slot * s.cols) * BN;   // the first column
  const Tiling& t = s.tile;
  const int rows_t = s.n * s.ho;   // rows of the tall image
  const int rows_m = rows_t * s.wo;
  const int rows_a = kHalo ? (t.th + 2) * (t.tw + 2) : kPixels;
  const int chunks = (s.c + KC - 1) / KC;
  // this block's pixel blocks: p = slot + i slots, i < mine
  const int mine = (t.patches - slot + s.slots - 1) / s.slots;
  const int total = mine * chunks;   // its chunks, in one sequence
  const bool vec = s.vec != 0;
  bf16* zero = reinterpret_cast<bf16*>(smem);     // one row of zeros
  bf16* As = zero + AS;                           // [rows_a][AS] z
  bf16* Bs = As + rows_a * AS;                    // [S][TAPS KC][BS] w
  bf16* Rx = Bs + S * TAPS * KC * BS;             // [S][rows_a][KC] x
  bf16* Os = Rx + S * rows_a * KC;                // [kPixels][OS] out

  // This thread's items of the copies: x item it = tid + j NT is row
  // it / G, channel group v (past the tile where it >= rows_a G); weight
  // item it is row it / CB of the stage's TAPS KC rows (tap, reduction
  // row), column group u. a_off: each x row's offset for the pixel block
  // being copied (-1 outside the image), set at its first chunk. Element
  // offsets fit an int (the launcher checks).
  static_assert(NT % G == 0 && NT % CB == 0, "a thread's groups are fixed");
  constexpr int A_ITEMS = ((kHalo ? 264 : kPixels) * G + NT - 1) / NT;
  constexpr int W_ITEMS = TAPS * KC * CB / NT;
  static_assert(W_ITEMS * NT == TAPS * KC * CB, "w items tile the threads");
  const int v = tid % G;
  const int u = tid % CB;
  const int w_col = k0 + 8 * u;
  const int w_valid = clamp8(s.k - w_col);
  int a_off[A_ITEMS];
  auto set_rows = [&](int p) {
    int r0 = 0, col0 = 0;
    if (kHalo) patch_origin(p, t, r0, col0);
#pragma unroll
    for (int j = 0; j < A_ITEMS; ++j) {
      const int r = (tid + j * NT) / G;
      int px = -1;
      if (kHalo)
        px = dl4j_mma::halo_pixel(r, r0, col0, t, rows_t, s.wo);
      else if (p * kPixels + r < rows_m)
        px = in_pixel(p * kPixels + r, s);
      a_off[j] = px < 0 ? -1 : px * s.c;
    }
  };
  auto issue = [&](int g) {   // one copy group, empty past the last
    const int buf = g % S;
    if (g < total) {
      const int i = g / chunks;
      const int kc = g - i * chunks;
      if (kc == 0) set_rows(slot + i * s.slots);
      const int ch = kc * KC + 8 * v;
      const int ch_valid = clamp8(s.c - ch);
#pragma unroll
      for (int j = 0; j < A_ITEMS; ++j) {
        const int it = tid + j * NT;
        if (it >= rows_a * G) continue;
        copy8(Rx + buf * rows_a * KC + it * 8, x, a_off[j] + ch,
              a_off[j] < 0 ? 0 : ch_valid, vec);
      }
#pragma unroll
      for (int j = 0; j < W_ITEMS; ++j) {
        const int r = (tid + j * NT) / CB;
        const int tap = r / KC;
        const int rr = kc * KC + r - tap * KC;   // the reduction channel
        copy8(Bs + (buf * TAPS * KC + r) * BS + 8 * u, w,
              (tap * s.c + rr) * s.k + w_col, rr < s.c ? w_valid : 0, vec);
      }
    }
    cp_async_commit();
  };
  for (int g = 0; g < S - 1; ++g) issue(g);
  for (int i = tid; i < AS; i += NT) zero[i] = __float2bfloat16_rn(0.f);

  // This lane's A rows: fragment f reads output pixel q = 64 wm + 16 f +
  // (lane & 15); for the 3x3, its halo index.
  int hb[kFragM];
#pragma unroll
  for (int f = 0; f < kFragM; ++f) {
    const int q = 64 * wm + 16 * f + (lane & 15);
    hb[f] = kHalo ? (q / t.tw + 1) * (t.tw + 2) + (q % t.tw + 1) : q;
  }
  // kBias: the bias of the columns this lane's fragments hold (0 past K)
  float bcol[kFragN][2];
#pragma unroll
  for (int n = 0; n < kFragN; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + wn * 32 + 8 * n + (lane & 3) * 2 + e;
      bcol[n][e] = (!kSum && col < s.k) ? __ldg(bias + col) : 0.f;
    }
  // the epilogue's share: 8 channels of every RSTEP-th row, and (kSums)
  // their sums over the stored values of all the block's pixel blocks
  constexpr int RSTEP = NT / CB;
  const int cb = k0 + 8 * u;
  const int nvalid = clamp8(s.k - cb);
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;

  int g = 0;   // the sequence index of the chunk being multiplied
  for (int i = 0; i < mine; ++i) {
    const int p = slot + i * s.slots;
    int r0 = 0, col0 = 0;
    if (kHalo) patch_origin(p, t, r0, col0);
    // the taps that read inside the image: tap (kh, kw) reads z at (oh +
    // kh - 1, ow + kw - 1); a tap outside (or in the next image of the
    // tall one), or a pixel outside, reads the zero row
    unsigned taps_ok[kFragM];
#pragma unroll
    for (int f = 0; f < kFragM; ++f) {
      taps_ok[f] = 1u;
      if (kHalo) {
        const int q = 64 * wm + 16 * f + (lane & 15);
        unsigned ok = 0u;
        if (dl4j_mma::patch_pixel(q, r0, col0, t, rows_t, s.wo) >= 0) {
          const int oh = (r0 + q / t.tw) % s.ho;
          const int ow = col0 + q % t.tw;
          for (int tap = 0; tap < 9; ++tap) {
            const int sh = oh + tap / 3 - 1;
            const int sw = ow + tap % 3 - 1;
            if (sh >= 0 && sh < s.ho && sw >= 0 && sw < s.wo)
              ok |= 1u << tap;
          }
        }
        taps_ok[f] = ok;
      }
    }

    // acc: the tile's sums, promoted every chunk (4 or 9 steps of 16)
    // with f32 adds (round to nearest); part: the tensor cores' sums
    // since, whose accumulation rounds toward zero
    float acc[kFragM][kFragN][4], part[kFragM][kFragN][4];
#pragma unroll
    for (int f = 0; f < kFragM; ++f)
#pragma unroll
      for (int n = 0; n < kFragN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][n][e] = part[f][n][e] = 0.f;

    for (int kc = 0; kc < chunks; ++kc, ++g) {
      const int buf = g % S;
      const int ch = kc * KC + 8 * v;
      float cz[2][8];
      z_constants(sc, bb, s.c, ch, cz);
      cp_async_wait<S - 2>();
      __syncthreads();   // chunk g copied; the last products done
      issue(g + S - 1);
      // z of chunk g, once per staged element (rows outside the image
      // are read by no tap, or feed output rows never stored)
      const bf16* rx = Rx + buf * rows_a * KC;
      const int cvalid = clamp8(s.c - ch);
#pragma unroll
      for (int j = 0; j < A_ITEMS; ++j) {
        const int it = tid + j * NT;
        if (it >= rows_a * G) continue;
        *reinterpret_cast<uint4*>(As + (it / G) * AS + 8 * v) =
            z8(*reinterpret_cast<const uint4*>(rx + it * 8), cz, cvalid,
               s.relu, true);
      }
      __syncthreads();
      const bf16* bs = Bs + buf * TAPS * KC * BS;
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const int toff =
            kHalo ? (tap / 3 - 1) * (t.tw + 2) + (tap % 3 - 1) : 0;
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
                bs + (tap * KC + ks * 16 + dl4j_mma::b_trans_k(lane)) * BS +
                wn * 32 + 16 * h2 + dl4j_mma::b_trans_n(lane));
          warp_k16<false, true>(part, a, b);
        }
      }
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

    // epilogue: the tile (kBias: plus the bias, f32) rounded to bf16
    // through shared memory, then per thread 8 channels of a row stored
    // as 16 bytes and (kSums) the stored values summed
    if (chunks == 0) __syncthreads();   // else a chunk's barrier: the
                                        // last tile's rows are read
#pragma unroll
    for (int f = 0; f < kFragM; ++f)
#pragma unroll
      for (int n = 0; n < kFragN; ++n) {
        const int row = 64 * wm + 16 * f + (lane >> 2);
        const int col = wn * 32 + 8 * n + (lane & 3) * 2;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = kSum ? acc[f][n][e] : __fadd_rn(acc[f][n][e], bcol[n][e & 1]);
        *reinterpret_cast<uint32_t*>(Os + row * OS + col) =
            dl4j_mma::pack2(o[0], o[1]);
        *reinterpret_cast<uint32_t*>(Os + (row + 8) * OS + col) =
            dl4j_mma::pack2(o[2], o[3]);
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPixels / RSTEP; ++j) {
      const int r = tid / CB + j * RSTEP;
      int m = -1;
      if (kHalo)
        m = dl4j_mma::patch_pixel(r, r0, col0, t, rows_t, s.wo);
      else if (p * kPixels + r < rows_m)
        m = p * kPixels + r;
      if (m < 0 || nvalid == 0) continue;
      const uint4 o = *reinterpret_cast<const uint4*>(Os + r * OS + 8 * u);
      store8(out, m * s.k + cb, nvalid, vec, o);
      if (kSum) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e < nvalid) {
            const float of = elem(o, e);
            s1[e] += of;
            s2[e] += of * of;
          }
        }
      }
    }
  }
  if (!kSum) return;
  // the block's partial sums: the RSTEP row groups in order
  __syncthreads();   // every row read: Os takes the sums
  float* red1 = reinterpret_cast<float*>(Os);   // [RSTEP][BN]
  float* red2 = red1 + RSTEP * BN;              // [RSTEP][BN]
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red1[(tid / CB) * BN + 8 * u + e] = s1[e];
    red2[(tid / CB) * BN + 8 * u + e] = s2[e];
  }
  __syncthreads();
  if (tid < BN && k0 + tid < s.k) {
    float a = 0.f, b2 = 0.f;
    for (int rg = 0; rg < RSTEP; ++rg) {
      a += red1[rg * BN + tid];
      b2 += red2[rg * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(k0 + tid) * s.tiles + slot;
    part1[at] = a;
    part2[at] = b2;
  }
}

// Bytes of shared memory the kernel takes.
template <int TAPS, int WN>
size_t fwd_smem(const Fwd& s) {
  constexpr int BN = 32 * WN;
  constexpr int KC = fwd_kc<TAPS>();
  constexpr int S = fwd_stages<TAPS, WN>();
  const int rows_a =
      TAPS == 9 ? (s.tile.th + 2) * (s.tile.tw + 2) : kPixels;
  return (static_cast<size_t>(KC + 8) * (1 + rows_a) +
          static_cast<size_t>(S) * TAPS * KC * (BN + 8) +
          static_cast<size_t>(S) * rows_a * KC +
          static_cast<size_t>(kPixels) * (BN + 8)) * sizeof(bf16);
}

// The block shape: 64 output channels up to K = 64 (four warps, two
// blocks an SM), else 128 (eight warps, one block an SM: their
// registers). bottleneck.py's _fwd_tc_plan mirrors it.
constexpr int fwd_wn(int k) { return k <= 64 ? 2 : 4; }
constexpr int fwd_blocks_per_sm(int wn) { return wn == 2 ? 2 : 1; }

// The grid's block rows: the fewest rounds of pixel blocks, a round
// being one pixel block in each block the card holds at once. With w
// waves of the grid's blocks, the most rows that fit are q = w cap /
// cols (cap = blocks an SM x SMs), and a block walks ceil(patches / q)
// pixel blocks: rounds = w ceil(patches / q). Ties go to fewer waves (a
// block walking more pixel blocks keeps its ring in flight between
// them); one wave where cols > cap.
inline int fwd_slots(int patches, int k, int sms) {
  const int wn = fwd_wn(k);
  const int cols = (k + 32 * wn - 1) / (32 * wn);
  const int64_t cap = static_cast<int64_t>(fwd_blocks_per_sm(wn)) * sms;
  int best = 1;
  int64_t best_rounds = INT64_MAX;
  for (int64_t w = 1;; ++w) {
    int64_t q = w * cap / cols;
    q = q < 1 ? 1 : q > patches ? patches : q;
    const int64_t rounds = w * ((patches + q - 1) / q);
    if (rounds < best_rounds) {
      best_rounds = rounds;
      best = static_cast<int>(q);
    }
    if (q == patches) break;
  }
  return best;
}

// Launch the kernel over s.slots block rows of the column tiles.
template <int TAPS, int WN, int EPI>
int launch_fwd(const void* x, const void* sc, const void* bb, const void* w,
               const void* bias, void* out, void* part1, void* part2, Fwd s,
               cudaStream_t st) {
  constexpr int BN = 32 * WN;
  s.cols = (s.k + BN - 1) / BN;
  const int64_t blocks = static_cast<int64_t>(s.slots) * s.cols;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fwd_smem<TAPS, WN>(s);
  auto kernel = fwd_tc_kernel<TAPS, WN, EPI>;
  static size_t granted = 0;
  const int err = set_smem(kernel, bytes, granted);
  if (err) return err;
  kernel<<<static_cast<unsigned>(blocks), 64 * WN, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(sc),
      static_cast<const float*>(bb), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out),
      static_cast<float*>(part1), static_cast<float*>(part2), s);
  return static_cast<int>(cudaGetLastError());
}

// The block shape for K, then the launch.
template <int TAPS, int EPI>
int launch_fwd_for(const void* x, const void* sc, const void* bb,
                   const void* w, const void* bias, void* out, void* part1,
                   void* part2, const Fwd& s, cudaStream_t st) {
  return fwd_wn(s.k) == 2
             ? launch_fwd<TAPS, 2, EPI>(x, sc, bb, w, bias, out, part1,
                                        part2, s, st)
             : launch_fwd<TAPS, 4, EPI>(x, sc, bb, w, bias, out, part1,
                                        part2, s, st);
}

// The conv's geometry and pixel blocks (the 1x1: runs of kPixels output
// pixels; the 3x3: the patches of the tall image).
template <int TAPS>
Fwd fwd_geometry(int n, int h, int wd, int c, int k, int stride, int relu,
                 int vec, int tiles) {
  Fwd s{n, h, wd, c, h / stride, wd / stride, k, stride, relu, vec,
        Tiling{0, 0, 0, 0}, 1, 1, tiles};
  if (TAPS == 9)
    s.tile = dl4j_mma::patch_tiling(n * s.ho, s.wo, kPixels);
  else
    s.tile.patches = (n * s.ho * s.wo + kPixels - 1) / kPixels;
  return s;
}

// Bytes of dynamic shared memory a conv of TAPS (1 or 9) launches with.
inline size_t fwd_smem_for(int n, int h, int wd, int k, int stride,
                           int taps) {
  const Fwd s = taps == 9
                    ? fwd_geometry<9>(n, h, wd, 8, k, 1, 1, 1, 0)
                    : fwd_geometry<1>(n, h, wd, 8, k, stride, 1, 1, 0);
  if (taps == 9)
    return fwd_wn(k) == 2 ? fwd_smem<9, 2>(s) : fwd_smem<9, 4>(s);
  return fwd_wn(k) == 2 ? fwd_smem<1, 2>(s) : fwd_smem<1, 4>(s);
}

}  // namespace dl4j_fwd
