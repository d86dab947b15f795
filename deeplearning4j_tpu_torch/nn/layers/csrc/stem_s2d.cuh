// The stem's space-to-depth halo tile, shared by its two bf16
// tensor-core kernels on Hopper (sm_90a): the forward conv (stem.cu,
// conv_tc) and the weight gradient (stem_bwd.cu, dw_tc).
//
// In s2d coordinates the 7x7/2 conv over an input zero-padded by 3 is a
// 4x4/1 conv: s2d pixel (u, v) holds, as channel phase C + c (phase = 2
// pr + pc, phase-major), x at (2 u - 3 + pr, 2 v - 3 + pc), channel c,
// and 0 outside the image. Both kernels walk output patches of 8 x 16
// pixels; a patch at output row oh0, column ow0 reads the 11 x 19 s2d
// pixels (oh0 + hu, ow0 + hv), hu < 11, hv < 19 (its taps' shifted
// windows), each as one 48-byte row of the halo tile: the 4 C <= 16
// channels, zeros up to 16, 8 more of padding (so the eight rows of one
// ldmatrix phase hit eight distinct bank groups).
//
// Staging takes two steps:
//   - issue_rows: the 22 x rows under the halo, each the whole 16-byte
//     chunks of x from the one holding the row's first element under the
//     halo (cp.async, zero-filled past x's end, or element by element
//     where x is not 16-byte aligned), into a [22][160] bf16 stage; rows
//     outside the image are not copied (no element of them is read);
//   - rearrange: the stage's raw elements into the halo tile, a thread
//     taking 8 of a pixel's 16 channels (each channel's phase and input
//     channel precomputed once by channel_codes), zeros outside the
//     image and past 4 C.

#pragma once

#include "conv_mma.cuh"

namespace dl4j_s2d {

using dl4j_mma::bf16;
using dl4j_mma::smem_addr;

constexpr int kTh = 8;                   // output patch: 8 rows ...
constexpr int kTw = 16;                  // ... of 16 pixels
constexpr int kPatch = kTh * kTw;        // 128 output pixels
constexpr int kHh = kTh + 3;             // the s2d halo the 4x4 taps read:
constexpr int kHw = kTw + 3;             //   11 x 19 s2d pixels
constexpr int kHalo = kHh * kHw;
constexpr int kHs = 24;                  // a halo row: 16 channels, padded
                                         // to 48 bytes
constexpr int kRawRows = 2 * kHh;        // the x rows under the halo: 22
constexpr int kRawCols = 2 * kHw;        // x columns under it: 38
constexpr int kRawChunks = 20;           // 16-byte chunks of a raw row:
                                         // ceil((38 C + 7) / 8) at C = 4
constexpr int kRawRow = 8 * kRawChunks;  // bf16
constexpr int kRawElems = kRawRows * kRawRow;
constexpr int kMaxC = 4;                 // 4 C <= 16
static_assert(kMaxC * kRawCols + 7 <= kRawRow, "a raw row holds its x segment");

// x [n, h, w, c] bf16 as the staging reads it.
struct Src {
  const bf16* x;
  int h, w, c;
  int x_elems;   // n h w c
  int vec;       // x 16-byte aligned: its rows by cp.async
};

// Copy 16 bytes, of which the first `bytes` from src, the rest zeros.
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Thread tid of NT copies its share of the x rows under the halo of the
// patch at (img, oh0, ow0) into st [kRawRows][kRawRow]: x columns xcl ..
// xch of rows 2 oh0 - 3 .. + 22, whole 16-byte chunks of x from the one
// holding (row, xcl). The caller commits the copy group.
template <int NT>
__device__ __forceinline__ void issue_rows(bf16* st, const Src& s, int img,
                                           int oh0, int ow0, int tid) {
  const int xc0 = 2 * ow0 - 3;
  const int xcl = max(xc0, 0);
  const int xch = min(xc0 + kRawCols, s.w);
#pragma unroll
  for (int j = 0; j < (kRawRows * kRawChunks + NT - 1) / NT; ++j) {
    const int it = tid + j * NT;
    if (it >= kRawRows * kRawChunks) continue;
    const int rr = it / kRawChunks;
    const int qq = it - rr * kRawChunks;
    const int xr = 2 * oh0 - 3 + rr;
    if (xr < 0 || xr >= s.h) continue;
    const int row = (img * s.h + xr) * s.w;
    const int q = (((row + xcl) * s.c) >> 3) + qq;
    if (8 * q >= (row + xch) * s.c) continue;
    bf16* dst = st + rr * kRawRow + 8 * qq;
    const int left = s.x_elems - 8 * q;
    if (s.vec)
      cp_async_n(dst, s.x + 8 * q, left >= 8 ? 16 : 2 * left);
    else
      *reinterpret_cast<uint4*>(dst) =
          dl4j_mma::load8(s.x, 8 * q, left >= 8 ? 8 : left, false);
  }
}

// The halo channels 8 hh .. 8 hh + 8 a thread rearranges: channel 8 hh +
// e is pixel phase (pr, pc) = ((8 hh + e) / C) / 2, % 2 and input channel
// (8 hh + e) % C, packed as cc | pc << 4 | pr << 5 (-1 past 4 C).
__device__ __forceinline__ void channel_codes(int c, int hh,
                                              int (&code)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c16 = 8 * hh + e;
    const int phase = c16 / c;
    code[e] = c16 < 4 * c ? (c16 - phase * c) | ((phase & 1) << 4) |
                                ((phase >> 1) << 5)
                          : -1;
  }
}

// Thread tid of NT (taking channels 8 (tid & 1) .. + 8, whose codes are
// `code`) fills its share of the halo tile Hs [kHalo][kHs] of the patch
// at (img, oh0, ow0) from the raw rows st: s2d pixel (hu, hv) holds x at
// (2 (oh0 + hu) - 3 + pr, 2 (ow0 + hv) - 3 + pc), channel cc.
template <int NT>
__device__ __forceinline__ void rearrange(bf16* Hs, const bf16* st,
                                          const int (&code)[8], const Src& s,
                                          int img, int oh0, int ow0,
                                          int tid) {
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(st);
  const int hh = tid & 1;
  const int xc0 = 2 * ow0 - 3;
  const int xcl = max(xc0, 0);
#pragma unroll
  for (int j = 0; j < (2 * kHalo + NT - 1) / NT; ++j) {
    const int hp = (tid >> 1) + (NT / 2) * j;
    if (hp >= kHalo) continue;
    const int hu = hp / kHw;
    const int hv = hp - hu * kHw;
    uint32_t wd[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (code[e] < 0) continue;
      const int rr = 2 * hu + ((code[e] >> 5) & 1);
      const int xr = 2 * oh0 - 3 + rr;
      const int xc = xc0 + 2 * hv + ((code[e] >> 4) & 1);
      if (xr < 0 || xr >= s.h || xc < 0 || xc >= s.w) continue;
      // the raw row starts at the chunk holding element (row, xcl)
      const int lead = (((img * s.h + xr) * s.w + xcl) * s.c) & 7;
      const uint32_t b =
          raw[rr * kRawRow + lead + (xc - xcl) * s.c + (code[e] & 15)];
      wd[e >> 1] |= b << ((e & 1) * 16);
    }
    *reinterpret_cast<uint4*>(Hs + hp * kHs + 8 * hh) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

}  // namespace dl4j_s2d
