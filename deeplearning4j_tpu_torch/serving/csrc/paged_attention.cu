// Paged-attention decode over the block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel deeplearning4j_tpu/serving/paged_kernel.py
// `_decode_kernel` (launched by `paged_attention`). It computes exactly
// that function: for each (slot s, kv head h) the reps*W grouped query
// rows attend over the row's live pages, read through the page table
// table[s, b]; query row r = rep*W + w sits at absolute position
// length - W + w and sees keys at positions <= length - W + w. Scores
// and the online softmax run in f32; masked scores are the finite
// -1e30 and their probabilities are zeroed explicitly, so a fully
// masked row (length 0) stays finite (0). p is rounded to the value
// dtype before the PV product, as the TPU kernel does; the output is
// acc / max(l, 1e-30) rounded to the query dtype.
//
// What bounds it on an H100: the bytes of the live K/V pages. A decode
// call does ~4 flops per K/V element read (one QK and one PV multiply-
// add per query row, with reps*W = 1 row in plain decode), far below
// the ~295 flops per byte where the tensor cores would become the
// limit. Per call and layer it must read about
//     sum over rows of length * Hkv * D * 2 (K and V) * bytes per value
// (2 for bf16), plus the queries and the table: 2.6 MB at the serving
// engine's shape (8 slots, 8 kv heads, D = 64, lengths up to 428), 0.8
// us at 3.35 TB/s. So at that size the time is latency: the walk down a
// row's pages. The design (paged_decode_split_kernel) reads each live
// K/V byte once and keeps the walk short: one block per (slot, kv head)
// splits the row's live pages over its 16 warps (each tile of 4 query
// rows over a share of them), so a 27-page row is two pages a warp; a
// warp loads its pages' K and V straight into registers with 16-byte
// loads, the next chunk in flight while it scores the current one, and
// keeps its own
// online softmax with no block barrier; one barrier at the end, and the
// block combines the warps' partials in a fixed order (the same bits on
// every run, no float atomics). At the engine's shape that is the whole
// design: splitting a row over blocks as well would add a cross-block
// combine to a walk of a couple of pages. At a verify shape (20 query
// rows, 16 pairs) each page is 20 rows of work and the pairs would leave
// most SMs idle, so there a pair's pages are split over up to 8 blocks
// as well, whose partials the last block to finish combines in block
// order. Dead table entries (the null page 0) are never touched.
//
// The int8 variant (paged_decode_quant_kernel) replaces
// deeplearning4j_tpu/serving/paged_kernel.py `_decode_kernel_quant`. It
// computes what that TPU kernel computes over int8 K/V pools
// (serving/quant.py) with each page's f32 power-of-two scales ks[page,
// h] and vs[page, h], read by the page id the table routed the page
// through: the query widened to f32, score = (q . k_int8) * (scale * sk),
// the same masks and online softmax in f32, pv = (p . v_int8) * sv with
// p kept in f32 (NOT rounded to a narrower dtype, unlike the kernel
// above), output acc / max(l, 1e-30) in the query dtype. Per-page scales
// commute with both dots, so this is attention over the dequantized
// pages; and since they are powers of two, scale * sk and p * sv are
// exact, so folding sv into p before the PV product changes only the f32
// summation order. What bounds it: again the bytes of the live pages,
// now one byte a K/V value plus 8 bytes of scales a live page and head
// (1.7 MB at the engine's shape, 0.5 us), so again the walk. It runs on
// the split above, the same code with the pool's element type as a
// template parameter: 16 warps (and at a verify shape up to 8 blocks) a
// (slot, kv head), a warp loading its pages' K and V as 16-byte vectors
// (16 int8 values a lane) straight into registers, the next chunk in
// flight, each page's two scales loaded with its table entry (one load a
// lane, then shuffles) and never again per key; the int8 values widen to
// f32 in registers (a byte permute into a float's mantissa and one
// subtraction, exact); a chunk never straddles two pages, so one pair of
// scales serves it (at D = 64, page 16: 4 lanes a key, a page one chunk
// of two passes). The warps' and blocks' combine is the one above.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into
// a shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(signed char x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// ---------------------------------------------------------------------
// the split decode (bf16, f32 and int8 pools)
// ---------------------------------------------------------------------
// Lanes: a key's D values are cut into vectors of VE elements (16 bytes:
// 4 f32, 8 bf16 or 16 int8 values; int8 at a tile of 4 rows 8 bytes, 8
// values, so that the 4 rows' accumulators fit in the registers; 1
// element where D or a pool's alignment does not allow a vector); lpk
// lanes (a power of two, at most 32) share a key, each holding kSlots of
// its vectors (8 values, or one vector of 16 int8), so a warp's 32 / lpk
// lane groups take 32 / lpk keys a pass, and kPasses passes make a
// chunk: the keys whose scores share one online-softmax update (one
// 16-key page at D = 64 for bf16 and int8). A chunk never straddles two
// pages.
template <typename KV, int VE>
struct Vec {
  using V = std::conditional_t<VE * sizeof(KV) == 8, uint2, uint4>;
};
template <typename KV>
struct Vec<KV, 1> {
  using V = KV;
};

template <typename KV, int VE>
__device__ __forceinline__ float elem_of(const typename Vec<KV, VE>::V& v,
                                         int e) {
  if constexpr (VE == 1) {
    return to_f32(v);
  } else if constexpr (sizeof(KV) == 4) {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  } else if constexpr (sizeof(KV) == 2) {
    const int i = e >> 1;
    const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (w >> 16) : (w & 0xffffu))));
  } else {
    // int8: the byte, its sign bit flipped (b + 128), as the low mantissa
    // byte of 2^23; less 2^23 + 128 that is b, exactly
    const int i = e >> 2;
    uint32_t w;
    if constexpr (VE == 8)
      w = i == 0 ? v.x : v.y;
    else
      w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u,
                                       0x7540u | (e & 3))) -
           8388736.f;
  }
}

template <typename KV, int VE>
__device__ __forceinline__ typename Vec<KV, VE>::V load_of(const KV* p) {
  using V = typename Vec<KV, VE>::V;
  if constexpr (VE == 1)
    return *p;
  else
    return __ldg(reinterpret_cast<const V*>(p));
}

template <typename KV, int VE>
__device__ __forceinline__ typename Vec<KV, VE>::V zero_of() {
  if constexpr (VE != 1)
    return typename Vec<KV, VE>::V{};
  else if constexpr (sizeof(KV) == 1)
    return static_cast<KV>(0);
  else
    return from_f32<KV>(0.f);
}

// Warps a block (512 threads: at most 128 registers a thread).
constexpr int kSplitWarps = 16;
// Passes a chunk: 4 at 2-byte values, 2 at 4-byte ones (the same 64
// bytes of K and of V a lane), half that (at least 1) where a warp holds
// a tile of 4 rows, whose query and accumulator take the registers; 2 at
// int8 (32 values widened a lane: a 16-key page at D = 64 for one row,
// 16 values and 8 keys for a tile); 1 on the element-wise route.
template <typename KV, int VE, int RT>
__host__ __device__ constexpr int split_passes() {
  if constexpr (VE == 1)
    return 1;
  else if constexpr (sizeof(KV) == 1)
    return 2;
  else
    return static_cast<int>((RT == 1 ? 8 : 4) / sizeof(KV));
}

// Values a vector: 16 bytes, but int8 at a tile of 4 rows 8 bytes.
template <typename KV, int RT>
constexpr int vec_elems() {
  return sizeof(KV) == 1 && RT > 1 ? 8 : static_cast<int>(16 / sizeof(KV));
}

// The arguments of one launch. KV is the pools' element type: T, or
// signed char with the scale sidecars k_scales, v_scales [P, Hkv].
template <typename T, typename KV>
struct SplitArgs {
  const T* q;
  const KV* k_pool;
  const KV* v_pool;
  const float* k_scales;
  const float* v_scales;
  const int* table;
  const int* lengths;
  T* out;
  float* part;
  int* counters;
  int hkv, rw, d, ps, n_max, n_pages, qw, splits;
  float scale;
};

// `splits` blocks per (slot s, kv head h) (more than one only where the
// (slot, head) pairs would leave SMs idle and several query rows make
// the walk heavy: the wrapper's plan); their rows cut into tiles of RT,
// each tile's live pages split over the splits x wpt warps that hold it
// (block b's warp share takes pages b wpt + share + i splits wpt; wpt =
// warps / tiles, at least 1). A warp walks its pages chunk by
// chunk with no block barrier: the page ids (and an int8 pool's scales)
// come from one table load a lane (then shuffles), and the next chunk's
// K and V (16-byte loads into registers) are in flight while it scores
// the current one; lane groups cover the head dim (dot products reduced
// by shuffles); it keeps its own running (m, l, acc) in registers, p
// rounded to KV at each chunk's running max (an int8 pool: p kept in
// f32, times the page's sv), l summing the unrounded p; one query row is
// held in registers, a tile of 4 read from shared memory (f32, [tiles
// 4][d], zero rows past rw), which leaves the registers to the
// accumulators. Its partials go to shared memory: m, l [wpt][rw] and acc
// [wpt][rw][d], all f32; one barrier, and the block combines them warp
// by warp in a fixed order (a warp whose share held no key a row sees,
// l = 0, weighs exactly 0). With one block a pair that is the output.
// With several, each block writes its combined (m, l, acc) rows to the
// caller's scratch `part` [pairs splits][rw][2 + d] and counts itself
// done on `counters[pair]`; the last one combines the blocks' rows in
// block order (the same weights), writes the output and sets the
// counter back to 0 for the next launch. A table entry outside the pool
// poisons the whole (slot, head) with NaN (a block's l = NaN carries it).
template <typename T, typename KV, int VE, int RT>
__device__ __forceinline__ void split_decode(const SplitArgs<T, KV>& a) {
  constexpr bool kQuant = sizeof(KV) == 1;
  constexpr int kWarps = kSplitWarps;
  constexpr int kSlots = VE >= 8 ? 1 : 8 / VE;  // vectors a lane a key
  constexpr int kE = kSlots * VE;               // values a lane a key
  constexpr int kPasses = split_passes<KV, VE, RT>();
  using V = typename Vec<KV, VE>::V;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_bad, s_last;

  const T* __restrict__ q = a.q;
  const KV* __restrict__ k_pool = a.k_pool;
  const KV* __restrict__ v_pool = a.v_pool;
  const int hkv = a.hkv, rw = a.rw, d = a.d, ps = a.ps, n_max = a.n_max;
  const int n_pages = a.n_pages, qw = a.qw, splits = a.splits;
  const int pair = blockIdx.x / splits;
  const int split = blockIdx.x - pair * splits;
  const int s = pair / hkv;
  const int h = pair - s * hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int length = a.lengths[s];
  int n_live = length > 0 ? (length + ps - 1) / ps : 0;
  if (n_live > n_max) n_live = n_max;
  const int nv = d / VE;
  int lpk = 1;
  while (lpk < nv && lpk < 32) lpk <<= 1;
  const int kpp = 32 / lpk;
  const int kg = lane / lpk;                  // the lane's key in a pass
  const int sub = lane - kg * lpk;            // its vectors: sub + c lpk
  const int ck = kPasses * kpp;               // keys a chunk
  const int cpp = (ps + ck - 1) / ck;         // chunks a page
  const int n_rt = (rw + RT - 1) / RT;
  const int wpt = kWarps / n_rt > 1 ? kWarps / n_rt : 1;
  const int groups = kWarps / wpt;
  const int gidx = warp / wpt;
  const int slot_w = warp - gidx * wpt;          // the warp's share here
  const int share = split * wpt + slot_w;        // of the tile's
  const int stride = splits * wpt;               //   stride shares
  float* part_m = smem;                       // [wpt][rw]
  float* part_l = part_m + wpt * rw;          // [wpt][rw]
  float* part_acc = part_l + wpt * rw;        // [wpt][rw][d]
  float* q_s = part_acc + (size_t)wpt * rw * d;   // [n_rt RT][d] (RT > 1)
  const size_t q_off = ((size_t)s * hkv + h) * rw * d;
  if (threadIdx.x == 0) s_bad = 0;
  if constexpr (RT > 1) {
    for (int i = threadIdx.x; i < n_rt * RT * d; i += blockDim.x)
      q_s[i] = i < rw * d ? to_f32(q[q_off + i]) : 0.f;
  }
  __syncthreads();

  const int* trow = a.table + (size_t)s * n_max;
  const int n_my =
      share < n_live ? (n_live - share + stride - 1) / stride : 0;
  // the page ids of the warp's first 32 pages, one a lane, read whether
  // live or not (inside the row: the load need not wait for the length);
  // an int8 pool's scales of the live ones beside them
  const int tb = share + lane * stride < n_max
                     ? __ldg(trow + share + lane * stride) : 0;
  float tks = 0.f, tvs = 0.f;
  if constexpr (kQuant) {
    if (lane < n_my && tb >= 0 && tb < n_pages) {
      tks = __ldg(a.k_scales + (size_t)tb * hkv + h);
      tvs = __ldg(a.v_scales + (size_t)tb * hkv + h);
    }
  }
  bool bad = false;

  // chunk g of the warp's walk: K and V of its keys, zeros past the page
  // or the head dim, and (int8) the page's scales; false where the page
  // id is outside the pool
  auto fetch = [&](int g, V (&kd)[kPasses][kSlots],
                   V (&vd)[kPasses][kSlots], float& sk, float& sv) {
    const int pi = g / cpp;
    const int j0 = (g - pi * cpp) * ck + kg;
    const int pid = __shfl_sync(0xffffffffu, tb, pi & 31);
    const int page = pi < 32 ? pid : __ldg(trow + share + pi * stride);
    const bool ok = page >= 0 && page < n_pages;
    const size_t base = ((size_t)(ok ? page : 0) * hkv + h) * ps * d;
#pragma unroll
    for (int t = 0; t < kPasses; ++t)
#pragma unroll
      for (int c = 0; c < kSlots; ++c) {
        const int j = j0 + t * kpp;
        const int vi = sub + c * lpk;
        const bool in = ok && j < ps && vi < nv;
        const size_t at = base + (size_t)j * d + vi * VE;
        kd[t][c] = in ? load_of<KV, VE>(k_pool + at) : zero_of<KV, VE>();
        vd[t][c] = in ? load_of<KV, VE>(v_pool + at) : zero_of<KV, VE>();
      }
    if constexpr (kQuant) {
      const float k32 = __shfl_sync(0xffffffffu, tks, pi & 31);
      const float v32 = __shfl_sync(0xffffffffu, tvs, pi & 31);
      const size_t at = (size_t)(ok ? page : 0) * hkv + h;
      sk = pi < 32 ? k32 : ok ? __ldg(a.k_scales + at) : 0.f;
      sv = pi < 32 ? v32 : ok ? __ldg(a.v_scales + at) : 0.f;
    }
    return ok;
  };

  if (gidx < groups) {
    const int chunks = n_my * cpp;
    for (int rt = gidx; rt < n_rt; rt += groups) {
      // the query (one row: registers; a tile: shared memory), at the
      // lane's vectors (vector 0 past the head dim, where K is 0)
      float qr[RT == 1 ? kE : 1], acc[RT][kE], m[RT], l[RT];
      int qcol[kSlots];
#pragma unroll
      for (int c = 0; c < kSlots; ++c)
        qcol[c] = (sub + c * lpk < nv ? sub + c * lpk : 0) * VE;
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
#pragma unroll
        for (int x = 0; x < kE; ++x) acc[rr][x] = 0.f;
        m[rr] = kNegInf;
        l[rr] = 0.f;
      }
      if constexpr (RT == 1) {
#pragma unroll
        for (int c = 0; c < kSlots; ++c)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            qr[c * VE + e] = to_f32(q[q_off + (size_t)rt * d + qcol[c] + e]);
      }
      V kc[kPasses][kSlots], vc[kPasses][kSlots];   // the chunk consumed
      V kn[kPasses][kSlots], vn[kPasses][kSlots];   // the next, in flight
      float skc = 0.f, svc = 0.f, skn = 0.f, svn = 0.f;
      bool ok_n = chunks > 0 ? fetch(0, kn, vn, skn, svn) : true;
      for (int g = 0; g < chunks; ++g) {
#pragma unroll
        for (int t = 0; t < kPasses; ++t)
#pragma unroll
          for (int c = 0; c < kSlots; ++c) {
            kc[t][c] = kn[t][c];
            vc[t][c] = vn[t][c];
          }
        skc = skn;
        svc = svn;
        const bool ok = ok_n;
        if (g + 1 < chunks) ok_n = fetch(g + 1, kn, vn, skn, svn);
        if (!ok) {
          bad = true;
          continue;
        }
        // exact: sk is a power of two
        const float kscale = kQuant ? a.scale * skc : a.scale;
        const int pi = g / cpp;
        const int j0 = (g - pi * cpp) * ck + kg;      // the lane's first key
        const int pos0 = (share + pi * stride) * ps + j0;  // its position
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          const int last = length - qw + (rt * RT + rr) % qw;
          float sc[kPasses];
          bool valid[kPasses];
          float cmax = kNegInf;
#pragma unroll
          for (int t = 0; t < kPasses; ++t) {
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < kSlots; ++c)
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                float qv;
                if constexpr (RT == 1)
                  qv = qr[c * VE + e];
                else
                  qv = q_s[(rt * RT + rr) * d + qcol[c] + e];
                dot = fmaf(qv, elem_of<KV, VE>(kc[t][c], e), dot);
              }
            for (int o = lpk >> 1; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            valid[t] = j0 + t * kpp < ps && pos0 + t * kpp <= last;
            sc[t] = valid[t] ? dot * kscale : kNegInf;
            cmax = fmaxf(cmax, sc[t]);
          }
          for (int o = lpk; o < 32; o <<= 1)
            cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
          const float m_new = fmaxf(m[rr], cmax);
          const float corr = expf(m[rr] - m_new);
          float psum = 0.f, pr[kPasses];
#pragma unroll
          for (int t = 0; t < kPasses; ++t) {
            // explicit zeroing: a row whose whole chunk is masked would
            // see exp(-1e30 - -1e30) = 1
            const float p = valid[t] ? expf(sc[t] - m_new) : 0.f;
            psum += p;
            if constexpr (kQuant)
              pr[t] = p * svc;        // exact: sv is a power of two
            else
              pr[t] = to_f32(from_f32<KV>(p));
          }
          l[rr] = l[rr] * corr + psum;
#pragma unroll
          for (int c = 0; c < kSlots; ++c)
#pragma unroll
            for (int e = 0; e < VE; ++e) {
              float acc_e = acc[rr][c * VE + e] * corr;
#pragma unroll
              for (int t = 0; t < kPasses; ++t)
                acc_e = fmaf(pr[t], elem_of<KV, VE>(vc[t][c], e), acc_e);
              acc[rr][c * VE + e] = acc_e;
            }
          m[rr] = m_new;
        }
      }
      // the lane groups' sums (each group's keys), then the partials
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        for (int o = lpk; o < 32; o <<= 1) {
          l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], o);
#pragma unroll
          for (int x = 0; x < kE; ++x)
            acc[rr][x] += __shfl_xor_sync(0xffffffffu, acc[rr][x], o);
        }
        const int r = rt * RT + rr;
        if (r >= rw) continue;
        const int at = slot_w * rw + r;
        if (lane == 0) {
          part_m[at] = m[rr];
          part_l[at] = l[rr];
        }
        if (kg == 0) {
#pragma unroll
          for (int c = 0; c < kSlots; ++c) {
            const int vi = sub + c * lpk;
            if (vi >= nv) continue;
#pragma unroll
            for (int e = 0; e < VE; ++e)
              part_acc[(size_t)at * d + vi * VE + e] = acc[rr][c * VE + e];
          }
        }
      }
    }
  }
  if (bad && lane == 0) s_bad = 1;
  __syncthreads();

  // the block's combine: its warps 0, 1, ... in order
  const bool poisoned = s_bad != 0;
  const int prow = d + 2;                        // a row of `part`
  float* mine = a.part + (size_t)blockIdx.x * rw * prow;
  for (int i = threadIdx.x; i < rw * d; i += blockDim.x) {
    const int r = i / d;
    float mx = kNegInf;
    for (int w = 0; w < wpt; ++w) mx = fmaxf(mx, part_m[w * rw + r]);
    float acc_i = 0.f, lsum = 0.f;
    for (int w = 0; w < wpt; ++w) {
      const float lw = part_l[w * rw + r];
      const float wt = lw > 0.f ? expf(part_m[w * rw + r] - mx) : 0.f;
      acc_i += part_acc[(size_t)(w * rw + r) * d + i - r * d] * wt;
      lsum += lw * wt;
    }
    if (splits == 1) {
      a.out[q_off + i] =
          from_f32<T>(poisoned ? NAN : acc_i / fmaxf(lsum, 1e-30f));
    } else {
      mine[r * prow + 2 + i - r * d] = acc_i;
      if (i == r * d) {
        mine[r * prow] = mx;
        mine[r * prow + 1] = poisoned ? NAN : lsum;
      }
    }
  }
  if (splits == 1) return;

  // the blocks' combine, by the last block of the pair to finish
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(a.counters + pair, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* rows = a.part + (size_t)pair * splits * rw * prow;
  for (int i = threadIdx.x; i < rw * d; i += blockDim.x) {
    const int r = i / d;
    float mx = kNegInf;
    bool nan_l = false;
    for (int b = 0; b < splits; ++b) {
      const float* row = rows + (size_t)(b * rw + r) * prow;
      mx = fmaxf(mx, __ldcg(row));
      nan_l |= isnan(__ldcg(row + 1));
    }
    float acc_i = 0.f, lsum = 0.f;
    for (int b = 0; b < splits; ++b) {
      const float* row = rows + (size_t)(b * rw + r) * prow;
      const float lb = __ldcg(row + 1);
      const float wt = lb > 0.f ? expf(__ldcg(row) - mx) : 0.f;
      acc_i += __ldcg(row + 2 + i - r * d) * wt;
      lsum += lb * wt;
    }
    a.out[q_off + i] =
        from_f32<T>(nan_l ? NAN : acc_i / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) a.counters[pair] = 0;
}

// The bf16 / f32 pools' kernel and the int8 pool's: one body, two names
// (the serve profiles tell the two apart by name).
template <typename T, int VE, int RT>
__global__ void __launch_bounds__(32 * kSplitWarps)
    paged_decode_split_kernel(const SplitArgs<T, T> a) {
  split_decode<T, T, VE, RT>(a);
}

template <typename T, int VE, int RT>
__global__ void __launch_bounds__(32 * kSplitWarps)
    paged_decode_quant_kernel(const SplitArgs<T, signed char> a) {
  split_decode<T, signed char, VE, RT>(a);
}

// Shared memory of the split decode: the warps' partials, and a tiled
// query's rows, f32.
template <int RT>
size_t split_smem(int rw, int d) {
  const int n_rt = (rw + RT - 1) / RT;
  const int wpt = kSplitWarps / n_rt > 1 ? kSplitWarps / n_rt : 1;
  return sizeof(float) * ((size_t)wpt * rw * (d + 2) +
                          (RT > 1 ? (size_t)n_rt * RT * d : 0));
}

template <typename T, typename KV, int VE, int RT>
int launch_split(const SplitArgs<T, KV>& a, int slots, cudaStream_t st) {
  void (*kernel)(const SplitArgs<T, KV>);
  if constexpr (sizeof(KV) == 1)
    kernel = paged_decode_quant_kernel<T, VE, RT>;
  else
    kernel = paged_decode_split_kernel<T, VE, RT>;
  const size_t smem = split_smem<RT>(a.rw, a.d);
  if (smem > (size_t)kMaxDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<slots * a.hkv * a.splits, 32 * kSplitWarps, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// One launch: vectors (vec_elems) where D is a whole number of them and
// both pools are aligned to one, else element by element; one query row,
// or tiles of 4; `splits` blocks a (slot, head) (the wrapper's plan,
// paged_kernel.decode_split_plan), which above 1 need the scratch `part`
// [slots hkv splits][rw][2 + d] f32 and `counters` [slots hkv] int32,
// zero on entry (and left zero). KV signed char: the int8 pools, with
// their scales. Refuses (before any launch) D outside 1 .. 256, splits
// outside 1 .. 64, several splits without scratch, and int8 pools
// without scales.
template <typename T, typename KV>
int launch(const SplitArgs<T, KV>& a, int slots, void* stream) {
  if (a.d < 1 || a.d > 256 || a.ps < 1 || a.splits < 1 || a.splits > 64 ||
      (a.splits > 1 && (a.part == nullptr || a.counters == nullptr)) ||
      (sizeof(KV) == 1 && (a.k_scales == nullptr || a.v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (slots <= 0 || a.hkv <= 0 || a.rw <= 0) return (int)cudaGetLastError();
  constexpr int kVe1 = vec_elems<KV, 1>(), kVe4 = vec_elems<KV, 4>();
  const int ve = a.rw == 1 ? kVe1 : kVe4;
  const size_t bytes = ve * sizeof(KV);
  const bool vec = a.d % ve == 0 &&
                   reinterpret_cast<size_t>(a.k_pool) % bytes == 0 &&
                   reinterpret_cast<size_t>(a.v_pool) % bytes == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rw == 1)
    return vec ? launch_split<T, KV, kVe1, 1>(a, slots, st)
               : launch_split<T, KV, 1, 1>(a, slots, st);
  return vec ? launch_split<T, KV, kVe4, 4>(a, slots, st)
             : launch_split<T, KV, 1, 4>(a, slots, st);
}

template <typename T, typename KV>
int launch_any(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scales, const void* v_scales,
               const void* table, const void* lengths, void* out,
               void* part, void* counters, int slots, int hkv, int rw,
               int d, int ps, int n_max, int n_pages, int qw, int splits,
               float scale, void* stream) {
  const SplitArgs<T, KV> a{
      static_cast<const T*>(q),        static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool),  static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(table),  static_cast<const int*>(lengths),
      static_cast<T*>(out),            static_cast<float*>(part),
      static_cast<int*>(counters),     hkv, rw, d, ps, n_max, n_pages, qw,
      splits,                          scale};
  return launch<T, KV>(a, slots, stream);
}

}  // namespace

extern "C" {

int dl4j_paged_attention_f32(const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* lengths, void* out, void* part,
                             void* counters, int slots, int hkv, int rw,
                             int d, int ps, int n_max, int n_pages, int qw,
                             int splits, float scale, void* stream) {
  return launch_any<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                  table, lengths, out, part, counters,
                                  slots, hkv, rw, d, ps, n_max, n_pages, qw,
                                  splits, scale, stream);
}

int dl4j_paged_attention_bf16(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* lengths, void* out, void* part,
                              void* counters, int slots, int hkv, int rw,
                              int d, int ps, int n_max, int n_pages, int qw,
                              int splits, float scale, void* stream) {
  return launch_any<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, table, lengths, out, part,
      counters, slots, hkv, rw, d, ps, n_max, n_pages, qw, splits, scale,
      stream);
}

int dl4j_paged_attention_quant_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scales,
                                   const void* v_scales, const void* table,
                                   const void* lengths, void* out,
                                   void* part, void* counters, int slots,
                                   int hkv, int rw, int d, int ps,
                                   int n_max, int n_pages, int qw,
                                   int splits, float scale, void* stream) {
  return launch_any<float, signed char>(
      q, k_pool, v_pool, k_scales, v_scales, table, lengths, out, part,
      counters, slots, hkv, rw, d, ps, n_max, n_pages, qw, splits, scale,
      stream);
}

int dl4j_paged_attention_quant_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scales,
                                    const void* v_scales, const void* table,
                                    const void* lengths, void* out,
                                    void* part, void* counters, int slots,
                                    int hkv, int rw, int d, int ps,
                                    int n_max, int n_pages, int qw,
                                    int splits, float scale, void* stream) {
  return launch_any<__nv_bfloat16, signed char>(
      q, k_pool, v_pool, k_scales, v_scales, table, lengths, out, part,
      counters, slots, hkv, rw, d, ps, n_max, n_pages, qw, splits, scale,
      stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
