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
// The int8 variant (paged_decode_quant_kernel below) replaces
// deeplearning4j_tpu/serving/paged_kernel.py `_decode_kernel_quant`. It
// keeps the first design of the decode: one 4-warp block per (slot, kv
// head) walks the row's pages one at a time, each staged in shared
// memory behind block barriers (the split above is not yet carried over;
// ROADMAP queue B), over int8 K/V pools (serving/quant.py), each page's f32
// power-of-two scales ks[page, h] and vs[page, h] read by the page id the
// table routed the block through. It computes what the TPU kernel
// computes: the query widened to f32, score = (q . k_int8) * (scale * sk),
// the same masks and online softmax in f32, pv = (p . v_int8) * sv with p
// kept in f32 (NOT rounded to a narrower dtype, unlike the kernel above),
// output acc / max(l, 1e-30) in the query dtype. Per-page scales commute
// with both dots, so this is attention over the dequantized pages.
// What bounds it: again the bytes of the live pages, now one byte per
// K/V value (plus 8 bytes of scales per live page and head). The pages
// stay int8 in shared memory (a page of 16 x 64 values is 1 KB), are
// loaded with 16-byte vector loads where the page's bytes allow it, and
// are widened to f32 in registers at the dot products.
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

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxDefaultSmem = 48 * 1024;

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
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------
// the split decode (bf16 and f32 pools)
// ---------------------------------------------------------------------
// Lanes: a key's D values are cut into vectors of VE elements (16 bytes;
// 1 element where D or a pool's alignment does not allow 16); lpk lanes
// (a power of two, at most 32) share a key, each holding up to 8 / VE of
// its vectors, so a warp's 32 / lpk lane groups take 32 / lpk keys a
// pass, and kPasses passes make a chunk: the keys whose scores share one
// online-softmax update (one 16-key page at bf16, D = 64).
template <typename T, int VE>
struct Vec {
  using V = uint4;   // 16 bytes
};
template <typename T>
struct Vec<T, 1> {
  using V = T;
};

template <typename T, int VE>
__device__ __forceinline__ float elem_of(const typename Vec<T, VE>::V& v,
                                         int e) {
  if constexpr (VE == 1) {
    return to_f32(v);
  } else if constexpr (sizeof(T) == 4) {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  } else {
    const int i = e >> 1;
    const uint32_t w = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (w >> 16) : (w & 0xffffu))));
  }
}

template <typename T, int VE>
__device__ __forceinline__ typename Vec<T, VE>::V load_of(const T* p) {
  if constexpr (VE == 1)
    return *p;
  else
    return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T, int VE>
__device__ __forceinline__ typename Vec<T, VE>::V zero_of() {
  if constexpr (VE == 1)
    return from_f32<T>(0.f);
  else
    return make_uint4(0u, 0u, 0u, 0u);
}

// Warps a block (512 threads: at most 128 registers a thread).
constexpr int kSplitWarps = 16;
// Passes a chunk: 4 at 2-byte values, 2 at 4-byte ones (the same 64
// bytes of K and of V a lane), 1 on the element-wise route; half that
// (at least 1) where a warp holds a tile of 4 rows, whose query and
// accumulator take the registers.
template <typename T, int VE, int RT>
__host__ __device__ constexpr int split_passes() {
  return VE == 1 ? 1
                 : static_cast<int>((RT == 1 ? 8 : 4) / sizeof(T));
}

// `splits` blocks per (slot s, kv head h) (more than one only where the
// (slot, head) pairs would leave SMs idle and several query rows make
// the walk heavy: the wrapper's plan); their rows cut into tiles of RT,
// each tile's live pages split over the splits x wpt warps that hold it
// (block b's warp share takes pages b wpt + share + i splits wpt; wpt =
// warps / tiles, at least 1). A warp walks its pages chunk by
// chunk with no block barrier: the page ids come from one table load a
// lane (then shuffles), and the next chunk's K and V (16-byte loads into
// registers) are in flight while it scores the current one; lane groups
// cover the head dim (dot products reduced by shuffles); it keeps its
// own running (m, l, acc) in registers, p rounded to T at each chunk's
// running max, l summing the unrounded p; one query row is held in
// registers, a tile of 4 read from shared memory (f32, [tiles 4][d],
// zero rows past rw), which leaves the registers to the accumulators.
// Its partials go to shared memory: m, l [wpt][rw] and acc [wpt][rw][d],
// all f32; one barrier, and the block combines them warp by warp in a
// fixed order (a warp whose share held no key a row sees, l = 0, weighs
// exactly 0). With one block a pair that is the output. With several,
// each block writes its combined (m, l, acc) rows to the caller's
// scratch `part` [pairs splits][rw][2 + d] and counts itself done on
// `counters[pair]`; the last one combines the blocks' rows in block
// order (the same weights), writes the output and sets the counter back
// to 0 for the next launch. A table entry outside the pool poisons the
// whole (slot, head) with NaN (a block's l = NaN carries it).
template <typename T, int VE, int RT>
__global__ void __launch_bounds__(32 * kSplitWarps)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, float* __restrict__ part,
                              int* __restrict__ counters, int hkv, int rw,
                              int d, int ps, int n_max, int n_pages, int qw,
                              int splits, float scale) {
  constexpr int kWarps = kSplitWarps;
  constexpr int kSlots = 8 / VE;              // vectors a lane a key
  constexpr int kE = kSlots * VE;             // values a lane a key: 8
  constexpr int kPasses = split_passes<T, VE, RT>();
  using V = typename Vec<T, VE>::V;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_bad, s_last;

  const int pair = blockIdx.x / splits;
  const int split = blockIdx.x - pair * splits;
  const int s = pair / hkv;
  const int h = pair - s * hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int length = lengths[s];
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

  const int* trow = table + (size_t)s * n_max;
  const int n_my =
      share < n_live ? (n_live - share + stride - 1) / stride : 0;
  // the page ids of the warp's first 32 pages, one a lane, read whether
  // live or not (inside the row: the load need not wait for the length)
  const int tb = share + lane * stride < n_max
                     ? __ldg(trow + share + lane * stride) : 0;
  bool bad = false;

  // chunk g of the warp's walk: K and V of its keys, zeros past the page
  // or the head dim; false where the page id is outside the pool
  auto fetch = [&](int g, V (&kd)[kPasses][kSlots],
                   V (&vd)[kPasses][kSlots]) {
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
        kd[t][c] = in ? load_of<T, VE>(k_pool + at) : zero_of<T, VE>();
        vd[t][c] = in ? load_of<T, VE>(v_pool + at) : zero_of<T, VE>();
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
      bool ok_n = chunks > 0 ? fetch(0, kn, vn) : true;
      for (int g = 0; g < chunks; ++g) {
#pragma unroll
        for (int t = 0; t < kPasses; ++t)
#pragma unroll
          for (int c = 0; c < kSlots; ++c) {
            kc[t][c] = kn[t][c];
            vc[t][c] = vn[t][c];
          }
        const bool ok = ok_n;
        if (g + 1 < chunks) ok_n = fetch(g + 1, kn, vn);
        if (!ok) {
          bad = true;
          continue;
        }
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
                dot = fmaf(qv, elem_of<T, VE>(kc[t][c], e), dot);
              }
            for (int o = lpk >> 1; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            valid[t] = j0 + t * kpp < ps && pos0 + t * kpp <= last;
            sc[t] = valid[t] ? dot * scale : kNegInf;
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
            pr[t] = to_f32(from_f32<T>(p));
          }
          l[rr] = l[rr] * corr + psum;
#pragma unroll
          for (int c = 0; c < kSlots; ++c)
#pragma unroll
            for (int e = 0; e < VE; ++e) {
              float a = acc[rr][c * VE + e] * corr;
#pragma unroll
              for (int t = 0; t < kPasses; ++t)
                a = fmaf(pr[t], elem_of<T, VE>(vc[t][c], e), a);
              acc[rr][c * VE + e] = a;
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
  float* mine = part + (size_t)blockIdx.x * rw * prow;
  for (int i = threadIdx.x; i < rw * d; i += blockDim.x) {
    const int r = i / d;
    float mx = kNegInf;
    for (int w = 0; w < wpt; ++w) mx = fmaxf(mx, part_m[w * rw + r]);
    float a = 0.f, lsum = 0.f;
    for (int w = 0; w < wpt; ++w) {
      const float lw = part_l[w * rw + r];
      const float wt = lw > 0.f ? expf(part_m[w * rw + r] - mx) : 0.f;
      a += part_acc[(size_t)(w * rw + r) * d + i - r * d] * wt;
      lsum += lw * wt;
    }
    if (splits == 1) {
      out[q_off + i] = from_f32<T>(poisoned ? NAN : a / fmaxf(lsum, 1e-30f));
    } else {
      mine[r * prow + 2 + i - r * d] = a;
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
    s_last = atomicAdd(counters + pair, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* rows = part + (size_t)pair * splits * rw * prow;
  for (int i = threadIdx.x; i < rw * d; i += blockDim.x) {
    const int r = i / d;
    float mx = kNegInf;
    bool nan_l = false;
    for (int b = 0; b < splits; ++b) {
      const float* row = rows + (size_t)(b * rw + r) * prow;
      mx = fmaxf(mx, __ldcg(row));
      nan_l |= isnan(__ldcg(row + 1));
    }
    float a = 0.f, lsum = 0.f;
    for (int b = 0; b < splits; ++b) {
      const float* row = rows + (size_t)(b * rw + r) * prow;
      const float lb = __ldcg(row + 1);
      const float wt = lb > 0.f ? expf(__ldcg(row) - mx) : 0.f;
      a += __ldcg(row + 2 + i - r * d) * wt;
      lsum += lb * wt;
    }
    out[q_off + i] = from_f32<T>(nan_l ? NAN : a / fmaxf(lsum, 1e-30f));
  }
  if (threadIdx.x == 0) counters[pair] = 0;
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

template <typename T, int VE, int RT>
int launch_split(const void* q, const void* k_pool, const void* v_pool,
                 const void* table, const void* lengths, void* out,
                 void* part, void* counters, int slots, int hkv, int rw,
                 int d, int ps, int n_max, int n_pages, int qw, int splits,
                 float scale, cudaStream_t st) {
  auto kernel = paged_decode_split_kernel<T, VE, RT>;
  const size_t smem = split_smem<RT>(rw, d);
  if (smem > (size_t)kMaxDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<slots * hkv * splits, 32 * kSplitWarps, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), hkv, rw, d,
      ps, n_max, n_pages, qw, splits, scale);
  return (int)cudaGetLastError();
}

// One launch: 16-byte vectors where D is a whole number of them and both
// pools are 16-byte aligned, else element by element; one query row, or
// tiles of 4; `splits` blocks a (slot, head) (the wrapper's plan,
// paged_kernel.decode_split_plan), which above 1 need the scratch `part`
// [slots hkv splits][rw][2 + d] f32 and `counters` [slots hkv] int32,
// zero on entry (and left zero). Refuses (before any launch) D outside 1
// .. 256, splits outside 1 .. 64, and several splits without scratch.
template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lengths, void* out, void* part,
           void* counters, int slots, int hkv, int rw, int d, int ps,
           int n_max, int n_pages, int qw, int splits, float scale,
           void* stream) {
  if (d < 1 || d > 256 || ps < 1 || splits < 1 || splits > 64 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (slots <= 0 || hkv <= 0 || rw <= 0) return (int)cudaGetLastError();
  constexpr int kVe = static_cast<int>(16 / sizeof(T));
  const bool vec = d % kVe == 0 &&
                   reinterpret_cast<size_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<size_t>(v_pool) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_SPLIT(VE, RT)                                                \
  launch_split<T, VE, RT>(q, k_pool, v_pool, table, lengths, out, part,  \
                          counters, slots, hkv, rw, d, ps, n_max, n_pages, \
                          qw, splits, scale, st)
  if (rw == 1) return vec ? DL4J_SPLIT(kVe, 1) : DL4J_SPLIT(1, 1);
  return vec ? DL4J_SPLIT(kVe, 4) : DL4J_SPLIT(1, 4);
#undef DL4J_SPLIT
}

// The int8 variant. One thread block per (slot, kv head). Shared memory:
//   q_s [rw, d] f32, p_s [rw, ps] f32, acc [rw, d] f32,
//   m_s, l_s, c_s [rw] f32 (padded to 16 bytes), then
//   k_s [ps, d] int8 and v_s [ps, d] int8 (each padded to 16 bytes)
__host__ __device__ inline size_t quant_float_words(int rw, int d, int ps) {
  const size_t n = (size_t)2 * rw * d + (size_t)rw * ps + (size_t)3 * rw;
  return (n + 3) & ~(size_t)3;  // 16-byte aligned int8 pages after them
}
__host__ __device__ inline size_t quant_page_bytes(int ps, int d) {
  return ((size_t)ps * d + 15) & ~(size_t)15;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_quant_kernel(const T* __restrict__ q,
                              const signed char* __restrict__ k_pool,
                              const signed char* __restrict__ v_pool,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int* __restrict__ table,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int hkv, int rw, int d,
                              int ps, int n_max, int n_pages, int qw,
                              float scale, int vec16) {
  // 16-byte aligned: the int8 pages after the f32 words take int4 stores
  extern __shared__ __align__(16) float qsmem[];
  float* q_s = qsmem;
  float* p_s = q_s + rw * d;
  float* acc = p_s + rw * ps;
  float* m_s = acc + rw * d;
  float* l_s = m_s + rw;
  float* c_s = l_s + rw;
  signed char* k_s =
      reinterpret_cast<signed char*>(qsmem + quant_float_words(rw, d, ps));
  signed char* v_s = k_s + quant_page_bytes(ps, d);

  const int s = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int length = lengths[s];
  const size_t q_off = ((size_t)s * hkv + h) * rw * d;
  const int page_elems = ps * d;

  for (int i = tid; i < rw * d; i += blockDim.x) {
    q_s[i] = to_f32(q[q_off + i]);  // the query widened to f32
    acc[i] = 0.f;
  }
  for (int r = tid; r < rw; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int n_live = length > 0 ? (length + ps - 1) / ps : 0;
  if (n_live > n_max) n_live = n_max;
  bool bad_page = false;
  __syncthreads();

  for (int b = 0; b < n_live; ++b) {
    // uniform across the block: every thread reads the same entry
    const int page = table[(size_t)s * n_max + b];
    if (page < 0 || page >= n_pages) {
      bad_page = true;
      break;
    }
    const size_t base = ((size_t)page * hkv + h) * page_elems;
    const size_t srow = (size_t)page * hkv + h;
    const float kscale = scale * k_scales[srow];  // exact: sk is 2^k
    const float sv = v_scales[srow];
    if (vec16) {
      // 16 bytes a thread; the host checked the pools' alignment and
      // that a page is a whole number of 16-byte vectors
      const int4* ksrc = reinterpret_cast<const int4*>(k_pool + base);
      const int4* vsrc = reinterpret_cast<const int4*>(v_pool + base);
      int4* kdst = reinterpret_cast<int4*>(k_s);
      int4* vdst = reinterpret_cast<int4*>(v_s);
      for (int i = tid; i < page_elems / 16; i += blockDim.x) {
        kdst[i] = ksrc[i];
        vdst[i] = vsrc[i];
      }
    } else {
      for (int i = tid; i < page_elems; i += blockDim.x) {
        k_s[i] = k_pool[base + i];
        v_s[i] = v_pool[base + i];
      }
    }
    __syncthreads();

    // scores: one warp per (row, key), lanes across the head dim; the
    // int8 keys widen to f32 in registers
    for (int pair = warp; pair < rw * ps; pair += n_warps) {
      const int r = pair / ps;
      const int j = pair - r * ps;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32)
        dot += q_s[r * d + c] * static_cast<float>(k_s[j * d + c]);
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool valid = b * ps + j <= length - qw + r % qw;
        p_s[pair] = valid ? dot * kscale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row; p stays f32
    for (int r = warp; r < rw; r += n_warps) {
      float bmax = kNegInf;
      for (int j = lane; j < ps; j += 32) bmax = fmaxf(bmax, p_s[r * ps + j]);
      bmax = warp_max(bmax);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, bmax);
      const int last = length - qw + r % qw;
      float psum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float p = b * ps + j <= last ? expf(p_s[r * ps + j] - m_new) : 0.f;
        psum += p;
        p_s[r * ps + j] = p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + psum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < rw * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i - r * d;
      float pv = 0.f;
      for (int j = 0; j < ps; ++j)
        pv += p_s[r * ps + j] * static_cast<float>(v_s[j * d + c]);
      acc[i] = acc[i] * c_s[r] + pv * sv;
    }
    __syncthreads();
  }

  for (int i = tid; i < rw * d; i += blockDim.x) {
    const float o = bad_page ? NAN : acc[i] / fmaxf(l_s[i / d], 1e-30f);
    out[q_off + i] = from_f32<T>(o);
  }
}

template <typename T>
int launch_quant(const void* q, const void* k_pool, const void* v_pool,
                 const void* k_scales, const void* v_scales,
                 const void* table, const void* lengths, void* out,
                 int slots, int hkv, int rw, int d, int ps, int n_max,
                 int n_pages, int qw, float scale, void* stream) {
  if (slots <= 0 || hkv <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(float) * quant_float_words(rw, d, ps) +
                      2 * quant_page_bytes(ps, d);
  if (smem > (size_t)kMaxDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_quant_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec16 = ((size_t)ps * d) % 16 == 0 &&
                    reinterpret_cast<size_t>(k_pool) % 16 == 0 &&
                    reinterpret_cast<size_t>(v_pool) % 16 == 0;
  paged_decode_quant_kernel<T><<<slots * hkv, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const signed char*>(k_pool),
      static_cast<const signed char*>(v_pool),
      static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), hkv, rw, d, ps,
      n_max, n_pages, qw, scale, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dl4j_paged_attention_f32(const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* lengths, void* out, void* part,
                             void* counters, int slots, int hkv, int rw,
                             int d, int ps, int n_max, int n_pages, int qw,
                             int splits, float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, table, lengths, out, part,
                       counters, slots, hkv, rw, d, ps, n_max, n_pages, qw,
                       splits, scale, stream);
}

int dl4j_paged_attention_bf16(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* lengths, void* out, void* part,
                              void* counters, int slots, int hkv, int rw,
                              int d, int ps, int n_max, int n_pages, int qw,
                              int splits, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, part,
                               counters, slots, hkv, rw, d, ps, n_max,
                               n_pages, qw, splits, scale, stream);
}

int dl4j_paged_attention_quant_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scales,
                                   const void* v_scales, const void* table,
                                   const void* lengths, void* out, int slots,
                                   int hkv, int rw, int d, int ps, int n_max,
                                   int n_pages, int qw, float scale,
                                   void* stream) {
  return launch_quant<float>(q, k_pool, v_pool, k_scales, v_scales, table,
                             lengths, out, slots, hkv, rw, d, ps, n_max,
                             n_pages, qw, scale, stream);
}

int dl4j_paged_attention_quant_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scales,
                                    const void* v_scales, const void* table,
                                    const void* lengths, void* out,
                                    int slots, int hkv, int rw, int d,
                                    int ps, int n_max, int n_pages, int qw,
                                    float scale, void* stream) {
  return launch_quant<__nv_bfloat16>(q, k_pool, v_pool, k_scales, v_scales,
                                     table, lengths, out, slots, hkv, rw, d,
                                     ps, n_max, n_pages, qw, scale, stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
