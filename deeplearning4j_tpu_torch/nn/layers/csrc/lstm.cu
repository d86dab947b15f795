// The LSTM recurrence, for Hopper (sm_90a): the forward over T steps in
// one launch, and its backward, walking time in reverse, in one launch.
//
// Replaces the TPU kernel of deeplearning4j_tpu/nn/layers/pallas_kernels.py:
//   fwd <- `_lstm_kernel` (pallas_call in `pallas_lstm_recurrence`)
// The backward has no TPU twin: the JAX package differentiates through
// its scan (`_lstm_bwd`), which XLA runs as one device loop. Eager PyTorch
// would run that loop as ~15 launches a step a layer, so the port writes
// it as a kernel of the forward's shape.
//
// Inputs (T is float or __nv_bfloat16, the model dtype): zx [T, N, 4H]
// (x W + b for every step, computed outside as one product), RW [H, 4H],
// h0, c0 [N, H], optional peepholes P [3, H] (rows pI, pF, pO) and an
// optional mask [T, N] (f32). Gate order (i, f, c, o). Each step:
//   gates = zx[t] + h_{t-1} RW                      (f32 accumulation)
//   zi += pI c_{t-1}, zf += pF c_{t-1}              (peepholes)
//   i, f, o = sigmoid, g = tanh; c = f c_{t-1} + i g
//   zo += pO c  (the NEW c), h = o tanh(c)
//   masked: h = h m + h_{t-1} (1 - m), c likewise, out = h m
// in f32, with h and c rounded to T at the step's end (the carry of the
// JAX layer's scan has the model dtype; in f32 this is exactly the TPU
// kernel's math, whose carry is f32). The training forward also saves the
// activated gates [T, N, 4H] and the unrounded c [T, N, H], in f32.
//
// The backward takes those saves, c0, RW, P and the gradients of out, hT,
// cT, and writes dzx = dgates [T, N, 4H] (in T), dh0 and dc0; each step
// computes dgates from dh, dc and the saved gates (the peephole terms
// included) and dh_{t-1} = dgates RW^T on the f32 dgates. dW, db, dRW and
// dP are products and reductions over the whole sequence, computed
// outside as the JAX package computes them outside any Pallas kernel. No
// float atomics: two launches give the same bits.
//
// Translation. The TPU kernel walks T on a sequential grid with RW and the
// (h, c) carry resident in VMEM. Blocks on an H100 run in no order, so the
// time loop moves inside one persistent launch. The forward and the
// backward where H > 256 (the cooperative route):
//   - each block owns a tile of hidden units (ub of them) with all four of
//     their gate columns, so the cell update stays inside the block, and
//     one or more tiles of batch rows (nb); its slice of RW (RW[:, 4 ub]
//     forward, RW[ub, :] backward) sits in shared memory for the whole
//     sequence when it fits ("resident"), and is staged chunk by chunk
//     beside h otherwise;
//   - each step reads the whole h_{t-1} of its rows (dgates_{t+1} in the
//     backward) from a double-buffered exchange array in global memory
//     (L2, loaded with ld.global.cg so no stale L1 line is read), in
//     chunks of kChunk, accumulates in f32 (two rows and one unit a
//     thread), updates its cells in registers, and writes its part of h_t;
//     a thread's c (dc backward) stays in a private f32 array;
//   - a grid-wide barrier separates the steps. The launch is cooperative
//     (cudaLaunchCooperativeKernel), so the grid must fit on the card at
//     once or the launch is refused and the wrapper raises, instead of
//     hanging; the grid is sized from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count.
//     The barrier itself is a counter and a generation word, with a
//     __threadfence() by every thread before arriving, so the next step
//     reads every block's h_t.
// The forward where H <= 256 (the cluster route, namespace cl below):
// the recurrence couples hidden units only within a batch row, so the
// unit tiles of one batch tile (at most 8 of up to 32 units) form one
// thread-block cluster, and the clusters need no barrier between them.
// Each block keeps RW[:, the 4 ub gate columns of its units] resident in
// shared memory and its threads' c and h carries in registers. Each step
// it writes its piece of h_t (its rows x ub units, rounded to T) into its
// own double-buffered shared memory, the cluster meets at one
// barrier.cluster arrive (release) / wait (acquire) with the step's
// global stores (out, the saves) between them, and warp q copies peer
// q's piece (the q-th K-slice of the next product) through distributed
// shared memory into the block's assembled h tile, every load in flight
// at once. Warp w then takes 16 of the block's gate columns over the
// whole K, each peer's K-slice into zeroed fragments added in peer order
// with round-to-nearest adds: in bf16 on mma.sync m16n8k16 (the piece is
// stored in A-fragment order, so a lane takes a fragment in one 16-byte
// load, and the bf16 carry's products are exact: no split), RW's slice
// read by ldmatrix.trans; in f32 on the CUDA cores. The gate tile goes
// through shared memory to the cell update, a thread owning two units
// of one or two rows; zx for the next step is loaded into registers a
// step ahead (a pair's two bf16 values are not 4-byte aligned at every
// H, which cp.async would need). The block's shared memory (92-115 KB in
// bf16) lets two blocks share an SM, so 16 clusters of 8 run in one wave.
// The backward where H <= 256 (the cluster route too): the same clusters.
// Each step a block writes its piece of dgates_t (its rows x 4 ub gate
// columns) into its own double-buffered shared memory, the cluster meets at
// one barrier.cluster arrive / wait (release / acquire), and each warp reads
// one peer's piece through distributed shared memory, every load of it in
// flight at once. In bf16 the piece is written as three bf16 terms hi + mid
// + lo of each f32 value (exact for normal values: 3 x 8 significand bits
// cover f32's 24), laid out as mma.sync m16n8k16 A fragments, so a lane
// takes its fragment in one 16-byte load; the warp multiplies them against
// the block's RW[ub, :] slice (bf16, resident in shared memory, read with
// ldmatrix), the three terms into zeroed fragments promoted with
// round-to-nearest adds each k16 step (the tensor cores' accumulation rounds
// toward zero), and the warps' partials are summed in a fixed order. In f32
// the piece is f32 ([column][row]); each warp reads one peer's piece through
// distributed shared memory, 16 columns' loads in flight at a time, and
// multiplies it on the CUDA cores against the resident f32 RW^T slice, a
// lane taking 4 rows x 4 units, the warps' partials summed in the same fixed
// order. The step's saves (the gates, c and c_{t-1}, f32) are copied a step
// ahead by cp.async, dout a step ahead into registers; a thread's dc stays
// in registers for the whole sequence.
//
// What bounds it on an H100. Inference at T = N = H = 256, bf16, one
// layer: zx (134 MB) read and out (34 MB) written, 0.050 ms at 3.35 TB/s;
// 2 T N H 4H = 34.4 GFLOP, 0.035 ms at the bf16 tensor-core peak; the
// training forward also writes 336 MB of f32 saves (0.150 ms), which the
// backward reads. No formula shows the sequential floor: T dependent
// steps, each a barrier and a chain of dependent reads, so the time is
// latency. The cooperative kernels run their products on the f32 CUDA
// cores from shared memory and re-read h from L2 each step in dependent
// chunk rounds behind a grid barrier. The cluster forward's step is one
// cluster barrier, one round of distributed shared-memory loads (16 KB
// of h a block at 32 rows), 32 mma.sync per warp a row tile (bf16) and
// the elementwise update; the cluster backward's one barrier, one round
// of loads, 24 mma.sync per warp (bf16) and its update. Their f32
// routes are bound by the f32 FMA rate (2 T N H 4H FMAs), and the f32
// forward's 160 KB blocks run one an SM, 15 clusters of 8 at once. The
// decode shape (N = 1, T = 1) is bound by the launch's latency and the
// RW slices' staging.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns the launch's CUDA
// error code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "conv_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 2;              // batch rows per thread
constexpr int kChunk = 32;            // reduction depth staged per pass
constexpr int kPitch = kChunk + 1;    // the staged tile's row pitch (f32)
constexpr int kUnitChoices[] = {32, 16, 8, 4, 2, 1};

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

// loads and stores of the exchange arrays, which other blocks wrote or
// read: through L2, never a stale L1 line
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(u));
}
__device__ __forceinline__ void store_cg(float* p, float v) { __stcg(p, v); }
__device__ __forceinline__ void store_cg(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcg(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The grid-wide barrier: sync[0] counts arrivals, sync[1] is the
// generation. Every thread fences its writes first; the last block to
// arrive resets the count and bumps the generation; the others spin on it.
__device__ void grid_sync(unsigned int* sync) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = sync + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == gridDim.x - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The work split: ub hidden units and nb = kThreads / ub * kRows batch rows
// a tile; `units` unit tiles, `batch_tiles` row tiles; the grid is units x
// groups blocks, block b owning unit tile b % units and the row tiles
// b / units, b / units + groups, ...; `resident` keeps the weight slice
// in shared memory for the whole launch.
struct Tiling {
  int ub, nb, units, batch_tiles, groups, resident, smem;
};

Tiling make_tiling(int n, int h, int esize, bool bwd, int ub, int groups,
                   int resident) {
  Tiling tl;
  tl.ub = ub;
  tl.nb = kThreads / ub * kRows;
  tl.units = (h + ub - 1) / ub;
  tl.batch_tiles = (n + tl.nb - 1) / tl.nb;
  tl.groups = groups;
  tl.resident = resident;
  // the staged tile [nb, kPitch] f32, then the weight slice in T: resident
  // [K, cols], staged [kChunk, cols]; forward K = H and cols = 4 ub,
  // backward K = 4H and cols = ub
  const size_t k = bwd ? 4 * (size_t)h : (size_t)h;
  const size_t cols = bwd ? ub : 4 * (size_t)ub;
  tl.smem = (int)(tl.nb * kPitch * sizeof(float) +
                  (resident ? k : kChunk) * cols * esize);
  return tl;
}

struct FwdArgs {
  const void* zx;
  const void* rw;
  const void* h0;
  const void* c0;
  const void* peep;   // [3, H] or null
  const float* mask;  // [T, N] or null
  void* out;
  void* h_t;          // hT [N, H]
  void* c_t;          // cT [N, H]
  void* hbuf;         // [2, N, H]: the h exchange, double-buffered
  float* cbuf;        // [N, H]: each thread's c carry
  float* gates;       // [T, N, 4H] training save, or null
  float* csave;       // [T, N, H] training save, or null
  unsigned int* sync;
  int t_len, n, h;
  Tiling tl;
};

struct BwdArgs {
  const float* gates;
  const float* csave;
  const void* c0;
  const void* rw;
  const void* peep;
  const void* dout;   // [T, N, H]
  const void* dh_t;   // [N, H] or null
  const void* dc_t;   // [N, H] or null
  void* dzx;
  void* dh0;
  void* dc0;
  float* dgbuf;       // [2, N, 4H]: the dgates exchange, double-buffered
  float* dcbuf;       // [N, H]: each thread's dc carry
  unsigned int* sync;
  int t_len, n, h;
  Tiling tl;
};

// acc[r][g] += sum over k of src[row][k] * w[k][g * ub + tx], for this
// thread's rows (row0 + ty kRows + r) of the block's row tile, k over
// [0, klen): src [N, klen] is an exchange array (read through L2), staged
// kChunk columns at a time into hs. Resident: ws holds w[klen][cols] for
// the whole launch; else load_w(k0, kc, kChunk) stages each chunk of w
// into ws between the same two barriers.
template <typename S, typename T, int G, typename LoadW>
__device__ __forceinline__ void tile_product(
    float (&acc)[kRows][G], const S* src, int n, int klen, int row0,
    const Tiling& tl, float* hs, T* ws, int cols, int tx, int ty,
    LoadW load_w) {
  for (int k0 = 0; k0 < klen; k0 += kChunk) {
    const int kc = min(kChunk, klen - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < tl.nb * kChunk; idx += kThreads) {
      const int r = idx / kChunk, kk = idx % kChunk, row = row0 + r;
      hs[r * kPitch + kk] =
          (row < n && kk < kc) ? load_cg(src + (size_t)row * klen + k0 + kk)
                               : 0.f;
    }
    if (!tl.resident) load_w(k0, kc, kChunk);
    __syncthreads();
    const T* wp = tl.resident ? ws + (size_t)k0 * cols : ws;
    for (int kk = 0; kk < kc; ++kk) {
      float w[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        w[g] = to_f32(wp[kk * cols + g * tl.ub + tx]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = hs[(ty * kRows + r) * kPitch + kk];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[r][g] = fmaf(hv, w[g], acc[r][g]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  const Tiling tl = a.tl;
  const int H = a.h, N = a.n, H4 = 4 * H, ub = tl.ub, cols = 4 * ub;
  const int unit_tile = blockIdx.x % tl.units, group = blockIdx.x / tl.units;
  const int tx = threadIdx.x % ub, ty = threadIdx.x / ub;
  const int j = unit_tile * ub + tx;
  float* hs = smem;
  T* ws = reinterpret_cast<T*>(smem + tl.nb * kPitch);
  const T* rw = static_cast<const T*>(a.rw);
  const T* zx = static_cast<const T*>(a.zx);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* peep = static_cast<const T*>(a.peep);
  T* out = static_cast<T*>(a.out);
  T* hbuf = static_cast<T*>(a.hbuf);

  // rows [0, count) of ws: ws[kk cols + g ub + u] = RW[k0 + kk, g H +
  // unit_tile ub + u], zero past kc and past H
  auto load_w = [&](int k0, int kc, int count) {
    for (int idx = threadIdx.x; idx < count * cols; idx += kThreads) {
      const int kk = idx / cols, cc = idx % cols, g = cc / ub;
      const int jj = unit_tile * ub + cc % ub;
      ws[idx] = (kk < kc && jj < H) ? rw[(size_t)(k0 + kk) * H4 + g * H + jj]
                                    : from_f32<T>(0.f);
    }
  };
  if (tl.resident) load_w(0, H, H);   // ordered by the product's barrier
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (peep != nullptr && j < H) {
    p_i = to_f32(peep[j]);
    p_f = to_f32(peep[H + j]);
    p_o = to_f32(peep[2 * H + j]);
  }

  for (int t = 0; t < a.t_len; ++t) {
    const T* hin = t == 0 ? h0 : hbuf + (size_t)((t - 1) & 1) * N * H;
    T* hnext = hbuf + (size_t)(t & 1) * N * H;
    for (int bt = group; bt < tl.batch_tiles; bt += tl.groups) {
      const int row0 = bt * tl.nb;
      float acc[kRows][4] = {};
      tile_product<T, T, 4>(acc, hin, N, H, row0, tl, hs, ws, cols, tx, ty,
                            load_w);
      if (j >= H) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = row0 + ty * kRows + r;
        if (n >= N) continue;
        const size_t nh = (size_t)n * H + j;
        const size_t zr = ((size_t)t * N + n) * H4;
        const float cp = t == 0 ? to_f32(c0[nh]) : a.cbuf[nh];
        float zi = to_f32(zx[zr + j]) + acc[r][0];
        float zf = to_f32(zx[zr + H + j]) + acc[r][1];
        const float zg = to_f32(zx[zr + 2 * H + j]) + acc[r][2];
        float zo = to_f32(zx[zr + 3 * H + j]) + acc[r][3];
        zi += p_i * cp;
        zf += p_f * cp;
        const float ig = sigmoid(zi), fg = sigmoid(zf), gg = tanhf(zg);
        const float cn = fg * cp + ig * gg;
        zo += p_o * cn;                    // the peephole reads the new c
        const float og = sigmoid(zo);
        const float hn = og * tanhf(cn);
        float hc = hn, cc = cn, ho = hn;
        if (a.mask != nullptr) {
          const float m = a.mask[(size_t)t * N + n];
          const float hp = load_cg(hin + nh);
          hc = hn * m + hp * (1.f - m);
          cc = cn * m + cp * (1.f - m);
          ho = hc * m;
        }
        const T hr = from_f32<T>(hc), cr = from_f32<T>(cc);
        out[((size_t)t * N + n) * H + j] = from_f32<T>(ho);
        store_cg(hnext + nh, hr);
        a.cbuf[nh] = to_f32(cr);
        if (a.gates != nullptr) {
          a.gates[zr + j] = ig;
          a.gates[zr + H + j] = fg;
          a.gates[zr + 2 * H + j] = gg;
          a.gates[zr + 3 * H + j] = og;
          a.csave[((size_t)t * N + n) * H + j] = cn;
        }
        if (t == a.t_len - 1) {
          static_cast<T*>(a.h_t)[nh] = hr;
          static_cast<T*>(a.c_t)[nh] = cr;
        }
      }
    }
    if (t + 1 < a.t_len) grid_sync(a.sync);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const Tiling tl = a.tl;
  const int H = a.h, N = a.n, H4 = 4 * H, ub = tl.ub;
  const int unit_tile = blockIdx.x % tl.units, group = blockIdx.x / tl.units;
  const int tx = threadIdx.x % ub, ty = threadIdx.x / ub;
  const int j = unit_tile * ub + tx;
  float* hs = smem;
  T* ws = reinterpret_cast<T*>(smem + tl.nb * kPitch);
  const T* rw = static_cast<const T*>(a.rw);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* peep = static_cast<const T*>(a.peep);
  const T* dout = static_cast<const T*>(a.dout);
  const T* dh_t = static_cast<const T*>(a.dh_t);
  const T* dc_t = static_cast<const T*>(a.dc_t);
  T* dzx = static_cast<T*>(a.dzx);

  // rows [0, count) of ws: ws[kk ub + u] = RW[unit_tile ub + u, k0 + kk]
  // (k over the 4H gate columns), zero past kc and past H
  auto load_w = [&](int k0, int kc, int count) {
    for (int idx = threadIdx.x; idx < count * ub; idx += kThreads) {
      const int kk = idx / ub, jj = unit_tile * ub + idx % ub;
      ws[idx] = (kk < kc && jj < H) ? rw[(size_t)jj * H4 + k0 + kk]
                                    : from_f32<T>(0.f);
    }
  };
  if (tl.resident) load_w(0, H4, H4);
  float p_i = 0.f, p_f = 0.f, p_o = 0.f;
  if (peep != nullptr && j < H) {
    p_i = to_f32(peep[j]);
    p_f = to_f32(peep[H + j]);
    p_o = to_f32(peep[2 * H + j]);
  }

  // s = T-1 .. 0 is a step; s = -1 only takes the product for dh0
  for (int s = a.t_len - 1; s >= -1; --s) {
    const float* dgin = a.dgbuf + (size_t)((s + 1) & 1) * N * H4;
    for (int bt = group; bt < tl.batch_tiles; bt += tl.groups) {
      const int row0 = bt * tl.nb;
      float acc[kRows][1] = {};
      if (s < a.t_len - 1)                 // dh_s = dgates_{s+1} RW^T
        tile_product<float, T, 1>(acc, dgin, N, H4, row0, tl, hs, ws, ub,
                                  tx, ty, load_w);
      if (j >= H) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int n = row0 + ty * kRows + r;
        if (n >= N) continue;
        const size_t nh = (size_t)n * H + j;
        if (s < 0) {
          static_cast<T*>(a.dh0)[nh] = from_f32<T>(acc[r][0]);
          continue;
        }
        const int t = s;
        const bool last = t == a.t_len - 1;
        const float dh_next =
            last ? (dh_t != nullptr ? to_f32(dh_t[nh]) : 0.f) : acc[r][0];
        const float dc_next =
            last ? (dc_t != nullptr ? to_f32(dc_t[nh]) : 0.f) : a.dcbuf[nh];
        const size_t g0 = ((size_t)t * N + n) * H4;
        const float ig = a.gates[g0 + j], fg = a.gates[g0 + H + j];
        const float gg = a.gates[g0 + 2 * H + j], og = a.gates[g0 + 3 * H + j];
        const float cn = a.csave[((size_t)t * N + n) * H + j];
        // the carried c_{t-1}: c0, or the saved c of step t-1 rounded to T
        const float cp =
            t == 0 ? to_f32(c0[nh])
                   : to_f32(from_f32<T>(
                         a.csave[((size_t)(t - 1) * N + n) * H + j]));
        const float dh = to_f32(dout[((size_t)t * N + n) * H + j]) + dh_next;
        const float tc = tanhf(cn);
        const float dzo = dh * tc * og * (1.f - og);
        const float dcn = dh * og * (1.f - tc * tc) + dc_next + p_o * dzo;
        const float dzi = dcn * gg * ig * (1.f - ig);
        const float dzf = dcn * cp * fg * (1.f - fg);
        const float dzg = dcn * ig * (1.f - gg * gg);
        const float dcp = dcn * fg + p_i * dzi + p_f * dzf;
        dzx[g0 + j] = from_f32<T>(dzi);
        dzx[g0 + H + j] = from_f32<T>(dzf);
        dzx[g0 + 2 * H + j] = from_f32<T>(dzg);
        dzx[g0 + 3 * H + j] = from_f32<T>(dzo);
        float* dg = a.dgbuf + (size_t)(t & 1) * N * H4 + (size_t)n * H4;
        store_cg(dg + j, dzi);
        store_cg(dg + H + j, dzf);
        store_cg(dg + 2 * H + j, dzg);
        store_cg(dg + 3 * H + j, dzo);
        a.dcbuf[nh] = dcp;
        if (t == 0) static_cast<T*>(a.dc0)[nh] = from_f32<T>(dcp);
      }
    }
    if (s >= 0) grid_sync(a.sync);
  }
}

template <typename T>
void* kernel_of(bool bwd) {
  return bwd ? reinterpret_cast<void*>(&lstm_bwd_kernel<T>)
             : reinterpret_cast<void*>(&lstm_fwd_kernel<T>);
}

// The tiling of one launch: the largest grid that has work for every
// block (capped at the SM count and at N H / (kThreads kRows) blocks, the
// (row, unit) pairs over a block's share), then a resident weight slice,
// then the widest unit tile: each block re-reads h for its rows every
// step, so the L2 traffic of a step is H / ub times N H. Fills out[7]
// (ub, nb, units, batch_tiles, groups, resident, smem); returns a CUDA
// error code.
template <typename T>
int plan(int n, int h, bool bwd, int* out) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  void* fn = kernel_of<T>(bwd);
  const long long share = (long long)kThreads * kRows;
  const long long pairs = ((long long)n * h + share - 1) / share;
  const long long useful = pairs < sms ? pairs : sms;
  long long best_score = -1;
  for (int ub : kUnitChoices) {
    for (int resident = 1; resident >= 0; --resident) {
      Tiling tl = make_tiling(n, h, sizeof(T), bwd, ub, 1, resident);
      if (tl.smem > smem_max) continue;
      cudaError_t e = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, tl.smem);
      if (e != cudaSuccess) return (int)e;
      int occ = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, kThreads,
                                                        tl.smem);
      if (e != cudaSuccess) return (int)e;
      const long long capacity = (long long)occ * sms;
      if (tl.units > capacity) continue;
      long long groups = capacity / tl.units;
      if (groups > tl.batch_tiles) groups = tl.batch_tiles;
      const long long blocks = tl.units * groups;
      const long long score =
          ((blocks < useful ? blocks : useful) * 2 + resident) * 64 + ub;
      if (score > best_score) {
        best_score = score;
        out[0] = ub;
        out[1] = tl.nb;
        out[2] = tl.units;
        out[3] = tl.batch_tiles;
        out[4] = (int)groups;
        out[5] = resident;
        out[6] = tl.smem;
      }
    }
  }
  return best_score < 0 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// ---------------------------------------------------------------------
// the device kernels the backward's launchers started, by kind (read
// through dl4j_lstm_bwd_kernel_launches)
// ---------------------------------------------------------------------
enum BwdKernel : int { kBwdCooperative = 0, kBwdCluster = 1 };
int bwd_launched[2] = {0, 0};
// the same for the forward's (read through dl4j_lstm_fwd_kernel_launches)
int fwd_launched[2] = {0, 0};

template <typename T, typename Args>
int launch(Args a, bool bwd, int ub, int groups, int resident,
           void* stream) {
  a.tl = make_tiling(a.n, a.h, sizeof(T), bwd, ub, groups, resident);
  void* fn = kernel_of<T>(bwd);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, a.tl.smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(a.tl.units * groups),
                                  dim3(kThreads), args, a.tl.smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int lstm_fwd(const void* zx, const void* rw, const void* h0, const void* c0,
             const void* peep, const void* mask, void* out, void* h_t,
             void* c_t, void* hbuf, void* cbuf, void* gates, void* csave,
             void* sync, int t_len, int n, int h, int ub, int groups,
             int resident, void* stream) {
  FwdArgs a;
  a.zx = zx;
  a.rw = rw;
  a.h0 = h0;
  a.c0 = c0;
  a.peep = peep;
  a.mask = static_cast<const float*>(mask);
  a.out = out;
  a.h_t = h_t;
  a.c_t = c_t;
  a.hbuf = hbuf;
  a.cbuf = static_cast<float*>(cbuf);
  a.gates = static_cast<float*>(gates);
  a.csave = static_cast<float*>(csave);
  a.sync = static_cast<unsigned int*>(sync);
  a.t_len = t_len;
  a.n = n;
  a.h = h;
  const int err = launch<T>(a, false, ub, groups, resident, stream);
  if (!err) ++fwd_launched[kBwdCooperative];
  return err;
}

template <typename T>
int lstm_bwd(const void* gates, const void* csave, const void* c0,
             const void* rw, const void* peep, const void* dout,
             const void* dh_t, const void* dc_t, void* dzx, void* dh0,
             void* dc0, void* dgbuf, void* dcbuf, void* sync, int t_len,
             int n, int h, int ub, int groups, int resident, void* stream) {
  BwdArgs a;
  a.gates = static_cast<const float*>(gates);
  a.csave = static_cast<const float*>(csave);
  a.c0 = c0;
  a.rw = rw;
  a.peep = peep;
  a.dout = dout;
  a.dh_t = dh_t;
  a.dc_t = dc_t;
  a.dzx = dzx;
  a.dh0 = dh0;
  a.dc0 = dc0;
  a.dgbuf = static_cast<float*>(dgbuf);
  a.dcbuf = static_cast<float*>(dcbuf);
  a.sync = static_cast<unsigned int*>(sync);
  a.t_len = t_len;
  a.n = n;
  a.h = h;
  const int err = launch<T>(a, true, ub, groups, resident, stream);
  if (!err) ++bwd_launched[kBwdCooperative];
  return err;
}

// ---------------------------------------------------------------------
// the backward on thread-block clusters (H <= 256)
// ---------------------------------------------------------------------
namespace cl {

namespace cg = cooperative_groups;
using dl4j_mma::bf16;
using dl4j_mma::smem_addr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;               // a portable cluster
constexpr int kMaxUnits = 32;                // units a block: 4 n8 fragments
constexpr int kMaxKs = 4 * kMaxUnits / 16;   // k16 steps of a piece
constexpr int kMaxMt = 2;                    // m16 row tiles a block
constexpr int kTerms = 3;                    // bf16 terms of an f32 value
constexpr int kTile = 256;                   // bf16 of a 16 x 16 A tile
constexpr int kVals = 6;                     // saves a pair: i f g o, c,
                                             // c_{t-1}
constexpr int kRedStride = kMaxUnits + 8;    // a warp partial's row (f32)

// The split of one launch: cs blocks a cluster (unit tiles of ub units),
// a piece of kp gate columns (4 ub padded to whole k16 steps, ks of
// them), nb = 16 mt rows a block, batch_tiles clusters; wstride is the
// bf16 RW slice's row (cs kp columns, padded by 8). The forward's piece
// is the block's h tile: nb rows x kq units (ub padded to whole k16
// steps), its K-slice of the product.
struct Geo {
  int cs, ub, kp, ks, mt, nb, batch_tiles, wstride, kq;
};

inline Geo geo(int n, int h, int mt) {
  Geo g;
  g.cs = (h + kMaxUnits - 1) / kMaxUnits;
  g.ub = (h + g.cs - 1) / g.cs;
  g.kp = (4 * g.ub + 15) / 16 * 16;
  g.ks = g.kp / 16;
  g.mt = mt;
  g.nb = 16 * mt;
  g.batch_tiles = (n + g.nb - 1) / g.nb;
  g.wstride = g.cs * g.kp + 8;
  g.kq = (g.ub + 15) / 16 * 16;
  return g;
}

// The forward's gate columns a block (4 ub, padded: 8 warps of 16), the
// bf16 RW slice's row (padded by 8) and the gate tile's row (f32).
constexpr int kFwdCols = 4 * kMaxUnits;
constexpr int kFwdNs = kFwdCols + 8;
constexpr int kGateStride = kFwdCols + 4;

// Bytes of shared memory a forward block takes: the exchange's two
// buffers (a piece, mt kq 16 values), the assembled h tile (cs kq x nb),
// the gate tile, the stores' staging tile (out and c, [2][nb][32] f32)
// and the RW slice (bf16 [cs kq][kFwdNs], f32 [cs kq][kFwdCols]).
inline size_t fwd_smem_bytes(const Geo& g, bool tc) {
  const size_t kall = static_cast<size_t>(g.cs) * g.kq;
  const size_t el = tc ? sizeof(bf16) : sizeof(float);
  return (2ull * g.mt * g.kq * 16 + kall * g.mt * 16) * el +
         static_cast<size_t>(g.nb) * (kGateStride + 2 * kMaxUnits) *
             sizeof(float) +
         kall * (tc ? kFwdNs : kFwdCols) * el;
}

// Bytes of shared memory a block takes: the two exchange buffers (bf16:
// A fragments of the three terms; f32: the piece [kp][nb]), the RW slice
// (bf16: [32][wstride]; f32: RW^T [cs kp][32]), the warps' partials and
// the saves' two stages.
inline size_t smem_bytes(const Geo& g, bool tc) {
  const size_t rest =
      static_cast<size_t>(kWarps) * g.nb * kRedStride * sizeof(float) +
      2ull * kVals * 2 * g.mt * kThreads * sizeof(float);
  if (tc)
    return 2ull * g.mt * g.ks * kTerms * kTile * sizeof(bf16) +
           32ull * g.wstride * sizeof(bf16) + rest;
  return 2ull * g.nb * g.kp * sizeof(float) +
         static_cast<size_t>(g.cs) * g.kp * kMaxUnits * sizeof(float) + rest;
}

struct Args {
  const float* gates;   // [T, N, 4H]
  const float* csave;   // [T, N, H]
  const void* c0;
  const void* rw;
  const void* peep;     // [3, H] or null
  const void* dout;     // [T, N, H]
  const void* dh_t;     // [N, H] or null
  const void* dc_t;     // [N, H] or null
  void* dzx;
  void* dh0;
  void* dc0;
  int t_len, n, h;
  Geo g;
};

// Copy 4 bytes (or, where !valid, write 4 zero bytes).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Element (r, c) of a 16 x 16 bf16 tile laid out as mma.sync m16n8k16 A
// fragments: lane (r % 8) 4 + (c % 8) / 2 holds 8 values, a0 .. a7 =
// (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1), (r, c + 8), ..., so a
// lane takes its fragment in one 16-byte load.
__device__ __forceinline__ int frag_at(int r, int c) {
  return ((r & 7) * 4 + ((c & 7) >> 1)) * 8 +
         2 * ((r >> 3) + 2 * (c >> 3)) + (c & 1);
}

// Block (batch tile bt, cluster rank q) owns rows 16 mt bt .. + 16 mt and
// units q ub .. + ub (their four gate columns); a thread owns the units
// 2 (tid % 16) + {0, 1} of the rows tid / 16 + 16 m: their dc carry, their
// dgates, their saves. Step s (T - 1 down to 0; s = -1 only takes dh0):
//   1. dh_s = dgates_{s+1} RW^T over the peers' pieces of step s + 1:
//      warp w multiplies peer w's piece (bf16: on the tensor cores; f32:
//      on the CUDA cores), the warps' partials summed in order;
//   2. the next step's saves copied (cp.async) and its dout loaded;
//   3. dgates_s, dc from dh, dc and the saves (the peephole terms), dzx
//      stored, the piece of step s written into buffer s & 1;
//   4. the cluster barrier: every piece of step s visible to every peer.
// Double buffering suffices: a block writes buffer s & 1 only after the
// barrier of step s + 1, which every peer reaches after its reads of
// that buffer (the pieces of step s + 2).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_cluster_kernel(Args a) {
  constexpr bool kTc = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g = a.g;
  const int H = a.h, N = a.n, H4 = 4 * H;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bt = blockIdx.x / g.cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit0 = rank * g.ub;
  const int own = min(g.ub, H - unit0);   // this block's units
  const int up = tid & 15, rr = tid >> 4;
  const int pp = 2 * g.mt;                // pairs a thread
  const T* rw = static_cast<const T*>(a.rw);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* peep = static_cast<const T*>(a.peep);
  const T* dout = static_cast<const T*>(a.dout);
  const T* dh_t = static_cast<const T*>(a.dh_t);
  const T* dc_t = static_cast<const T*>(a.dc_t);
  T* dzx = static_cast<T*>(a.dzx);

  // shared memory: the exchange, the RW slice, the warps' partials, the
  // saves
  const int xelems = kTc ? g.mt * g.ks * kTerms * kTile : g.nb * g.kp;
  unsigned char* p = smem;
  T* xch = reinterpret_cast<T*>(p);   // [2][xelems]
  p += 2ull * xelems * sizeof(T);
  bf16* wb = reinterpret_cast<bf16*>(p);   // bf16: [32][wstride]
  float* wt = reinterpret_cast<float*>(p);   // f32: [cs kp][32]
  p += kTc ? 32ull * g.wstride * sizeof(bf16)
           : static_cast<size_t>(g.cs) * g.kp * kMaxUnits * sizeof(float);
  float* red = reinterpret_cast<float*>(p);   // [8][nb][kRedStride]
  p += static_cast<size_t>(kWarps) * g.nb * kRedStride * sizeof(float);
  float* sv = reinterpret_cast<float*>(p);   // [2][kVals][pp][kThreads]

  // the exchange zeroed (rows past N, units past H and the padding stay
  // zero), and the RW slice: column q kp + gg ub + u of unit uu is
  // RW[unit0 + uu, gg H + q ub + u], zero past the units and gate
  // columns
  {
    uint4* x4 = reinterpret_cast<uint4*>(xch);
    const int n4 = static_cast<int>(2ull * xelems * sizeof(T) / 16);
    for (int i = tid; i < n4; i += kThreads) x4[i] = make_uint4(0, 0, 0, 0);
    const int kall = g.cs * g.kp;
    for (int i = tid; i < 32 * kall; i += kThreads) {
      const int uu = kTc ? i / kall : i % 32;
      const int col = kTc ? i - uu * kall : i / 32;
      const int q = col / g.kp;
      const int kl = col - q * g.kp;
      const int gg = kl / g.ub;
      const int u = kl - gg * g.ub;
      const bool ok = uu < own && gg < 4 && u < min(g.ub, H - q * g.ub);
      const T v = ok ? rw[static_cast<size_t>(unit0 + uu) * H4 + gg * H +
                          q * g.ub + u]
                     : T(0.f);
      if constexpr (kTc)
        wb[uu * g.wstride + col] = v;
      else
        wt[i] = v;
    }
  }
  // this thread's pairs (m, e): row rr + 16 m, unit 2 up + e
  int nrow[kMaxMt][2], jcol[kMaxMt][2];
  bool ok[kMaxMt][2];
  float p_i[2], p_f[2], p_o[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ul = 2 * up + e;
    const bool uok = ul < own;
    p_i[e] = p_f[e] = p_o[e] = 0.f;
    if (peep != nullptr && uok) {
      p_i[e] = to_f32(peep[unit0 + ul]);
      p_f[e] = to_f32(peep[H + unit0 + ul]);
      p_o[e] = to_f32(peep[2 * H + unit0 + ul]);
    }
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m) {
      nrow[m][e] = bt * g.nb + rr + 16 * m;
      jcol[m][e] = unit0 + ul;
      ok[m][e] = m < g.mt && uok && nrow[m][e] < N;
    }
  }
  auto slot = [&](int st, int v, int pr) {
    return sv + ((st * kVals + v) * pp + pr) * kThreads + tid;
  };
  // the saves of step t into stage t & 1 (one copy group)
  auto issue = [&](int t) {
    if (t >= 0) {
#pragma unroll
      for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (m >= g.mt) continue;
          const int pr = 2 * m + e;
          const bool v = ok[m][e];
          const size_t nt = static_cast<size_t>(t) * N + nrow[m][e];
          const size_t g0 = v ? nt * H4 + jcol[m][e] : 0;
          const size_t c1 = v ? nt * H + jcol[m][e] : 0;
#pragma unroll
          for (int gg = 0; gg < 4; ++gg)
            cp_async4(slot(t & 1, gg, pr), a.gates + g0 + gg * (v ? H : 0),
                      v);
          cp_async4(slot(t & 1, 4, pr), a.csave + c1, v);
          cp_async4(slot(t & 1, 5, pr),
                    a.csave + (v && t > 0 ? c1 - static_cast<size_t>(N) * H
                                          : 0),
                    v && t > 0);
        }
    }
    dl4j_mma::cp_async_commit();
  };
  auto load_dout = [&](int t, float (&d)[kMaxMt][2]) {
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        d[m][e] = ok[m][e] ? to_f32(dout[(static_cast<size_t>(t) * N +
                                          nrow[m][e]) * H + jcol[m][e]])
                           : 0.f;
  };

  float dh[kMaxMt][2], dc[kMaxMt][2], dnext[kMaxMt][2];
#pragma unroll
  for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) dh[m][e] = dc[m][e] = 0.f;
  issue(a.t_len - 1);
  load_dout(a.t_len - 1, dnext);
  cluster.sync();   // every block started, its exchange zeroed

  for (int s = a.t_len - 1; s >= -1; --s) {
    if (s < a.t_len - 1) {
      // dh_s = dgates_{s+1} RW^T from the pieces in buffer (s + 1) & 1
      const int buf = (s + 1) & 1;
      if constexpr (kTc) {
        if (warp < g.cs) {
          const bf16* piece = cluster.map_shared_rank(
              reinterpret_cast<const bf16*>(xch) + buf * xelems, warp);
#pragma unroll 1
          for (int m = 0; m < g.mt; ++m) {
            uint4 av[kMaxKs][kTerms];
#pragma unroll
            for (int ks = 0; ks < kMaxKs; ++ks)
#pragma unroll
              for (int tm = 0; tm < kTerms; ++tm)
                if (ks < g.ks)
                  av[ks][tm] = *reinterpret_cast<const uint4*>(
                      piece + ((m * g.ks + ks) * kTerms + tm) * kTile +
                      lane * 8);
            float acc[4][4];
#pragma unroll
            for (int nf = 0; nf < 4; ++nf)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[nf][q] = 0.f;
#pragma unroll
            for (int ks = 0; ks < kMaxKs; ++ks) {
              if (ks >= g.ks) continue;
              uint32_t bfr[2][4];
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2)
                dl4j_mma::ldsm_x4<false>(
                    smem_addr(wb + (16 * h2 + dl4j_mma::b_n(lane)) *
                                       g.wstride +
                              warp * g.kp + 16 * ks + dl4j_mma::b_k(lane)),
                    bfr[h2]);
              // lo, mid, hi into zeroed fragments, then promoted
              float part[4][4];
#pragma unroll
              for (int nf = 0; nf < 4; ++nf)
#pragma unroll
                for (int q = 0; q < 4; ++q) part[nf][q] = 0.f;
#pragma unroll
              for (int tm = kTerms - 1; tm >= 0; --tm) {
                const uint32_t af[4] = {av[ks][tm].x, av[ks][tm].y,
                                        av[ks][tm].z, av[ks][tm].w};
#pragma unroll
                for (int nf = 0; nf < 4; ++nf)
                  dl4j_mma::mma_16816(part[nf], af,
                                      bfr[nf >> 1][(nf & 1) * 2],
                                      bfr[nf >> 1][(nf & 1) * 2 + 1]);
              }
#pragma unroll
              for (int nf = 0; nf < 4; ++nf)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[nf][q] += part[nf][q];
            }
#pragma unroll
            for (int nf = 0; nf < 4; ++nf) {
              const int row = 16 * m + (lane >> 2);
              const int col = 8 * nf + 2 * (lane & 3);
              float* r0 = red + (warp * g.nb + row) * kRedStride + col;
              *reinterpret_cast<float2*>(r0) =
                  make_float2(acc[nf][0], acc[nf][1]);
              *reinterpret_cast<float2*>(r0 + 8 * kRedStride) =
                  make_float2(acc[nf][2], acc[nf][3]);
            }
          }
        }
      } else if (warp < g.cs) {
        // f32: lane (row group, unit group) takes 4 rows x 4 units of the
        // peer's piece (stored [column][row]) against the RW^T slice, 16
        // columns' loads in flight at a time, on the CUDA cores
        const float* piece = cluster.map_shared_rank(
            reinterpret_cast<const float*>(xch) + buf * xelems, warp);
        const int r0 = 4 * (lane >> 3), u0 = 4 * (lane & 7);
        const float* wq = wt + warp * g.kp * kMaxUnits + u0;
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int k0 = 0; k0 < g.kp; k0 += 16) {
          float4 d[16];
#pragma unroll
          for (int kk = 0; kk < 16; ++kk)
            d[kk] = *reinterpret_cast<const float4*>(
                piece + (k0 + kk) * g.nb + r0);
#pragma unroll
          for (int kk = 0; kk < 16; ++kk) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                wq + (k0 + kk) * kMaxUnits);
            const float dv[4] = {d[kk].x, d[kk].y, d[kk].z, d[kk].w};
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] = fmaf(dv[i], wv[j], acc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(
              red + (warp * g.nb + r0 + i) * kRedStride + u0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      // the warps' partials summed in order
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kMaxMt; ++m) {
          if (m >= g.mt) continue;
          float2 sum = make_float2(0.f, 0.f);
          for (int w = 0; w < g.cs; ++w) {
            const float2 v = *reinterpret_cast<const float2*>(
                red + (w * g.nb + rr + 16 * m) * kRedStride + 2 * up);
            sum.x += v.x;
            sum.y += v.y;
          }
          dh[m][0] = sum.x;
          dh[m][1] = sum.y;
        }
    }
    if (s < 0) {
#pragma unroll
      for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ok[m][e])
            static_cast<T*>(a.dh0)[static_cast<size_t>(nrow[m][e]) * H +
                                   jcol[m][e]] = from_f32<T>(dh[m][e]);
      break;
    }
    issue(s - 1);   // the next step's saves, in flight during this one
    float dcur[kMaxMt][2];
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) dcur[m][e] = dnext[m][e];
    if (s > 0) load_dout(s - 1, dnext);
    dl4j_mma::cp_async_wait<1>();   // this step's saves

    const int t = s;
    const bool last = t == a.t_len - 1;
    T* xo = xch + (t & 1) * xelems;
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!ok[m][e]) continue;
        const int pr = 2 * m + e;
        const size_t nh = static_cast<size_t>(nrow[m][e]) * H + jcol[m][e];
        const float dh_next =
            last ? (dh_t != nullptr ? to_f32(dh_t[nh]) : 0.f) : dh[m][e];
        const float dc_next =
            last ? (dc_t != nullptr ? to_f32(dc_t[nh]) : 0.f) : dc[m][e];
        const float ig = *slot(t & 1, 0, pr), fg = *slot(t & 1, 1, pr);
        const float gg = *slot(t & 1, 2, pr), og = *slot(t & 1, 3, pr);
        const float cn = *slot(t & 1, 4, pr);
        // the carried c_{t-1}: c0, or the saved c of step t-1 rounded to T
        const float cp = t == 0 ? to_f32(c0[nh])
                                : to_f32(from_f32<T>(*slot(t & 1, 5, pr)));
        const float dhv = dcur[m][e] + dh_next;
        const float tc = tanhf(cn);
        const float dzo = dhv * tc * og * (1.f - og);
        const float dcn =
            dhv * og * (1.f - tc * tc) + dc_next + p_o[e] * dzo;
        const float dzi = dcn * gg * ig * (1.f - ig);
        const float dzf = dcn * cp * fg * (1.f - fg);
        const float dzg = dcn * ig * (1.f - gg * gg);
        const float dcp = dcn * fg + p_i[e] * dzi + p_f[e] * dzf;
        const float dz[4] = {dzi, dzf, dzg, dzo};
        const size_t g0 =
            (static_cast<size_t>(t) * N + nrow[m][e]) * H4 + jcol[m][e];
        const int ul = 2 * up + e;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dzx[g0 + q * H] = from_f32<T>(dz[q]);
          const int kl = q * g.ub + ul;   // the piece's gate column
          if constexpr (kTc) {
            // hi + mid + lo = dz exactly (each remainder exact in f32)
            const bf16 hi = __float2bfloat16(dz[q]);
            const float r1 = dz[q] - __bfloat162float(hi);
            const bf16 mid = __float2bfloat16(r1);
            const bf16 lo = __float2bfloat16(r1 - __bfloat162float(mid));
            bf16* tile = xo + (m * g.ks + (kl >> 4)) * kTerms * kTile +
                         frag_at(rr, kl & 15);
            tile[0] = hi;
            tile[kTile] = mid;
            tile[2 * kTile] = lo;
          } else {
            xo[kl * g.nb + rr + 16 * m] = dz[q];
          }
        }
        dc[m][e] = dcp;
        if (t == 0) static_cast<T*>(a.dc0)[nh] = from_f32<T>(dcp);
      }
    cluster.sync();   // the pieces of step s written and visible
  }
  cluster.sync();   // no block leaves while a peer reads its pieces
}

// ---------------------------------------------------------------------
// the forward on thread-block clusters (H <= 256)
// ---------------------------------------------------------------------
struct FwdClusterArgs {
  const void* zx;      // [T, N, 4H]
  const void* rw;      // [H, 4H]
  const void* h0;
  const void* c0;
  const void* peep;    // [3, H] or null
  const float* mask;   // [T, N] or null
  void* out;           // [T, N, H]
  void* h_t;
  void* c_t;
  float* gates;        // [T, N, 4H] training save, or null
  float* csave;        // [T, N, H] training save, or null
  int t_len, n, h;
  int wvec;            // RW's slice copied 16 bytes at a time
  Geo g;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block (batch tile bt, cluster rank q) owns rows nb bt .. + nb and units
// q ub .. + ub with their four gate columns; a thread owns the units
// 2 (tid % 16) + {0, 1} of the rows tid / 16 + 16 m: their h and c carry
// (in registers for the whole sequence), their zx (loaded a step ahead),
// their outputs and saves. The block's RW slice, RW[:, the 4 ub gate
// columns of its units], stays in shared memory, rows ordered as the
// assembled h tile's columns (peer q's units at q kq ..). Step t:
//   1. warp q copies peer q's piece of h_{t-1} (buffer (t + 1) & 1: h0
//      at t = 0) through distributed shared memory into the assembled
//      h tile, every load of it in flight at once;
//   2. gates = h_{t-1} RW_slice: warp w the 16 gate columns 16 w .. + 16
//      over the whole K, each peer's K-slice into zeroed fragments
//      promoted with round-to-nearest adds in peer order (bf16: mma.sync
//      m16n8k16 on the fragment-ordered tile and ldmatrix.trans of the
//      slice; f32: the CUDA cores), into the gate tile;
//   3. the cell update from the gate tile, zx and the carries; h and c
//      rounded to T; h written into this block's piece, buffer t & 1 (A
//      fragment order in bf16, [unit][row] in f32);
//   4. the cluster barrier's arrive (release), the global stores of out,
//      the saves and hT / cT, then its wait (acquire): every piece of
//      step t visible to every peer.
// Double buffering suffices: a block writes buffer t & 1 at step t only
// after the wait of step t - 1, which every peer passes only after its
// reads of that buffer (the pieces of step t - 2, read at step t - 1).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_fwd_cluster_kernel(FwdClusterArgs a) {
  constexpr bool kTc = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Geo g = a.g;
  const int H = a.h, N = a.n, H4 = 4 * H;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bt = blockIdx.x / g.cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit0 = rank * g.ub;
  const int own = min(g.ub, H - unit0);   // this block's units
  const int up = tid & 15, rr = tid >> 4;
  const int qs = g.kq / 16;               // k16 steps of a piece
  const int kall = g.cs * g.kq;           // the product's K, padded
  const int KS = kall / 16;
  const T* rw = static_cast<const T*>(a.rw);
  const T* zx = static_cast<const T*>(a.zx);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* c0 = static_cast<const T*>(a.c0);
  const T* peep = static_cast<const T*>(a.peep);
  T* out = static_cast<T*>(a.out);

  // shared memory: the exchange, the assembled h tile, the gate tile,
  // the RW slice
  const int xelems = g.mt * g.kq * 16;   // a piece
  unsigned char* p = smem;
  T* xch = reinterpret_cast<T*>(p);       // [2][xelems]
  p += 2ull * xelems * sizeof(T);
  T* hloc = reinterpret_cast<T*>(p);      // bf16 [mt][KS][256]; f32
  p += static_cast<size_t>(g.mt) * kall * 16 * sizeof(T);   // [kall][nb]
  float* gt = reinterpret_cast<float*>(p);   // [nb][kGateStride]
  p += static_cast<size_t>(g.nb) * kGateStride * sizeof(float);
  float* stg = reinterpret_cast<float*>(p);  // [2][nb][32]: out, c
  p += 2ull * g.nb * kMaxUnits * sizeof(float);
  T* wsl = reinterpret_cast<T*>(p);       // [kall][wcols]
  constexpr int wcols = kTc ? kFwdNs : kFwdCols;

  // the exchange zeroed (rows past N, units past H and the padding stay
  // zero); the RW slice: row kk (peer q = kk / kq, its unit u), column
  // n = gg ub + u2 of this block's units holds RW[q ub + u, gg H + unit0
  // + u2], zero past the units, the gates and the peers' units
  {
    uint4* x4 = reinterpret_cast<uint4*>(xch);
    const int n4 = static_cast<int>(2ull * xelems * sizeof(T) / 16);
    for (int i = tid; i < n4; i += kThreads) x4[i] = make_uint4(0, 0, 0, 0);
    if (a.wvec) {
      constexpr int E = 16 / sizeof(T);
      const int per = g.ub / E;   // 16-byte chunks of a gate's units
      for (int i = tid; i < kall * 4 * per; i += kThreads) {
        const int kk = i / (4 * per);
        const int r = i - kk * 4 * per;
        const int gg = r / per;
        const int ch = r - gg * per;
        const int q = kk / g.kq;
        const int u = kk - q * g.kq;
        const bool ok = u < min(g.ub, H - q * g.ub) && ch * E < own;
        *reinterpret_cast<uint4*>(wsl + kk * wcols + gg * g.ub + ch * E) =
            ok ? __ldg(reinterpret_cast<const uint4*>(
                     rw + static_cast<size_t>(q * g.ub + u) * H4 + gg * H +
                     unit0 + ch * E))
               : make_uint4(0, 0, 0, 0);
      }
      const int pad = kFwdCols - 4 * g.ub;
      for (int i = tid; i < kall * pad; i += kThreads) {
        const int kk = i / pad;
        wsl[kk * wcols + 4 * g.ub + (i - kk * pad)] = T(0.f);
      }
    } else {
      for (int i = tid; i < kall * kFwdCols; i += kThreads) {
        const int kk = i / kFwdCols;
        const int n = i - kk * kFwdCols;
        const int q = kk / g.kq;
        const int u = kk - q * g.kq;
        const int gg = n / g.ub;
        const int u2 = n - gg * g.ub;
        const bool ok = gg < 4 && u2 < own && u < min(g.ub, H - q * g.ub);
        wsl[kk * wcols + n] =
            ok ? rw[static_cast<size_t>(q * g.ub + u) * H4 + gg * H + unit0 +
                    u2]
               : T(0.f);
      }
    }
  }
  __syncthreads();   // the exchange zeroed before this block's h0 lands

  // this thread's pairs (m, e): row rr + 16 m, unit 2 up + e; h0 and c0
  // into the carries and h0 into this block's piece, buffer 1
  int nrow[kMaxMt];
  bool ok[kMaxMt][2];
  float hp[kMaxMt][2], cp[kMaxMt][2], p_i[2], p_f[2], p_o[2];
  auto put = [&](int buf, int m, int e, T v) {
    const int ul = 2 * up + e;
    if constexpr (kTc)
      xch[buf * xelems + (m * qs + (ul >> 4)) * 256 + frag_at(rr, ul & 15)] =
          v;
    else
      xch[buf * xelems + ul * g.nb + rr + 16 * m] = v;
  };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ul = 2 * up + e;
    p_i[e] = p_f[e] = p_o[e] = 0.f;
    if (peep != nullptr && ul < own) {
      p_i[e] = to_f32(peep[unit0 + ul]);
      p_f[e] = to_f32(peep[H + unit0 + ul]);
      p_o[e] = to_f32(peep[2 * H + unit0 + ul]);
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxMt; ++m) {
    nrow[m] = bt * g.nb + rr + 16 * m;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ok[m][e] = m < g.mt && 2 * up + e < own && nrow[m] < N;
      hp[m][e] = cp[m][e] = 0.f;
      if (!ok[m][e]) continue;
      const size_t nh = static_cast<size_t>(nrow[m]) * H + unit0 + 2 * up + e;
      hp[m][e] = to_f32(h0[nh]);
      cp[m][e] = to_f32(c0[nh]);
      put(1, m, e, h0[nh]);
    }
  }
  // zx of step t for this thread's pairs, a step ahead
  float zn[kMaxMt][2][4];
  auto load_zx = [&](int t) {
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
          zn[m][e][gg] =
              ok[m][e] ? to_f32(zx[(static_cast<size_t>(t) * N + nrow[m]) *
                                       H4 +
                                   gg * H + unit0 + 2 * up + e])
                       : 0.f;
  };
  load_zx(0);
  cluster.sync();   // every block started, its piece of h0 written

  for (int t = 0; t < a.t_len; ++t) {
    // 1. the peers' pieces of h_{t-1} into the assembled tile
    if (warp < g.cs) {
      const T* piece = cluster.map_shared_rank(
          xch + ((t + 1) & 1) * xelems, warp);
      if constexpr (kTc) {
        // 16 x 16 tiles (m, ks) -> the tile's steps warp qs + ks
        uint4 v[kMaxMt * 2];
#pragma unroll
        for (int i = 0; i < kMaxMt * 2; ++i)
          if (i < g.mt * qs)
            v[i] = *reinterpret_cast<const uint4*>(piece + i * 256 +
                                                   lane * 8);
#pragma unroll
        for (int i = 0; i < kMaxMt * 2; ++i)
          if (i < g.mt * qs) {
            const int m = i / qs;
            *reinterpret_cast<uint4*>(
                hloc + (m * KS + warp * qs + (i - m * qs)) * 256 + lane * 8) =
                v[i];
          }
      } else {
        // [kq][nb] -> rows warp kq .. of the tile [kall][nb]
        const int n4 = g.kq * g.nb / 4;
        const float4* src = reinterpret_cast<const float4*>(piece);
        float4* dst =
            reinterpret_cast<float4*>(hloc + warp * g.kq * g.nb);
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < n4) v[i] = src[lane + 32 * i];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (lane + 32 * i < n4) dst[lane + 32 * i] = v[i];
      }
    }
    __syncthreads();
    // 2. the gate tile: h_{t-1} RW_slice, each peer's K-slice promoted in
    // order
    if constexpr (kTc) {
      if (16 * warp < 4 * g.ub) {
#pragma unroll
        for (int m = 0; m < kMaxMt; ++m) {
          if (m >= g.mt) continue;
          float acc[2][4];
#pragma unroll
          for (int nf = 0; nf < 2; ++nf)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[nf][q] = 0.f;
#pragma unroll 1
          for (int q = 0; q < g.cs; ++q) {
            float part[2][4];
#pragma unroll
            for (int nf = 0; nf < 2; ++nf)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[nf][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              if (ks >= qs) continue;
              const int step = q * qs + ks;
              const uint4 av = *reinterpret_cast<const uint4*>(
                  hloc + (m * KS + step) * 256 + lane * 8);
              const uint32_t af[4] = {av.x, av.y, av.z, av.w};
              uint32_t bfr[4];
              dl4j_mma::ldsm_x4<true>(
                  smem_addr(wsl + (16 * step + dl4j_mma::b_trans_k(lane)) *
                                      kFwdNs +
                            16 * warp + dl4j_mma::b_trans_n(lane)),
                  bfr);
              dl4j_mma::mma_16816(part[0], af, bfr[0], bfr[1]);
              dl4j_mma::mma_16816(part[1], af, bfr[2], bfr[3]);
            }
#pragma unroll
            for (int nf = 0; nf < 2; ++nf)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[nf][e] += part[nf][e];
          }
#pragma unroll
          for (int nf = 0; nf < 2; ++nf) {
            float* r0 = gt + (16 * m + (lane >> 2)) * kGateStride + 16 * warp +
                        8 * nf + 2 * (lane & 3);
            *reinterpret_cast<float2*>(r0) =
                make_float2(acc[nf][0], acc[nf][1]);
            *reinterpret_cast<float2*>(r0 + 8 * kGateStride) =
                make_float2(acc[nf][2], acc[nf][3]);
          }
        }
      }
    } else {
      // rows 2 warp, 2 warp + 1 x columns 4 lane .. + 4 (nb = 16)
      const float* hf = reinterpret_cast<const float*>(hloc);
      const float* wf = reinterpret_cast<const float*>(wsl);
      const int r0 = 2 * warp, c0 = 4 * lane;
      float acc[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
      for (int q = 0; q < g.cs; ++q) {
        float part[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll 4
        for (int kk = q * g.kq; kk < (q + 1) * g.kq; ++kk) {
          const float2 hv =
              *reinterpret_cast<const float2*>(hf + kk * g.nb + r0);
          const float4 wv =
              *reinterpret_cast<const float4*>(wf + kk * kFwdCols + c0);
          const float hs[2] = {hv.x, hv.y};
          const float ws[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i][j] = fmaf(hs[i], ws[j], part[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(gt + (r0 + i) * kGateStride + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    // 3. the cell update; h into this block's piece of step t, the
    // activated gates over their pre-activations in the gate tile (each
    // thread its own pairs' slots), out and the unrounded c into the
    // staging tile, for the stores after the arrive
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!ok[m][e]) continue;
        const int row = rr + 16 * m, ul = 2 * up + e;
        float* gr = gt + row * kGateStride + ul;
        const float c_prev = cp[m][e];
        float zi = zn[m][e][0] + gr[0];
        float zf = zn[m][e][1] + gr[g.ub];
        const float zg = zn[m][e][2] + gr[2 * g.ub];
        float zo = zn[m][e][3] + gr[3 * g.ub];
        zi += p_i[e] * c_prev;
        zf += p_f[e] * c_prev;
        const float ig = sigmoid(zi), fg = sigmoid(zf), gg = tanhf(zg);
        const float cn = fg * c_prev + ig * gg;
        zo += p_o[e] * cn;                 // the peephole reads the new c
        const float og = sigmoid(zo);
        const float hn = og * tanhf(cn);
        float hc = hn, cc = cn, ho = hn;
        if (a.mask != nullptr) {
          const float mk = a.mask[static_cast<size_t>(t) * N + nrow[m]];
          hc = hn * mk + hp[m][e] * (1.f - mk);
          cc = cn * mk + c_prev * (1.f - mk);
          ho = hc * mk;
        }
        const T hr = from_f32<T>(hc), cr = from_f32<T>(cc);
        hp[m][e] = to_f32(hr);
        cp[m][e] = to_f32(cr);
        put(t & 1, m, e, hr);
        gr[0] = ig;
        gr[g.ub] = fg;
        gr[2 * g.ub] = gg;
        gr[3 * g.ub] = og;
        stg[row * kMaxUnits + ul] = ho;
        stg[(g.nb + row) * kMaxUnits + ul] = cn;
      }
    if (t + 1 < a.t_len) load_zx(t + 1);   // in flight from here on
    cluster_arrive();   // this block's piece of step t written
    // 4. the global stores from this thread's own slots, while the peers
    // arrive
#pragma unroll
    for (int m = 0; m < kMaxMt; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!ok[m][e]) continue;
        const int row = rr + 16 * m, ul = 2 * up + e;
        const int j = unit0 + ul;
        const size_t nt = static_cast<size_t>(t) * N + nrow[m];
        out[nt * H + j] = from_f32<T>(stg[row * kMaxUnits + ul]);
        if (a.gates != nullptr) {
          const float* gr = gt + row * kGateStride + ul;
#pragma unroll
          for (int gg = 0; gg < 4; ++gg)
            a.gates[nt * H4 + gg * H + j] = gr[gg * g.ub];
          a.csave[nt * H + j] = stg[(g.nb + row) * kMaxUnits + ul];
        }
        if (t == a.t_len - 1) {
          const size_t nh = static_cast<size_t>(nrow[m]) * H + j;
          static_cast<T*>(a.h_t)[nh] = from_f32<T>(hp[m][e]);
          static_cast<T*>(a.c_t)[nh] = from_f32<T>(cp[m][e]);
        }
      }
    cluster_wait();   // every peer's piece of step t visible
  }
}

// Launch the cluster kernel at mt row tiles a block.
template <typename T>
int launch(Args a, int mt, cudaStream_t st) {
  constexpr bool kTc = sizeof(T) == 2;
  if (mt < 1 || mt > (kTc ? kMaxMt : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = geo(a.n, a.h, mt);
  if (a.g.cs > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(a.g, kTc);
  auto fn = lstm_bwd_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.g.cs * a.g.batch_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++bwd_launched[kBwdCluster];
  return static_cast<int>(e);
}

// The forward's launch at mt row tiles a block (RW's slice copied 16
// bytes at a time where its rows and the units a block are whole 16-byte
// chunks and RW is aligned).
template <typename T>
int launch_fwd(FwdClusterArgs a, int mt, cudaStream_t st) {
  constexpr bool kTc = sizeof(T) == 2;
  if (mt < 1 || mt > (kTc ? kMaxMt : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = geo(a.n, a.h, mt);
  if (a.g.cs > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int E = 16 / sizeof(T);
  a.wvec = a.g.ub % E == 0 && a.h % E == 0 && dl4j_mma::aligned16(a.rw);
  const size_t bytes = fwd_smem_bytes(a.g, kTc);
  auto fn = lstm_fwd_cluster_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.g.cs * a.g.batch_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++fwd_launched[kBwdCluster];
  return static_cast<int>(e);
}

// The clusters the card runs at once for the split at mt, forward or
// backward (0 where a block's shared memory does not fit).
template <typename T>
int active_clusters(const Geo& g, bool fwd, int* out) {
  const size_t bytes =
      fwd ? fwd_smem_bytes(g, sizeof(T) == 2) : smem_bytes(g, sizeof(T) == 2);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  *out = 0;
  if (bytes > static_cast<size_t>(smem_max)) return 0;
  auto fn = fwd ? reinterpret_cast<const void*>(lstm_fwd_cluster_kernel<T>)
                : reinterpret_cast<const void*>(lstm_bwd_cluster_kernel<T>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.cs * g.batch_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, fn, &cfg));
}

// The split of the cluster route for N rows and H units (H <= 256),
// forward or backward: the row tiles a block (bf16: 16 or 32, f32: 16)
// whose clusters the card runs in the fewest waves, ties to 16 (less
// work a step). Fills out[8] (cs, ub, kp (the forward: kq), mt, nb,
// batch_tiles, smem, active clusters).
template <typename T>
int plan(int n, int h, bool fwd, int* out) {
  constexpr bool kTc = sizeof(T) == 2;
  if (geo(n, h, 1).cs > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  long long best = -1;
  for (int mt = 1; mt <= (kTc ? kMaxMt : 1); ++mt) {
    const Geo g = geo(n, h, mt);
    int active = 0;
    const int e = active_clusters<T>(g, fwd, &active);
    if (e) return e;
    if (active < 1) continue;
    const long long waves = (g.batch_tiles + active - 1) / active;
    if (best < 0 || waves < best) {
      best = waves;
      const size_t bytes = fwd ? fwd_smem_bytes(g, kTc) : smem_bytes(g, kTc);
      const int vals[8] = {g.cs, g.ub, fwd ? g.kq : g.kp, g.mt, g.nb,
                           g.batch_tiles, static_cast<int>(bytes), active};
      for (int i = 0; i < 8; ++i) out[i] = vals[i];
    }
  }
  return best < 0 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

}  // namespace cl

}  // namespace

extern "C" {

int dl4j_lstm_plan(int n, int h, int bf16, int bwd, int* out) {
  return bf16 ? plan<__nv_bfloat16>(n, h, bwd != 0, out)
              : plan<float>(n, h, bwd != 0, out);
}

#define DL4J_LSTM_FWD(NAME, T)                                               \
  int NAME(const void* zx, const void* rw, const void* h0, const void* c0,   \
           const void* peep, const void* mask, void* out, void* h_t,         \
           void* c_t, void* hbuf, void* cbuf, void* gates, void* csave,      \
           void* sync, int t_len, int n, int h, int ub, int groups,          \
           int resident, void* stream) {                                     \
    return lstm_fwd<T>(zx, rw, h0, c0, peep, mask, out, h_t, c_t, hbuf,      \
                       cbuf, gates, csave, sync, t_len, n, h, ub, groups,    \
                       resident, stream);                                    \
  }
DL4J_LSTM_FWD(dl4j_lstm_fwd_f32, float)
DL4J_LSTM_FWD(dl4j_lstm_fwd_bf16, __nv_bfloat16)

#define DL4J_LSTM_BWD(NAME, T)                                               \
  int NAME(const void* gates, const void* csave, const void* c0,             \
           const void* rw, const void* peep, const void* dout,               \
           const void* dh_t, const void* dc_t, void* dzx, void* dh0,         \
           void* dc0, void* dgbuf, void* dcbuf, void* sync, int t_len,       \
           int n, int h, int ub, int groups, int resident, void* stream) {   \
    return lstm_bwd<T>(gates, csave, c0, rw, peep, dout, dh_t, dc_t, dzx,    \
                       dh0, dc0, dgbuf, dcbuf, sync, t_len, n, h, ub, groups, \
                       resident, stream);                                    \
  }
DL4J_LSTM_BWD(dl4j_lstm_bwd_f32, float)
DL4J_LSTM_BWD(dl4j_lstm_bwd_bf16, __nv_bfloat16)

#define DL4J_LSTM_BWD_CLUSTER(NAME, T)                                       \
  int NAME(const void* gates, const void* csave, const void* c0,             \
           const void* rw, const void* peep, const void* dout,               \
           const void* dh_t, const void* dc_t, void* dzx, void* dh0,         \
           void* dc0, int t_len, int n, int h, int mt, void* stream) {       \
    cl::Args a;                                                              \
    a.gates = static_cast<const float*>(gates);                              \
    a.csave = static_cast<const float*>(csave);                              \
    a.c0 = c0;                                                               \
    a.rw = rw;                                                               \
    a.peep = peep;                                                           \
    a.dout = dout;                                                           \
    a.dh_t = dh_t;                                                           \
    a.dc_t = dc_t;                                                           \
    a.dzx = dzx;                                                             \
    a.dh0 = dh0;                                                             \
    a.dc0 = dc0;                                                             \
    a.t_len = t_len;                                                         \
    a.n = n;                                                                 \
    a.h = h;                                                                 \
    return cl::launch<T>(a, mt, static_cast<cudaStream_t>(stream));          \
  }
DL4J_LSTM_BWD_CLUSTER(dl4j_lstm_bwd_cluster_f32, float)
DL4J_LSTM_BWD_CLUSTER(dl4j_lstm_bwd_cluster_bf16, __nv_bfloat16)

// The cluster route's split for N rows and H units on this card (out[8]:
// cluster size, units a block, piece columns, row tiles a block, rows a
// block, clusters, shared memory bytes, clusters the card runs at once).
int dl4j_lstm_bwd_cluster_plan(int n, int h, int bf16, int* out) {
  return bf16 ? cl::plan<__nv_bfloat16>(n, h, false, out)
              : cl::plan<float>(n, h, false, out);
}

#define DL4J_LSTM_FWD_CLUSTER(NAME, T)                                       \
  int NAME(const void* zx, const void* rw, const void* h0, const void* c0,   \
           const void* peep, const void* mask, void* out, void* h_t,         \
           void* c_t, void* gates, void* csave, int t_len, int n, int h,     \
           int mt, void* stream) {                                           \
    cl::FwdClusterArgs a;                                                    \
    a.zx = zx;                                                               \
    a.rw = rw;                                                               \
    a.h0 = h0;                                                               \
    a.c0 = c0;                                                               \
    a.peep = peep;                                                           \
    a.mask = static_cast<const float*>(mask);                                \
    a.out = out;                                                             \
    a.h_t = h_t;                                                             \
    a.c_t = c_t;                                                             \
    a.gates = static_cast<float*>(gates);                                    \
    a.csave = static_cast<float*>(csave);                                    \
    a.t_len = t_len;                                                         \
    a.n = n;                                                                 \
    a.h = h;                                                                 \
    return cl::launch_fwd<T>(a, mt, static_cast<cudaStream_t>(stream));      \
  }
DL4J_LSTM_FWD_CLUSTER(dl4j_lstm_fwd_cluster_f32, float)
DL4J_LSTM_FWD_CLUSTER(dl4j_lstm_fwd_cluster_bf16, __nv_bfloat16)

// The forward's cluster split for N rows and H units on this card (out[8]:
// cluster size, units a block, units a piece (kq), row tiles a block,
// rows a block, clusters, shared memory bytes, clusters the card runs at
// once).
int dl4j_lstm_fwd_cluster_plan(int n, int h, int bf16, int* out) {
  return bf16 ? cl::plan<__nv_bfloat16>(n, h, true, out)
              : cl::plan<float>(n, h, true, out);
}

// The forward's device kernels started so far, by kind (out[2]: the
// cooperative kernel, the cluster kernel).
int dl4j_lstm_fwd_kernel_launches(int* out) {
  for (int i = 0; i < 2; ++i) out[i] = fwd_launched[i];
  return 0;
}

// The backward's device kernels started so far, by kind (out[2]: the
// cooperative kernel, the cluster kernel).
int dl4j_lstm_bwd_kernel_launches(int* out) {
  for (int i = 0; i < 2; ++i) out[i] = bwd_launched[i];
  return 0;
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
