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
// included) and dh_{t-1} = dgates RW^T. dW, db, dRW and dP are products
// and reductions over the whole sequence, computed outside as the JAX
// package computes them outside any Pallas kernel. No float atomics: two
// launches give the same bits.
//
// Translation. The TPU kernel walks T on a sequential grid with RW and the
// (h, c) carry resident in VMEM. Blocks on an H100 run in no order, so the
// time loop moves inside one persistent launch:
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
//
// What bounds it on an H100. Inference at T = N = H = 256, bf16, one
// layer: zx (134 MB) read and out (34 MB) written, 0.050 ms at 3.35 TB/s;
// 2 T N H 4H = 34.4 GFLOP, 0.035 ms at the bf16 tensor-core peak; the
// training forward also writes 336 MB of f32 saves (0.150 ms). No formula
// shows the sequential floor: T dependent steps, each a grid barrier of a
// few microseconds, so about 0.5-1 ms at T = 256. This first version is the
// simple, right one: the products run on the f32 CUDA cores from shared
// memory, and every block re-reads h from L2 each step. mma.sync/wgmma
// for h RW, and clusters sharing h through distributed shared memory, are
// a later kernel's work. The decode shape (N = 1, T = 1) is bound by the
// launch's latency.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns the launch's CUDA
// error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
  return launch<T>(a, false, ub, groups, resident, stream);
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
  return launch<T>(a, true, ub, groups, resident, stream);
}

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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
