// Flash attention forward and recompute backward (dq; dk and dv), for
// Hopper (sm_90a). Layout [B, H, T, D], one (batch, head) row-major.
//
// Replaces the three TPU kernels of
// deeplearning4j_tpu/nn/layers/pallas_attention.py:
//   flash_fwd_kernel      <- `_fwd_kernel`     (pallas_call in `_flash_fwd`)
//   flash_bwd_dq_kernel   <- `_bwd_dq_kernel`  (pallas_call in `_run_bwd_kernels`)
//   flash_bwd_dkv_kernel  <- `_bwd_dkv_kernel` (pallas_call in `_run_bwd_kernels`)
// and, for bf16 head dims that are multiples of 16 up to 128, the
// tensor-core twins of all three, tc::flash_fwd_mma_kernel,
// tc::flash_bwd_dq_mma_kernel and tc::flash_bwd_dkv_mma_kernel (the entry
// points *_bf16_mma).
// Each computes what its TPU kernel computes, with the same rounding
// points and masking:
//   - scores in base 2: s = (q . k) * (scale * log2 e), masked to the
//     finite -1e30 before the exponential, and the masked probabilities
//     zeroed explicitly afterwards, so a fully masked row (key mask of
//     length 0) gives o = 0 and finite, zero gradients;
//   - forward: online softmax (running max m, sum l of the unrounded f32
//     p, f32 accumulator), p rounded to V's dtype before P.V, o = acc /
//     max(l, 1e-30) rounded to the input dtype, lse = m ln 2 + log(max(l,
//     1e-30)) in f32 with a natural log;
//   - dq: p = exp2(s - lse log2 e), ds = p (dO.V^T - delta) scale, ds
//     rounded to K's dtype before ds.K, f32 accumulation;
//   - dk, dv: p rounded to dO's dtype before p^T.dO, ds rounded to Q's
//     dtype before ds^T.Q, f32 accumulation.
// delta = rowsum(dO o O) is computed outside (by the caller, in f32), as
// the JAX package does. The key mask [B, Tk] (nonzero = valid) composes
// with the causal mask; keys past Tk and queries past Tq are never read
// (the JAX package pads T to a block multiple instead and masks the
// padded keys: the same function).
//
// Translation. The TPU grid runs its key (or query) axis in order and
// carries m, l and the accumulators in VMEM scratch from one grid step to
// the next. Hopper blocks run in parallel in no order, so here each
// thread block owns one output tile and loops over the other axis
// itself: the forward and dq blocks own a query tile and walk the key
// tiles up to the causal limit (tiles above the diagonal are never
// visited), the dk/dv block owns a key tile and walks the query tiles
// from the diagonal down. The 1-D grid puts the heaviest tiles first
// (under causal masking the last query tiles and the first key tiles do
// the most work), so the tail of the grid is short blocks.
//
// What bounds it on an H100. At the training shape (B=4, H=8, T=8192,
// D=64, causal, bf16) the forward does ~2.75e11 matmul flops and ~1.07e9
// exponentials over 134 MB of q, k, v and o: at the tensor cores' 989
// TFLOP/s the flops take ~0.28 ms, the exponentials about as long on the
// special-function units (16 a clock an SM), the bytes ~0.04 ms. dq does
// 1.5x the forward's flops, dk/dv 2x. So all three are bounded by
// operations, and none of them reaches that bound on the f32 CUDA cores
// (67 TFLOP/s): the products have to run on the tensor cores, and the
// per-score work between them (scale, mask, exponential, the running max
// and sum) has to stay in registers, off shared memory.
//
// Two designs. f32 everywhere, and bf16 head dims off the tensor-core
// route (not a multiple of 16, or over 128), run the first, simple one:
// tiles of q/k/v/dO staged in shared memory as f32 (rows padded to an
// odd stride, so that a warp's reads are free of bank conflicts), and
// every dot product on the f32 CUDA cores, each thread owning a 4x4 (or
// 2x2) block of the score tile and a strip of the output tile in
// registers; the forward's p makes a round trip through shared memory.
// Its ceiling is the f32 rate; f32 stays exact f32 there (no TF32).
//
// bf16 at head dims that are multiples of 16 up to 128 (the namespace tc
// below) runs on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulators, fed by ldmatrix from bf16 tiles (conv_mma.cuh's
// primitives). A block of four warps owns 64 rows (16 a warp; the
// forward's 128 up to D=64, 32 a warp, so that each ldmatrix of K or V
// feeds two products: with one, the shared-memory reads take as long as
// the products) and holds their operands as A fragments in registers
// (read again from shared memory at each step where registers are short,
// D > 64). The forward and
// dq own queries: S = Q.K^T (and, for dq, dP = dO.V^T) land in the
// accumulators. The forward keeps its online softmax there: each lane
// holds two rows' running max and sum, reduced over the four lanes of a
// quad with shuffles, and p, packed to bf16 (the rounding point before
// P.V), is the A operand of O += P.V with V read through ldmatrix.trans.
// dq computes p and ds there, and ds, packed to bf16 (the rounding point
// before ds.K), is the A operand of dQ += ds.K. So neither p nor ds goes
// through shared memory. dk/dv owns keys and computes the transposed
// scores S^T = K.Q^T and dP^T = V.dO^T, so the keys are the accumulator
// rows and p^T (rounded to bf16) and ds^T (from the unrounded f32 p, then
// rounded) are already the A operands of dV += p^T.dO and dK += ds^T.Q;
// lse and delta are per column there, staged beside each query tile. The
// next K/V tile (forward, dq) or Q/dO/lse/delta tile (dk/dv) is copied
// with 16-byte cp.async (zero-filled past T and d) while the warps
// multiply the current one. Masks only where they bite: interior causal
// tiles take an unmasked body, as the JAX kernels' _dispatch does; the
// diagonal, the ragged tails and every tile under a key mask mask before
// the exponential and zero after it. Each tile's o, dq, dk or dv product
// is taken into zeroed fragments and added to the running sums with a
// round-to-nearest f32 add (the tensor cores' own accumulation rounds
// toward zero, and a T of 8192 has 128 tiles). No atomics: a repeated
// launch is bitwise equal. What bounds them now (on an H100 at the
// training shape, a quarter to a third of the tensor cores' peak,
// PERF.md): four warps a block and few blocks an SM, so little latency
// hiding; the exponential, the scaling and the masks per element on the
// FMA and special-function pipes between the products; mma.sync's share
// of the tensor cores' rate. wgmma fed by TMA with warp specialisation (a
// producer warp, consumer warpgroups) is the next step.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "conv_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;  // a 16 x 16 grid of threads per block
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

// x rounded to T and widened back: the TPU kernel's `.astype(dtype)`
// before a dot with f32 accumulation
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 threads of one row of the thread grid (lanes
// 0-15 and 16-31 of a warp are two rows)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tile geometry. A block tile has BLK = 16 * R rows (queries or keys);
// thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j. Head dims are padded to W = 16 * DC columns (zeros past d)
// and every f32 tile row takes LD = W + 1 floats: an odd stride puts the
// 16 rows a warp reads at once in 16 different banks.
template <int R, int DC>
struct Tile {
  static constexpr int BLK = 16 * R;
  static constexpr int W = 16 * DC;
  static constexpr int LD = W + 1;
  static constexpr int PLD = BLK + 1;  // score-tile row stride
};

// rows [row0, row0 + BLK) of one (batch, head) slice into an f32 tile;
// rows past n_rows and columns past d read as 0
template <typename T, int R, int DC>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int d) {
  using G = Tile<R, DC>;
  for (int i = threadIdx.x; i < G::BLK * G::W; i += kThreads) {
    const int r = i / G::W;
    const int c = i - r * G::W;
    const int row = row0 + r;
    dst[r * G::LD + c] =
        row < n_rows && c < d ? to_f32(src[(size_t)row * d + c]) : 0.f;
  }
}

// 1 for each key of the tile that exists and the key mask keeps
__device__ __forceinline__ void load_key_flags(float* kv_s,
                                               const unsigned char* km,
                                               int k0, int blk, int tk) {
  for (int i = threadIdx.x; i < blk; i += kThreads) {
    const int key = k0 + i;
    kv_s[i] = key < tk && (km == nullptr || km[key] != 0) ? 1.f : 0.f;
  }
}

// s[i][j] = sum_c a[ty + 16 i][c] * b[tx + 16 j][c]
template <int R, int DC>
__device__ __forceinline__ void tile_dot(float (&s)[R][R], const float* a_s,
                                         const float* b_s, int d, int ty,
                                         int tx) {
  using G = Tile<R, DC>;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = a_s[(ty + 16 * i) * G::LD + c];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = b_s[(tx + 16 * j) * G::LD + c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// two score tiles sharing one loop: s = a . b^T and t = c . e^T
template <int R, int DC>
__device__ __forceinline__ void tile_dot2(float (&s)[R][R], float (&t)[R][R],
                                          const float* a_s, const float* b_s,
                                          const float* c_s, const float* e_s,
                                          int d, int ty, int tx) {
  using G = Tile<R, DC>;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < d; ++c) {
    float a[R], b[R], x[R], y[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = a_s[(ty + 16 * i) * G::LD + c];
      x[i] = c_s[(ty + 16 * i) * G::LD + c];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b[j] = b_s[(tx + 16 * j) * G::LD + c];
      y[j] = e_s[(tx + 16 * j) * G::LD + c];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        t[i][j] = fmaf(x[i], y[j], t[i][j]);
      }
  }
}

// acc[i][jc] += sum_k w(ty + 16 i, k) * m[k][tx + 16 jc] over the BLK
// rows k of the tile m, where w(r, k) = w_s[r * w_r + k * w_k]
template <int R, int DC>
__device__ __forceinline__ void tile_accumulate(float (&acc)[R][DC],
                                                const float* w_s, int w_r,
                                                int w_k, const float* m_s,
                                                int ty, int tx) {
  using G = Tile<R, DC>;
#pragma unroll 4
  for (int k = 0; k < G::BLK; ++k) {
    float w[R], m[DC];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = w_s[(ty + 16 * i) * w_r + k * w_k];
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) m[jc] = m_s[k * G::LD + tx + 16 * jc];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int jc = 0; jc < DC; ++jc) acc[i][jc] = fmaf(w[i], m[jc], acc[i][jc]);
  }
}

// acc[i][*] -> out rows row0 + ty + 16 i (below n_rows), columns below d
template <typename T, int R, int DC>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[R][DC],
                                           int row0, int n_rows, int d,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) {
      const int col = tx + 16 * jc;
      if (col < d) out[(size_t)row * d + col] = from_f32<T>(acc[i][jc]);
    }
  }
}

// ---------------------------------------------------------------------
// forward: one block per (query tile, batch x head)
// ---------------------------------------------------------------------
template <typename T, int R, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const unsigned char* __restrict__ kmask,
                     T* __restrict__ o, float* __restrict__ lse, int bh_n,
                     int heads, int tq, int tk, int d, int causal,
                     float scale_log2) {
  using G = Tile<R, DC>;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BLK][LD] queries
  float* k_s = q_s + G::BLK * G::LD;   // [BLK][LD] keys
  float* v_s = k_s + G::BLK * G::LD;   // [BLK][LD] values
  float* p_s = v_s + G::BLK * G::LD;   // [BLK][PLD] p rounded to T
  float* kv_s = p_s + G::BLK * G::PLD;  // [BLK] key validity

  const int n_qt = (tq + G::BLK - 1) / G::BLK;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_n)) * G::BLK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, R, DC>(q_s, q + (size_t)bh * tq * d, q0, tq, d);
  float m[R], l[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) acc[i][jc] = 0.f;
  }
  // causal: keys past the tile's last query are never visible
  const int k_end = causal ? min(tk, q0 + G::BLK) : tk;
  for (int k0 = 0; k0 < k_end; k0 += G::BLK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, R, DC>(k_s, kb, k0, tk, d);
    load_tile<T, R, DC>(v_s, vb, k0, tk, d);
    load_key_flags(kv_s, km, k0, G::BLK, tk);
    __syncthreads();
    float s[R][R];
    tile_dot<R, DC>(s, q_s, k_s, d, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[R];
      float bmax = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = tx + 16 * j;
        ok[j] = kv_s[key] != 0.f && (!causal || k0 + key <= row);
        s[i][j] = ok[j] ? s[i][j] * scale_log2 : kNegInf;
        bmax = fmaxf(bmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(bmax));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        // explicit zeroing: in a fully masked row exp2(-1e30 - -1e30) = 1
        const float p = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
        psum += p;
        p_s[(ty + 16 * i) * G::PLD + tx + 16 * j] = round_to<T>(p);
      }
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jc = 0; jc < DC; ++jc) acc[i][jc] *= corr;
    }
    __syncthreads();
    tile_accumulate<R, DC>(acc, p_s, G::PLD, 1, v_s, ty, tx);
  }

  const size_t ob = (size_t)bh * tq;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) acc[i][jc] = acc[i][jc] / lc;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < tq) lse[ob + row] = m[i] * kLn2 + logf(lc);
  }
  store_rows<T, R, DC>(o + ob * d, acc, q0, tq, d, ty, tx);
}

// ---------------------------------------------------------------------
// backward dq: one block per (query tile, batch x head)
// ---------------------------------------------------------------------
template <typename T, int R, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const unsigned char* __restrict__ kmask,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int bh_n, int heads, int tq, int tk, int d,
                        int causal, float scale, float scale_log2) {
  using G = Tile<R, DC>;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BLK][LD]
  float* do_s = q_s + G::BLK * G::LD;   // [BLK][LD]
  float* k_s = do_s + G::BLK * G::LD;   // [BLK][LD]
  float* v_s = k_s + G::BLK * G::LD;    // [BLK][LD]
  float* ds_s = v_s + G::BLK * G::LD;   // [BLK][PLD] ds rounded to T
  float* kv_s = ds_s + G::BLK * G::PLD;  // [BLK]

  const int n_qt = (tq + G::BLK - 1) / G::BLK;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_n)) * G::BLK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rb = (size_t)bh * tq;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, R, DC>(q_s, q + rb * d, q0, tq, d);
  load_tile<T, R, DC>(do_s, dout + rb * d, q0, tq, d);
  float lse2[R], dl[R], acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse2[i] = row < tq ? lse[rb + row] * kLog2e : 0.f;
    dl[i] = row < tq ? delta[rb + row] : 0.f;
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) acc[i][jc] = 0.f;
  }
  const int k_end = causal ? min(tk, q0 + G::BLK) : tk;
  for (int k0 = 0; k0 < k_end; k0 += G::BLK) {
    __syncthreads();
    load_tile<T, R, DC>(k_s, kb, k0, tk, d);
    load_tile<T, R, DC>(v_s, vb, k0, tk, d);
    load_key_flags(kv_s, km, k0, G::BLK, tk);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot2<R, DC>(s, dp, q_s, k_s, do_s, v_s, d, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = tx + 16 * j;
        const bool ok = kv_s[key] != 0.f && (!causal || k0 + key <= row);
        // masked before the exponential: a masked raw score above the
        // row's lse would overflow to inf, and 0 * inf = NaN
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        const float ds = p * (dp[i][j] - dl[i]) * scale;
        ds_s[(ty + 16 * i) * G::PLD + key] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_accumulate<R, DC>(acc, ds_s, G::PLD, 1, k_s, ty, tx);
  }
  store_rows<T, R, DC>(dq + rb * d, acc, q0, tq, d, ty, tx);
}

// ---------------------------------------------------------------------
// backward dk, dv: one block per (key tile, batch x head)
// ---------------------------------------------------------------------
template <typename T, int R, int DC>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const unsigned char* __restrict__ kmask,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int bh_n,
                         int heads, int tq, int tk, int d, int causal,
                         float scale, float scale_log2) {
  using G = Tile<R, DC>;
  extern __shared__ float smem[];
  float* k_s = smem;                     // [BLK][LD]
  float* v_s = k_s + G::BLK * G::LD;     // [BLK][LD]
  float* q_s = v_s + G::BLK * G::LD;     // [BLK][LD]
  float* do_s = q_s + G::BLK * G::LD;    // [BLK][LD]
  float* pt_s = do_s + G::BLK * G::LD;   // [BLK][PLD] p rounded to T
  float* ds_s = pt_s + G::BLK * G::PLD;  // [BLK][PLD] ds rounded to T
  float* kv_s = ds_s + G::BLK * G::PLD;  // [BLK]
  float* lse2_s = kv_s + G::BLK;         // [BLK]
  float* dl_s = lse2_s + G::BLK;         // [BLK]

  const int bh = blockIdx.x % bh_n;
  const int k0 = (int)(blockIdx.x / bh_n) * G::BLK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rb = (size_t)bh * tq;
  const size_t kbase = (size_t)bh * tk * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  load_tile<T, R, DC>(k_s, k + kbase, k0, tk, d);
  load_tile<T, R, DC>(v_s, v + kbase, k0, tk, d);
  load_key_flags(kv_s, km, k0, G::BLK, tk);
  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jc = 0; jc < DC; ++jc) dk_acc[i][jc] = dv_acc[i][jc] = 0.f;
  // causal: query rows before the tile's first key see none of it
  for (int q0 = causal ? k0 : 0; q0 < tq; q0 += G::BLK) {
    __syncthreads();
    load_tile<T, R, DC>(q_s, q + rb * d, q0, tq, d);
    load_tile<T, R, DC>(do_s, dout + rb * d, q0, tq, d);
    for (int r = threadIdx.x; r < G::BLK; r += kThreads) {
      const int row = q0 + r;
      lse2_s[r] = row < tq ? lse[rb + row] * kLog2e : 0.f;
      dl_s[r] = row < tq ? delta[rb + row] : 0.f;
    }
    __syncthreads();
    // rows of s and dp are queries (ty + 16 i), columns keys (tx + 16 j)
    float s[R][R], dp[R][R];
    tile_dot2<R, DC>(s, dp, q_s, k_s, do_s, v_s, d, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int key = tx + 16 * j;
        const bool ok = row < tq && kv_s[key] != 0.f &&
                        (!causal || k0 + key <= row);
        const float p = ok ? exp2f(s[i][j] * scale_log2 - lse2_s[r]) : 0.f;
        pt_s[r * G::PLD + key] = round_to<T>(p);
        ds_s[r * G::PLD + key] = round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
      }
    }
    __syncthreads();
    // dv[key][:] += sum_row pt[row][key] dO[row][:], keys ty + 16 i
    tile_accumulate<R, DC>(dv_acc, pt_s, 1, G::PLD, do_s, ty, tx);
    tile_accumulate<R, DC>(dk_acc, ds_s, 1, G::PLD, q_s, ty, tx);
  }
  store_rows<T, R, DC>(dk + kbase, dk_acc, k0, tk, d, ty, tx);
  store_rows<T, R, DC>(dv + kbase, dv_acc, k0, tk, d, ty, tx);
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > (size_t)kMaxDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// the shared memory of each kernel, in bytes (above 48 KiB, prepare()
// asks for it and returns the error if the card refuses)
template <int R, int DC>
constexpr size_t fwd_smem() {
  using G = Tile<R, DC>;
  return sizeof(float) * (3 * G::BLK * G::LD + G::BLK * G::PLD + G::BLK);
}
template <int R, int DC>
constexpr size_t dq_smem() {
  using G = Tile<R, DC>;
  return sizeof(float) * (4 * G::BLK * G::LD + G::BLK * G::PLD + G::BLK);
}
template <int R, int DC>
constexpr size_t dkv_smem() {
  using G = Tile<R, DC>;
  return sizeof(float) * (4 * G::BLK * G::LD + 2 * G::BLK * G::PLD +
                          3 * G::BLK);
}

template <typename T, int R, int DC>
int launch_fwd(const void* q, const void* k, const void* v, const void* km,
               void* o, void* lse, int bh_n, int heads, int tq, int tk, int d,
               int causal, float scale_log2, cudaStream_t stream) {
  const size_t smem = fwd_smem<R, DC>();
  const int err = prepare(flash_fwd_kernel<T, R, DC>, smem);
  if (err) return err;
  const int n_tiles = (tq + Tile<R, DC>::BLK - 1) / Tile<R, DC>::BLK;
  flash_fwd_kernel<T, R, DC><<<n_tiles * bh_n, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(km),
      static_cast<T*>(o), static_cast<float*>(lse), bh_n, heads, tq, tk, d,
      causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int R, int DC>
int launch_dq(const void* q, const void* k, const void* v, const void* km,
              const void* dout, const void* lse, const void* delta, void* dq,
              int bh_n, int heads, int tq, int tk, int d, int causal,
              float scale, float scale_log2, cudaStream_t stream) {
  const size_t smem = dq_smem<R, DC>();
  const int err = prepare(flash_bwd_dq_kernel<T, R, DC>, smem);
  if (err) return err;
  const int n_tiles = (tq + Tile<R, DC>::BLK - 1) / Tile<R, DC>::BLK;
  flash_bwd_dq_kernel<T, R, DC><<<n_tiles * bh_n, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(km),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), bh_n, heads, tq,
      tk, d, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int R, int DC>
int launch_dkv(const void* q, const void* k, const void* v, const void* km,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, int bh_n, int heads, int tq, int tk, int d,
               int causal, float scale, float scale_log2,
               cudaStream_t stream) {
  const size_t smem = dkv_smem<R, DC>();
  const int err = prepare(flash_bwd_dkv_kernel<T, R, DC>, smem);
  if (err) return err;
  const int n_tiles = (tk + Tile<R, DC>::BLK - 1) / Tile<R, DC>::BLK;
  flash_bwd_dkv_kernel<T, R, DC><<<n_tiles * bh_n, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(km),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), bh_n, heads, tq, tk, d, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

// tile shapes by head dim: 64-row tiles up to d = 128, 32-row tiles up
// to d = 256 (shared memory); the wrapper refuses d > 256
template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* km, void* o,
        void* lse, int bh_n, int heads, int tq, int tk, int d, int causal,
        float scale_log2, void* stream) {
  if (bh_n <= 0 || tq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_fwd<T, 4, 4>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                               causal, scale_log2, s);
  if (d <= 128)
    return launch_fwd<T, 4, 8>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                               causal, scale_log2, s);
  return launch_fwd<T, 2, 16>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                              causal, scale_log2, s);
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* km,
       const void* dout, const void* lse, const void* delta, void* dq_out,
       int bh_n, int heads, int tq, int tk, int d, int causal, float scale,
       float scale_log2, void* stream) {
  if (bh_n <= 0 || tq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dq<T, 4, 4>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                              heads, tq, tk, d, causal, scale, scale_log2, s);
  if (d <= 128)
    return launch_dq<T, 4, 8>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                              heads, tq, tk, d, causal, scale, scale_log2, s);
  return launch_dq<T, 2, 16>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                             heads, tq, tk, d, causal, scale, scale_log2, s);
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* km,
        const void* dout, const void* lse, const void* delta, void* dk,
        void* dv, int bh_n, int heads, int tq, int tk, int d, int causal,
        float scale, float scale_log2, void* stream) {
  if (bh_n <= 0 || tk <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dkv<T, 4, 4>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                               heads, tq, tk, d, causal, scale, scale_log2, s);
  if (d <= 128)
    return launch_dkv<T, 4, 8>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                               heads, tq, tk, d, causal, scale, scale_log2, s);
  return launch_dkv<T, 2, 16>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                              heads, tq, tk, d, causal, scale, scale_log2, s);
}

// ---------------------------------------------------------------------
// bf16 on the tensor cores (head dims 16..128, multiples of 16)
// ---------------------------------------------------------------------
namespace tc {

using dl4j_mma::bf16;
using dl4j_mma::ldsm_x4;
using dl4j_mma::mma_16816;
using dl4j_mma::pack2;
using dl4j_mma::smem_addr;

constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // a block's own rows: queries or keys

// bf16 tiles of a head dim padded to DP (zeros past d): rows LD = DP + 8
// elements apart, DP / 8 + 1 16-byte groups (an odd number), so the
// eight rows of one ldmatrix phase hit eight distinct bank groups
template <int DP>
struct Geo {
  static constexpr int LD = DP + 8;
  static constexpr int KS = DP / 16;  // 16-deep steps over the head dim
  static constexpr int NF = DP / 8;   // n8 fragments across the head dim
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// rows [row0, row0 + N) of a [n_rows, d] matrix into an [N][LD] tile, as
// 16-byte copies in flight (zero-filled past n_rows and past d)
template <int DP, int N>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int n_rows, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < N * CH; i += kThreadsTc) {
    const int r = i / CH;
    const int c = i - r * CH;
    const int row = row0 + r;
    const bool ok = row < n_rows && c * 8 < d;
    dl4j_mma::cp_async16(dst + r * Geo<DP>::LD + c * 8,
                         ok ? src + (size_t)row * d + c * 8 : src, ok);
  }
}

// the f32 values of rows [row0, row0 + N) (lse or delta), 0 past n_rows
template <int N>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int row0, int n_rows) {
  for (int i = threadIdx.x; i < N; i += kThreadsTc) {
    const bool ok = row0 + i < n_rows;
    cp_async4(dst + i, ok ? src + row0 + i : src, ok);
  }
}

// The A operand of a warp's 16 rows (from row r0 of an [*][LD] tile) over
// the head dim: held in registers (HOLD) or read by ldmatrix at each step
// where registers are short (Plan, DP = 128).
template <int DP, bool HOLD>
struct RowsA {
  uint32_t f[HOLD ? Geo<DP>::KS : 1][4];
  uint32_t base;  // this lane's ldmatrix row address in the tile

  __device__ __forceinline__ void init(const bf16* tile, int r0, int lane) {
    base = smem_addr(tile + (r0 + (lane & 15)) * Geo<DP>::LD +
                     dl4j_mma::a_k(lane));
    if constexpr (HOLD) {
#pragma unroll
      for (int ks = 0; ks < Geo<DP>::KS; ++ks)
        ldsm_x4<false>(base + ks * 32, f[ks]);
    }
  }
  __device__ __forceinline__ const uint32_t (&at(int ks))[4] {
    if constexpr (HOLD) {
      return f[ks];
    } else {
      ldsm_x4<false>(base + ks * 32, f[0]);
      return f[0];
    }
  }
};

// acc[mt] (16 x N each, n8 fragments) = A[mt] . B^T over the head dim
// for MT row tiles, B an [N][LD] tile whose rows are acc's columns, each
// ldmatrix of B feeding MT products; into zeroed fragments
template <int DP, int N, int MT, bool HOLD>
__device__ __forceinline__ void dot_nt_rows(float (&acc)[MT][N / 8][4],
                                            RowsA<DP, HOLD> (&a)[MT],
                                            const bf16* b_tile, int lane) {
  constexpr int LD = Geo<DP>::LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  const uint32_t b0 = smem_addr(b_tile + dl4j_mma::b_n(lane) * LD +
                                dl4j_mma::b_k(lane));
#pragma unroll
  for (int ks = 0; ks < Geo<DP>::KS; ++ks) {
    const uint32_t* af[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) af[mt] = a[mt].at(ks);
#pragma unroll
    for (int h = 0; h < N / 16; ++h) {
      uint32_t b[4];
      ldsm_x4<false>(b0 + (h * 16 * LD + ks * 16) * 2, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t(&am)[4] =
            *reinterpret_cast<const uint32_t(*)[4]>(af[mt]);
        mma_16816(acc[mt][2 * h], am, b[0], b[1]);
        mma_16816(acc[mt][2 * h + 1], am, b[2], b[3]);
      }
    }
  }
}

// dot_nt_rows of one row tile
template <int DP, int N, bool HOLD>
__device__ __forceinline__ void dot_nt(float (&acc)[N / 8][4],
                                       RowsA<DP, HOLD>& a,
                                       const bf16* b_tile, int lane) {
  dot_nt_rows<DP, N, 1, HOLD>(
      reinterpret_cast<float(&)[1][N / 8][4]>(acc),
      reinterpret_cast<RowsA<DP, HOLD>(&)[1]>(a), b_tile, lane);
}

// C fragments (16 x N) as the A operand of the next product (16-deep
// steps over N), rounded to bf16: the rounding point before ds.K, p^T.dO
// and ds^T.Q
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&c)[N / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    a[ks][0] = pack2(c[2 * ks][0], c[2 * ks][1]);
    a[ks][1] = pack2(c[2 * ks][2], c[2 * ks][3]);
    a[ks][2] = pack2(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    a[ks][3] = pack2(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// tot[mt] (16 x DP) += A[mt] . B for MT row tiles, A[mt] the packed
// 16 x N operand, B an [N][LD] tile whose rows are the reduction index
// (read with ldmatrix.trans), each ldmatrix feeding MT products. Each
// pair of n8 fragments takes the tile's product into zeroed fragments
// and adds it to the running sums in round-to-nearest f32: the tensor
// cores' own accumulation rounds toward zero, a bias that would grow
// over the up to 128 tiles of a sequence of 8192.
template <int DP, int N, int MT>
__device__ __forceinline__ void acc_nn_rows(
    float (&tot)[MT][Geo<DP>::NF][4], const uint32_t (&a)[MT][N / 16][4],
    const bf16* b_tile, int lane) {
  constexpr int LD = Geo<DP>::LD;
  const uint32_t b0 = smem_addr(b_tile + dl4j_mma::b_trans_k(lane) * LD +
                                dl4j_mma::b_trans_n(lane));
#pragma unroll
  for (int h = 0; h < DP / 16; ++h) {
    float c[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[mt][0][e] = c[mt][1][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4<true>(b0 + (ks * 16 * LD + h * 16) * 2, b);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(c[mt][0], a[mt][ks], b[0], b[1]);
        mma_16816(c[mt][1], a[mt][ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[mt][2 * h][e] = __fadd_rn(tot[mt][2 * h][e], c[mt][0][e]);
        tot[mt][2 * h + 1][e] = __fadd_rn(tot[mt][2 * h + 1][e], c[mt][1][e]);
      }
  }
}

// acc_nn_rows of one row tile
template <int DP, int N>
__device__ __forceinline__ void acc_nn(float (&tot)[Geo<DP>::NF][4],
                                       const uint32_t (&a)[N / 16][4],
                                       const bf16* b_tile, int lane) {
  acc_nn_rows<DP, N, 1>(
      reinterpret_cast<float(&)[1][Geo<DP>::NF][4]>(tot),
      reinterpret_cast<const uint32_t(&)[1][N / 16][4]>(a), b_tile, lane);
}

// a warp's 16 x DP sums (this lane's rows r_lo and r_lo + 8) into the
// rows below n_rows and the columns below d of a [n_rows, d] bf16 matrix
template <int DP>
__device__ __forceinline__ void store_tot(bf16* out,
                                          const float (&tot)[Geo<DP>::NF][4],
                                          int r_lo, int n_rows, int d,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < Geo<DP>::NF; ++n) {
    const int col = n * 8 + 2 * (lane & 3);
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row < n_rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * d + col) =
            pack2(tot[n][2 * h], tot[n][2 * h + 1]);
    }
  }
}

// The tile plan by head dim (padded to 32, 64 or 128), from the kernels'
// times at T=8192 on the H100: the walked tiles are 64 rows; up to 64
// the A operands are held in registers and the registers capped for three
// blocks an SM (dk/dv at 64 spills a few hundred bytes for it and is
// faster all the same); at 128, where the sums of dk and dv alone take
// 128 registers a thread, the A operands are read from shared memory at
// each step and one block's registers are not capped.
template <int DP>
struct Plan {
  static constexpr int kTile = 64;
  static constexpr bool kHold = DP <= 64;
  static constexpr int kMinBlocks = DP <= 64 ? 3 : 1;
};

// the shared memory of each kernel, in bytes: its own rows' two tiles,
// two buffers of the walked tile's two, and (dk/dv) lse and delta
template <int DP>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (2 * kOwn + 4 * Plan<DP>::kTile) * Geo<DP>::LD;
}
template <int DP>
constexpr size_t dkv_smem() {
  return dq_smem<DP>() + sizeof(float) * 4 * Plan<DP>::kTile;
}

// dq: a block owns 64 queries (16 a warp), holds their q and dO as A
// operands and walks the key tiles of BK keys up to the causal limit,
// double-buffered: S = Q.K^T and dP = dO.V^T into the accumulators, p and
// ds there too, ds repacked as the A operand of dQ += ds.K.
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, Plan<DP>::kMinBlocks)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const unsigned char* __restrict__ kmask,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int bh_n, int heads,
                            int tq, int tk, int d, int causal, float scale,
                            float scale_log2) {
  constexpr int LD = Geo<DP>::LD;
  constexpr int BK = Plan<DP>::kTile;
  constexpr bool HOLD = Plan<DP>::kHold;
  constexpr int NF = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][LD]
  bf16* do_s = q_s + kOwn * LD;                   // [kOwn][LD]
  bf16* k_s = do_s + kOwn * LD;                   // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]

  const int n_qt = (tq + kOwn - 1) / kOwn;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_n)) * kOwn;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t rb = (size_t)bh * tq;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  const int k_end = causal ? min(tk, q0 + kOwn) : tk;
  const int n_kt = (k_end + BK - 1) / BK;
  stage_rows<DP, kOwn>(q_s, q + rb * d, q0, tq, d);
  stage_rows<DP, kOwn>(do_s, dout + rb * d, q0, tq, d);
  if (n_kt > 0) {
    stage_rows<DP, BK>(k_s, kb, 0, tk, d);
    stage_rows<DP, BK>(v_s, vb, 0, tk, d);
  }
  dl4j_mma::cp_async_commit();

  // this lane's rows of the accumulators: r_lo and r_lo + 8
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    lse2[h] = row < tq ? __fmul_rn(lse[rb + row], kLog2e) : 0.f;
    dl[h] = row < tq ? delta[rb + row] : 0.f;
  }
  float tot[Geo<DP>::NF][4];
#pragma unroll
  for (int n = 0; n < Geo<DP>::NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[n][e] = 0.f;
  RowsA<DP, HOLD> qa, da;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_kt) {  // the next tile in flight over this one's work
      stage_rows<DP, BK>(k_s + ((j + 1) & 1) * BK * LD, kb, k0 + BK, tk, d);
      stage_rows<DP, BK>(v_s + ((j + 1) & 1) * BK * LD, vb, k0 + BK, tk, d);
    }
    dl4j_mma::cp_async_commit();
    dl4j_mma::cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      qa.init(q_s, 16 * warp, lane);
      da.init(do_s, 16 * warp, lane);
    }
    const bf16* kt = k_s + (j & 1) * BK * LD;
    const bf16* vt = v_s + (j & 1) * BK * LD;
    float s[NF][4], dp[NF][4];
    dot_nt<DP, BK>(s, qa, kt, lane);
    dot_nt<DP, BK>(dp, da, vt, lane);

    // ds = p (dp - delta) scale, into s; masks only where they bite:
    // the diagonal tile, the ragged tail of the keys, a key mask
    auto probs = [&](auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(s[n][e], scale_log2);
          bool ok = true;
          if (kMasked) {
            const int row = r_lo + 8 * (e >> 1);
            const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
            ok = key < tk && (km == nullptr || km[key] != 0) &&
                 (!causal || key <= row);
            // before the exponential: a masked raw score above the
            // row's lse would overflow to inf, and 0 * inf = NaN
            if (!ok) x = kNegInf;
          }
          float p = exp2f(__fsub_rn(x, lse2[e >> 1]));
          if (kMasked && !ok) p = 0.f;
          s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], dl[e >> 1])),
                              scale);
        }
    };
    if (km != nullptr || k0 + BK > tk || (causal && k0 + BK - 1 > q0))
      probs(std::true_type{});
    else
      probs(std::false_type{});
    uint32_t dsa[BK / 16][4];
    pack_a<BK>(dsa, s);
    acc_nn<DP, BK>(tot, dsa, kt, lane);
    __syncthreads();  // every warp is done with this buffer
  }
  dl4j_mma::cp_async_wait<0>();
  store_tot<DP>(dq + rb * d, tot, r_lo, tq, d, lane);
}

// dk, dv: a block owns 64 keys (16 a warp), holds their k and v as A
// operands and walks the query tiles of BQ queries from the causal
// diagonal on, double-buffered with their lse and delta: S^T = K.Q^T and
// dP^T = V.dO^T put the keys on the accumulator rows, so p^T (rounded)
// and ds^T (from the unrounded p, then rounded) are already the A
// operands of dV += p^T.dO and dK += ds^T.Q; lse and delta are per
// column.
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, Plan<DP>::kMinBlocks)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const unsigned char* __restrict__ kmask,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int bh_n, int heads, int tq, int tk, int d,
                             int causal, float scale, float scale_log2) {
  constexpr int LD = Geo<DP>::LD;
  constexpr int BQ = Plan<DP>::kTile;
  constexpr bool HOLD = Plan<DP>::kHold;
  constexpr int NF = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][LD]
  bf16* v_s = k_s + kOwn * LD;                    // [kOwn][LD]
  bf16* q_s = v_s + kOwn * LD;                    // [2][BQ][LD]
  bf16* do_s = q_s + 2 * BQ * LD;                 // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][BQ]

  const int bh = blockIdx.x % bh_n;
  const int k0 = (int)(blockIdx.x / bh_n) * kOwn;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t rb = (size_t)bh * tq;
  const size_t kbase = (size_t)bh * tk * d;
  const bf16* qb = q + rb * d;
  const bf16* dob = dout + rb * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  // causal: query rows before the tile's first key see none of it
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < tq ? (tq - q_begin + BQ - 1) / BQ : 0;
  stage_rows<DP, kOwn>(k_s, k + kbase, k0, tk, d);
  stage_rows<DP, kOwn>(v_s, v + kbase, k0, tk, d);
  auto stage_queries = [&](int buf, int q0) {
    stage_rows<DP, BQ>(q_s + buf * BQ * LD, qb, q0, tq, d);
    stage_rows<DP, BQ>(do_s + buf * BQ * LD, dob, q0, tq, d);
    stage_vec<BQ>(lse_s + buf * BQ, lse + rb, q0, tq);
    stage_vec<BQ>(dl_s + buf * BQ, delta + rb, q0, tq);
  };
  if (n_qt > 0) stage_queries(0, q_begin);
  dl4j_mma::cp_async_commit();

  // this lane's keys (accumulator rows r_lo and r_lo + 8): kept by the
  // key mask and below tk
  const int r_lo = k0 + 16 * warp + (lane >> 2);
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = r_lo + 8 * h;
    key_ok[h] = key < tk && (km == nullptr || km[key] != 0);
  }
  float dk_tot[Geo<DP>::NF][4], dv_tot[Geo<DP>::NF][4];
#pragma unroll
  for (int n = 0; n < Geo<DP>::NF; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_tot[n][e] = dv_tot[n][e] = 0.f;
  RowsA<DP, HOLD> ka, va;

  for (int i = 0; i < n_qt; ++i) {
    const int q0 = q_begin + i * BQ;
    if (i + 1 < n_qt) stage_queries((i + 1) & 1, q0 + BQ);
    dl4j_mma::cp_async_commit();
    dl4j_mma::cp_async_wait<1>();
    __syncthreads();
    if (i == 0) {
      ka.init(k_s, 16 * warp, lane);
      va.init(v_s, 16 * warp, lane);
    }
    const bf16* qt = q_s + (i & 1) * BQ * LD;
    const bf16* dot = do_s + (i & 1) * BQ * LD;
    const float* ls = lse_s + (i & 1) * BQ;
    const float* dls = dl_s + (i & 1) * BQ;
    float st[NF][4], dpt[NF][4];
    dot_nt<DP, BQ>(st, ka, qt, lane);
    dot_nt<DP, BQ>(dpt, va, dot, lane);

    // p^T into st (f32), ds^T into dpt; masks only where they bite: the
    // diagonal tile, the ragged tails of queries and keys, a key mask
    auto probs = [&](auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * (lane & 3) + (e & 1);
          float x = __fmul_rn(st[n][e], scale_log2);
          bool ok = true;
          if (kMasked) {
            const int query = q0 + col;
            ok = query < tq && key_ok[e >> 1] &&
                 (!causal || r_lo + 8 * (e >> 1) <= query);
            if (!ok) x = kNegInf;  // before the exponential, as in dq
          }
          float p = exp2f(__fsub_rn(x, __fmul_rn(ls[col], kLog2e)));
          if (kMasked && !ok) p = 0.f;
          st[n][e] = p;
          dpt[n][e] = __fmul_rn(
              __fmul_rn(p, __fsub_rn(dpt[n][e], dls[col])), scale);
        }
    };
    if (km != nullptr || k0 + kOwn > tk || q0 + BQ > tq ||
        (causal && k0 + kOwn - 1 > q0))
      probs(std::true_type{});
    else
      probs(std::false_type{});
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    pack_a<BQ>(pa, st);
    pack_a<BQ>(dsa, dpt);
    acc_nn<DP, BQ>(dv_tot, pa, dot, lane);
    acc_nn<DP, BQ>(dk_tot, dsa, qt, lane);
    __syncthreads();  // every warp is done with this buffer
  }
  dl4j_mma::cp_async_wait<0>();
  store_tot<DP>(dk + kbase, dk_tot, r_lo, tk, d, lane);
  store_tot<DP>(dv + kbase, dv_tot, r_lo, tk, d, lane);
}

// The forward's plan by head dim: a warp owns MT m16 row tiles (32 rows
// up to D=64, so that one ldmatrix of K or V feeds two products and the
// shared-memory reads per product halve; 16 rows at D=128, where two
// tiles' sums would not fit in the registers), four warps a block, the
// walked key tiles of Plan (64 keys, Q held in registers up to D=64).
template <int DP>
struct FwdPlan {
  static constexpr int kMT = DP <= 64 ? 2 : 1;
  static constexpr int kRows = 16 * kMT * kWarps;  // a block's queries
  static constexpr int kMinBlocks = 2;
};

// the forward's shared memory, in bytes: its own queries' tile and two
// buffers of the walked key tile's k and v
template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (FwdPlan<DP>::kRows + 4 * Plan<DP>::kTile) *
         Geo<DP>::LD;
}

// forward: a block owns FwdPlan's queries (16 MT a warp), holds their q as
// A operands and walks the key tiles of BK keys up to the causal limit,
// double-buffered: S = Q.K^T into the accumulators, the online softmax
// there (a lane holds rows r_lo and r_lo + 8 of each of its row tiles; a
// row's max and sum are reduced over the four lanes of its quad), p
// packed to bf16 as the A operand of O += P.V (V read through
// ldmatrix.trans): p never touches shared memory. l sums the unrounded
// f32 p.
template <int DP>
__global__ void __launch_bounds__(kThreadsTc, FwdPlan<DP>::kMinBlocks)
    flash_fwd_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const unsigned char* __restrict__ kmask,
                         bf16* __restrict__ o, float* __restrict__ lse,
                         int bh_n, int heads, int tq, int tk, int d,
                         int causal, float scale_log2) {
  constexpr int LD = Geo<DP>::LD;
  constexpr int BK = Plan<DP>::kTile;
  constexpr bool HOLD = Plan<DP>::kHold;
  constexpr int MT = FwdPlan<DP>::kMT;
  constexpr int ROWS = FwdPlan<DP>::kRows;
  constexpr int NF = BK / 8;
  static_assert(NF * 4 <= 32, "one validity bit a score of a row tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* k_s = q_s + ROWS * LD;                    // [2][BK][LD]
  bf16* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]

  const int n_qt = (tq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % bh_n;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_n)) * ROWS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t rb = (size_t)bh * tq;
  const bf16* kb = k + (size_t)bh * tk * d;
  const bf16* vb = v + (size_t)bh * tk * d;
  const unsigned char* km =
      kmask ? kmask + (size_t)(bh / heads) * tk : nullptr;

  // causal: keys past the block's last query are never visible
  const int k_end = causal ? min(tk, q0 + ROWS) : tk;
  const int n_kt = (k_end + BK - 1) / BK;
  stage_rows<DP, ROWS>(q_s, q + rb * d, q0, tq, d);
  if (n_kt > 0) {
    stage_rows<DP, BK>(k_s, kb, 0, tk, d);
    stage_rows<DP, BK>(v_s, vb, 0, tk, d);
  }
  dl4j_mma::cp_async_commit();

  // this lane's rows of row tile mt: r_lo + 16 mt and that + 8
  const int r_lo = q0 + 16 * MT * warp + (lane >> 2);
  float m[MT][2], l[MT][2];
  float tot[MT][Geo<DP>::NF][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = kNegInf;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < Geo<DP>::NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mt][n][e] = 0.f;
  }
  RowsA<DP, HOLD> qa[MT];

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_kt) {  // the next tile in flight over this one's work
      stage_rows<DP, BK>(k_s + ((j + 1) & 1) * BK * LD, kb, k0 + BK, tk, d);
      stage_rows<DP, BK>(v_s + ((j + 1) & 1) * BK * LD, vb, k0 + BK, tk, d);
    }
    dl4j_mma::cp_async_commit();
    dl4j_mma::cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        qa[mt].init(q_s, 16 * (MT * warp + mt), lane);
    }
    const bf16* kt = k_s + (j & 1) * BK * LD;
    const bf16* vt = v_s + (j & 1) * BK * LD;
    float s[MT][NF][4];
    dot_nt_rows<DP, BK, MT>(s, qa, kt, lane);

    // the online softmax step of each row tile, p into s; masks only
    // where they bite: the diagonal tiles, the ragged tail of the keys, a
    // key mask
    auto softmax = [&](auto masked_tag) {
      constexpr bool kMasked = decltype(masked_tag)::value;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = r_lo + 16 * mt;
        uint32_t valid = 0xffffffffu;
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = __fmul_rn(s[mt][n][e], scale_log2);
            if (kMasked) {
              const int row = r0 + 8 * (e >> 1);
              const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
              const bool ok = key < tk && (km == nullptr || km[key] != 0) &&
                              (!causal || key <= row);
              if (!ok) {  // before the exponential
                x = kNegInf;
                valid &= ~(1u << (n * 4 + e));
              }
            }
            s[mt][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          mx[h] = fmaxf(m[mt][h], mx[h]);  // the new running max
        }
#pragma unroll
        for (int n = 0; n < NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(__fsub_rn(s[mt][n][e], mx[e >> 1]));
            // explicit zeroing: in a fully masked row exp2(-1e30 - -1e30)
            // = 1
            if (kMasked && !((valid >> (n * 4 + e)) & 1u)) p = 0.f;
            s[mt][n][e] = p;
            sum[e >> 1] = __fadd_rn(sum[e >> 1], p);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 1));
          sum[h] = __fadd_rn(sum[h], __shfl_xor_sync(0xffffffffu, sum[h], 2));
          corr[h] = exp2f(__fsub_rn(m[mt][h], mx[h]));
          l[mt][h] = __fadd_rn(__fmul_rn(l[mt][h], corr[h]), sum[h]);
          m[mt][h] = mx[h];
        }
#pragma unroll
        for (int n = 0; n < Geo<DP>::NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[mt][n][e] = __fmul_rn(tot[mt][n][e], corr[e >> 1]);
      }
    };
    if (km != nullptr || k0 + BK > tk || (causal && k0 + BK - 1 > q0))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    uint32_t pa[MT][BK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      pack_a<BK>(pa[mt], s[mt]);  // p rounded to bf16 before P.V
    acc_nn_rows<DP, BK, MT>(tot, pa, vt, lane);
    __syncthreads();  // every warp is done with this buffer
  }
  dl4j_mma::cp_async_wait<0>();

  // o = acc / max(l, 1e-30); lse = m ln 2 + log(max(l, 1e-30))
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lc[h] = fmaxf(l[mt][h], 1e-30f);
      const int row = r_lo + 16 * mt + 8 * h;
      if ((lane & 3) == 0 && row < tq)
        lse[rb + row] = __fadd_rn(__fmul_rn(m[mt][h], kLn2), logf(lc[h]));
    }
#pragma unroll
    for (int n = 0; n < Geo<DP>::NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tot[mt][n][e] = __fdiv_rn(tot[mt][n][e], lc[e >> 1]);
    store_tot<DP>(o + rb * d, tot[mt], r_lo + 16 * mt, tq, d, lane);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int DP>
int launch_fwd_mma(const void* q, const void* k, const void* v,
                   const void* km, void* o, void* lse, int bh_n, int heads,
                   int tq, int tk, int d, int causal, float scale_log2,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<DP>;
  const size_t smem = fwd_smem<DP>();
  const int err = prepare(kernel, smem);
  if (err) return err;
  const int n_tiles = (tq + FwdPlan<DP>::kRows - 1) / FwdPlan<DP>::kRows;
  kernel<<<n_tiles * bh_n, kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(km),
      static_cast<bf16*>(o), static_cast<float*>(lse), bh_n, heads, tq, tk,
      d, causal, scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* km, const void* dout, const void* lse,
                  const void* delta, void* dq, int bh_n, int heads, int tq,
                  int tk, int d, int causal, float scale, float scale_log2,
                  cudaStream_t stream) {
  auto kernel = flash_bwd_dq_mma_kernel<DP>;
  const size_t smem = dq_smem<DP>();
  const int err = prepare(kernel, smem);
  if (err) return err;
  const int n_tiles = (tq + kOwn - 1) / kOwn;
  kernel<<<n_tiles * bh_n, kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(km),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), bh_n, heads,
      tq, tk, d, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* km, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, int bh_n,
                   int heads, int tq, int tk, int d, int causal, float scale,
                   float scale_log2, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_mma_kernel<DP>;
  const size_t smem = dkv_smem<DP>();
  const int err = prepare(kernel, smem);
  if (err) return err;
  const int n_tiles = (tk + kOwn - 1) / kOwn;
  kernel<<<n_tiles * bh_n, kThreadsTc, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const unsigned char*>(km),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), bh_n, heads, tq, tk, d, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

// what the tensor-core route takes: a head dim that is a multiple of 16
// up to 128, and 16-byte aligned q, k, v, dO and outputs (the wrapper's
// route choice and its checks say the same)
inline int refuse(int d, std::initializer_list<const void*> ptrs) {
  if (d <= 0 || d % 16 != 0 || d > 128) return (int)cudaErrorInvalidValue;
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  return 0;
}

int fwd(const void* q, const void* k, const void* v, const void* km,
        void* o, void* lse, int bh_n, int heads, int tq, int tk, int d,
        int causal, float scale_log2, void* stream) {
  if (const int err = refuse(d, {q, k, v, o})) return err;
  if (bh_n <= 0 || tq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_fwd_mma<32>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                              causal, scale_log2, s);
  if (d <= 64)
    return launch_fwd_mma<64>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                              causal, scale_log2, s);
  return launch_fwd_mma<128>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                             causal, scale_log2, s);
}

int dq(const void* q, const void* k, const void* v, const void* km,
       const void* dout, const void* lse, const void* delta, void* dq_out,
       int bh_n, int heads, int tq, int tk, int d, int causal, float scale,
       float scale_log2, void* stream) {
  if (const int err = refuse(d, {q, k, v, dout, dq_out})) return err;
  if (bh_n <= 0 || tq <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_dq_mma<32>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                             heads, tq, tk, d, causal, scale, scale_log2, s);
  if (d <= 64)
    return launch_dq_mma<64>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                             heads, tq, tk, d, causal, scale, scale_log2, s);
  return launch_dq_mma<128>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                            heads, tq, tk, d, causal, scale, scale_log2, s);
}

int dkv(const void* q, const void* k, const void* v, const void* km,
        const void* dout, const void* lse, const void* delta, void* dk,
        void* dv, int bh_n, int heads, int tq, int tk, int d, int causal,
        float scale, float scale_log2, void* stream) {
  if (const int err = refuse(d, {q, k, v, dout, dk, dv})) return err;
  if (bh_n <= 0 || tk <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_dkv_mma<32>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                              heads, tq, tk, d, causal, scale, scale_log2, s);
  if (d <= 64)
    return launch_dkv_mma<64>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                              heads, tq, tk, d, causal, scale, scale_log2, s);
  return launch_dkv_mma<128>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                             heads, tq, tk, d, causal, scale, scale_log2, s);
}

}  // namespace tc

}  // namespace

extern "C" {

int dl4j_flash_fwd_f32(const void* q, const void* k, const void* v,
                       const void* km, void* o, void* lse, int bh_n,
                       int heads, int tq, int tk, int d, int causal,
                       float scale_log2, void* stream) {
  return fwd<float>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d, causal,
                    scale_log2, stream);
}

int dl4j_flash_fwd_bf16(const void* q, const void* k, const void* v,
                        const void* km, void* o, void* lse, int bh_n,
                        int heads, int tq, int tk, int d, int causal,
                        float scale_log2, void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, km, o, lse, bh_n, heads, tq, tk, d,
                            causal, scale_log2, stream);
}

int dl4j_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                          const void* km, const void* dout, const void* lse,
                          const void* delta, void* dq_out, int bh_n,
                          int heads, int tq, int tk, int d, int causal,
                          float scale, float scale_log2, void* stream) {
  return dq<float>(q, k, v, km, dout, lse, delta, dq_out, bh_n, heads, tq, tk,
                   d, causal, scale, scale_log2, stream);
}

int dl4j_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                           const void* km, const void* dout, const void* lse,
                           const void* delta, void* dq_out, int bh_n,
                           int heads, int tq, int tk, int d, int causal,
                           float scale, float scale_log2, void* stream) {
  return dq<__nv_bfloat16>(q, k, v, km, dout, lse, delta, dq_out, bh_n,
                           heads, tq, tk, d, causal, scale, scale_log2,
                           stream);
}

int dl4j_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                           const void* km, const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh_n,
                           int heads, int tq, int tk, int d, int causal,
                           float scale, float scale_log2, void* stream) {
  return dkv<float>(q, k, v, km, dout, lse, delta, dk, dv, bh_n, heads, tq,
                    tk, d, causal, scale, scale_log2, stream);
}

int dl4j_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* km, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int bh_n,
                            int heads, int tq, int tk, int d, int causal,
                            float scale, float scale_log2, void* stream) {
  return dkv<__nv_bfloat16>(q, k, v, km, dout, lse, delta, dk, dv, bh_n,
                            heads, tq, tk, d, causal, scale, scale_log2,
                            stream);
}

// bf16 on the tensor cores: head dims that are multiples of 16 up to
// 128, 16-byte aligned tensors (else an error code, no launch)
int dl4j_flash_fwd_bf16_mma(const void* q, const void* k, const void* v,
                            const void* km, void* o, void* lse, int bh_n,
                            int heads, int tq, int tk, int d, int causal,
                            float scale_log2, void* stream) {
  return tc::fwd(q, k, v, km, o, lse, bh_n, heads, tq, tk, d, causal,
                 scale_log2, stream);
}

int dl4j_flash_bwd_dq_bf16_mma(const void* q, const void* k, const void* v,
                               const void* km, const void* dout,
                               const void* lse, const void* delta,
                               void* dq_out, int bh_n, int heads, int tq,
                               int tk, int d, int causal, float scale,
                               float scale_log2, void* stream) {
  return tc::dq(q, k, v, km, dout, lse, delta, dq_out, bh_n, heads, tq, tk,
                d, causal, scale, scale_log2, stream);
}

int dl4j_flash_bwd_dkv_bf16_mma(const void* q, const void* k, const void* v,
                                const void* km, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int bh_n, int heads, int tq,
                                int tk, int d, int causal, float scale,
                                float scale_log2, void* stream) {
  return tc::dkv(q, k, v, km, dout, lse, delta, dk, dv, bh_n, heads, tq, tk,
                 d, causal, scale, scale_log2, stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
