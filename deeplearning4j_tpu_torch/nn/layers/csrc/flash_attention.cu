// Flash attention forward and recompute backward (dq; dk and dv), for
// Hopper (sm_90a). Layout [B, H, T, D], one (batch, head) row-major.
//
// Replaces the three TPU kernels of
// deeplearning4j_tpu/nn/layers/pallas_attention.py:
//   flash_fwd_kernel      <- `_fwd_kernel`     (pallas_call in `_flash_fwd`)
//   flash_bwd_dq_kernel   <- `_bwd_dq_kernel`  (pallas_call in `_run_bwd_kernels`)
//   flash_bwd_dkv_kernel  <- `_bwd_dkv_kernel` (pallas_call in `_run_bwd_kernels`)
// Each computes what its TPU kernel computes, with the same rounding
// points and masking:
//   - scores in base 2: s = (q . k) * (scale * log2 e), masked to the
//     finite -1e30 before the exponential, and the masked probabilities
//     zeroed explicitly afterwards, so a fully masked row (key mask of
//     length 0) gives o = 0 and finite, zero gradients;
//   - forward: online softmax (running max m, sum l, f32 accumulator),
//     p rounded to V's dtype before P.V, o = acc / max(l, 1e-30) rounded
//     to the input dtype, lse = m ln 2 + log(max(l, 1e-30)) in f32 with a
//     natural log;
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
// D=64, causal, bf16) the forward does ~2.75e11 matmul flops and 1.07e9
// exponentials over 134 MB of q, k, v and o: at the tensor cores' 989
// TFLOP/s the flops take ~0.28 ms, the exponentials about as long on the
// special-function units, the bytes ~0.04 ms. dq does 1.5x the forward's
// flops, dk/dv 2x. So all three are bounded by operations. This first
// version is the simple, right one: tiles of q/k/v/dO staged in shared
// memory as f32 (rows padded to an odd stride, so that a warp's reads
// are free of bank conflicts), and every dot product on the f32 CUDA
// cores, each thread owning a 4x4 (or 2x2) block of the score tile and a
// strip of the output tile in registers. Its ceiling is the f32 rate (67
// TFLOP/s), not the tensor cores'. mma.sync/wgmma tiles fed by TMA or
// cp.async double buffering are the later kernel's work.
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

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
