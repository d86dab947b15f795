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
// (2 for bf16), plus the queries and the table. The design reads each
// live K/V byte exactly once: one thread block per (slot, kv head)
// walks only the ceil(length / page_size) live pages of its row (dead
// table entries, which point at the null page 0, are never touched),
// stages one K page and one V page at a time in shared memory with
// coalesced loads (neighbouring threads read neighbouring elements;
// a page of one head is contiguous), and keeps the query rows, the
// running max/sum and the f32 accumulator in shared memory for the
// whole walk, so nothing but the output goes back to device memory.
// Making it reach the bandwidth bound (split-K over pages across
// blocks, cp.async/TMA double buffering, tensor-core dots for wide
// GQA groups) is later work.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into
// a shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

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

// One thread block per (slot, kv head). Shared memory, all f32:
//   q_s [rw, d]   the block's query rows
//   k_s [ps, d]   the current K page
//   v_s [ps, d]   the current V page
//   p_s [rw, ps]  scores, then probabilities (rounded to T)
//   acc [rw, d]   the unnormalised output
//   m_s, l_s, c_s [rw]  running max, running sum, this page's rescale
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int hkv, int rw, int d, int ps, int n_max,
                        int n_pages, int qw, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + rw * d;
  float* v_s = k_s + ps * d;
  float* p_s = v_s + ps * d;
  float* acc = p_s + rw * ps;
  float* m_s = acc + rw * d;
  float* l_s = m_s + rw;
  float* c_s = l_s + rw;

  const int s = blockIdx.x / hkv;
  const int h = blockIdx.x % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int length = lengths[s];
  const size_t q_off = ((size_t)s * hkv + h) * rw * d;

  for (int i = tid; i < rw * d; i += blockDim.x) {
    q_s[i] = to_f32(q[q_off + i]);
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
    // the block loads its own table entry (the TPU kernel's scalar
    // prefetch); every thread reads the same value, so the branch on
    // it is uniform across the block
    const int page = table[(size_t)s * n_max + b];
    if (page < 0 || page >= n_pages) {
      bad_page = true;
      break;
    }
    const size_t base = ((size_t)page * hkv + h) * ps * d;
    for (int i = tid; i < ps * d; i += blockDim.x) {
      k_s[i] = to_f32(k_pool[base + i]);
      v_s[i] = to_f32(v_pool[base + i]);
    }
    __syncthreads();

    // scores: one warp per (row, key), lanes across the head dim
    for (int pair = warp; pair < rw * ps; pair += n_warps) {
      const int r = pair / ps;
      const int j = pair - r * ps;
      float dot = 0.f;
      for (int c = lane; c < d; c += 32) dot += q_s[r * d + c] * k_s[j * d + c];
      dot = warp_sum(dot);
      if (lane == 0) {
        const bool valid = b * ps + j <= length - qw + r % qw;
        p_s[pair] = valid ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int r = warp; r < rw; r += n_warps) {
      float bmax = kNegInf;
      for (int j = lane; j < ps; j += 32) bmax = fmaxf(bmax, p_s[r * ps + j]);
      bmax = warp_max(bmax);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, bmax);
      const int last = length - qw + r % qw;
      float psum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        // explicit zeroing: a row whose whole page is masked would see
        // exp(-1e30 - -1e30) = 1
        const float p = b * ps + j <= last ? expf(p_s[r * ps + j] - m_new) : 0.f;
        psum += p;
        p_s[r * ps + j] = to_f32(from_f32<T>(p));
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
      for (int j = 0; j < ps; ++j) pv += p_s[r * ps + j] * v_s[j * d + c];
      acc[i] = acc[i] * c_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < rw * d; i += blockDim.x) {
    // a table entry outside the pool poisons the (slot, head) with NaN
    // instead of reading past the pool
    const float o = bad_page ? NAN : acc[i] / fmaxf(l_s[i / d], 1e-30f);
    out[q_off + i] = from_f32<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lengths, void* out, int slots,
           int hkv, int rw, int d, int ps, int n_max, int n_pages, int qw,
           float scale, void* stream) {
  if (slots <= 0 || hkv <= 0) return (int)cudaGetLastError();
  const size_t smem =
      sizeof(float) * ((size_t)2 * rw * d + (size_t)2 * ps * d +
                       (size_t)rw * ps + (size_t)3 * rw);
  if (smem > (size_t)kMaxDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<slots * hkv, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), hkv, rw, d, ps,
      n_max, n_pages, qw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dl4j_paged_attention_f32(const void* q, const void* k_pool,
                             const void* v_pool, const void* table,
                             const void* lengths, void* out, int slots,
                             int hkv, int rw, int d, int ps, int n_max,
                             int n_pages, int qw, float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, table, lengths, out, slots, hkv, rw,
                       d, ps, n_max, n_pages, qw, scale, stream);
}

int dl4j_paged_attention_bf16(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* lengths, void* out, int slots,
                              int hkv, int rw, int d, int ps, int n_max,
                              int n_pages, int qw, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, slots,
                               hkv, rw, d, ps, n_max, n_pages, qw, scale,
                               stream);
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
