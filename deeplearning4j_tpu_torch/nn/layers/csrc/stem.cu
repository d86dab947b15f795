// The fused ResNet stem's forward, for Hopper (sm_90a): the 7x7/2 conv
// as one GEMM over the space-to-depth im2col, with the per-channel sum /
// sum-of-squares epilogue, and the output stage (BN affine, relu, 3x3/2
// pad-1 max pool) in one read of the conv output.
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/stem.py:
//   stem_conv <- `_stem_conv_kernel` (pallas_call in `_conv_stats`)
//   stem_pool <- `_stem_pool_kernel` (pallas_call in `_pool`)
// stem_conv computes y = s2d-im2col(x) rounded to w's dtype, times the
// [64C, K] contraction matrix of `stem_weight_s2d`, accumulated in f32,
// rounded to x's dtype; sum y and sum y^2 over the stored values.
// stem_pool computes max over the 3x3/2 window (padding -inf, after the
// relu) of relu(y sc + bb) in f32, stored in y's dtype.
//
// Translation. The TPU kernel materializes each image's padded
// space-to-depth grid and its [ho wo, 64C] im2col in VMEM. Here the
// im2col is built on the fly from the raw NHWC image while the GEMM's A
// tiles are gathered (conv_gemm.cuh, mode kStemS2d): no s2d tensor or
// im2col reaches device memory, and pixels of the padding read 0. The
// pool is one thread per output element (channels fastest, so a warp's
// reads of y are contiguous).
//
// What bounds it on an H100. At B=128, 224x224x3, K=64 in bf16 the conv
// reads 38.5 MB and writes 206 MB for 30.2 GFLOP (39.5 with the
// zero-weighted taps of the 8x8-extended kernel, which the TPU kernel and
// this one compute): 0.073 ms of bytes against at most 0.040 ms of
// tensor-core flops, so bytes; the
// pool reads those 206 MB and writes 51 MB, 0.077 ms. This first version
// runs the conv's products on the f32 CUDA cores (the gather from a
// 3-channel image is scattered, 16 reduction entries per tile step), so
// the f32 rate bounds it; the pool reads each y element up to four times
// through the L1/L2 caches.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cmath>

#include "conv_gemm.cuh"

namespace {

using dl4j_conv::Geometry;
using dl4j_conv::from_f32;
using dl4j_conv::to_f32;

constexpr int kPoolThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
    stem_pool_kernel(const T* __restrict__ y, const float* __restrict__ sc,
                     const float* __restrict__ bb, T* __restrict__ out,
                     int n, int ho, int wo, int k, int po, int pw) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kPoolThreads + threadIdx.x;
  const int64_t total = static_cast<int64_t>(n) * po * pw * k;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % k);
  int64_t rest = idx / k;
  const int q = static_cast<int>(rest % pw);
  rest /= pw;
  const int p = static_cast<int>(rest % po);
  const int img = static_cast<int>(rest / po);
  const float s = sc[ch];
  const float b = bb[ch];
  float m = -INFINITY;
  for (int i = 0; i < 3; ++i) {
    const int r = 2 * p - 1 + i;
    if (r < 0 || r >= ho) continue;
    for (int j = 0; j < 3; ++j) {
      const int cc = 2 * q - 1 + j;
      if (cc < 0 || cc >= wo) continue;
      const int64_t off =
          ((static_cast<int64_t>(img) * ho + r) * wo + cc) * k + ch;
      const float z = fmaxf(__fadd_rn(__fmul_rn(to_f32(y[off]), s), b), 0.f);
      m = fmaxf(m, z);
    }
  }
  out[idx] = from_f32<T>(m);
}

template <typename T>
int stem_conv(const void* x, const void* w, void* out, void* part1,
              void* part2, void* s1, void* s2, int n, int h, int wd, int c,
              int k, int tiles, void* stream) {
  Geometry g{n, h, wd, c, (h - 1) / 2 + 1, (wd - 1) / 2 + 1, k, 2, 64 * c,
             0, tiles};
  return dl4j_conv::launch<T, dl4j_conv::kStemS2d>(
      x, nullptr, nullptr, w, out, part1, part2, s1, s2, g, stream);
}

template <typename T>
int stem_pool(const void* y, const void* sc, const void* bb, void* out,
              int n, int ho, int wo, int k, void* stream) {
  const int po = (ho - 1) / 2 + 1;
  const int pw = (wo - 1) / 2 + 1;
  const int64_t total = static_cast<int64_t>(n) * po * pw * k;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int blocks =
      static_cast<int>((total + kPoolThreads - 1) / kPoolThreads);
  stem_pool_kernel<T><<<blocks, kPoolThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const float*>(sc),
      static_cast<const float*>(bb), static_cast<T*>(out), n, ho, wo, k, po,
      pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dl4j_stem_conv_f32(const void* x, const void* w, void* out, void* part1,
                       void* part2, void* s1, void* s2, int n, int h, int wd,
                       int c, int k, int tiles, void* stream) {
  return stem_conv<float>(x, w, out, part1, part2, s1, s2, n, h, wd, c, k,
                          tiles, stream);
}

int dl4j_stem_conv_bf16(const void* x, const void* w, void* out,
                        void* part1, void* part2, void* s1, void* s2, int n,
                        int h, int wd, int c, int k, int tiles,
                        void* stream) {
  return stem_conv<__nv_bfloat16>(x, w, out, part1, part2, s1, s2, n, h, wd,
                                  c, k, tiles, stream);
}

int dl4j_stem_pool_f32(const void* y, const void* sc, const void* bb,
                       void* out, int n, int ho, int wo, int k,
                       void* stream) {
  return stem_pool<float>(y, sc, bb, out, n, ho, wo, k, stream);
}

int dl4j_stem_pool_bf16(const void* y, const void* sc, const void* bb,
                        void* out, int n, int ho, int wo, int k,
                        void* stream) {
  return stem_pool<__nv_bfloat16>(y, sc, bb, out, n, ho, wo, k, stream);
}

int dl4j_conv_row_tile() { return dl4j_conv::kBM; }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
