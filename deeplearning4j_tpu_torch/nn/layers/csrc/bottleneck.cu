// The fused ResNet bottleneck's forward convolutions, for Hopper
// (sm_90a): the 1x1 conv (stride 1 or 2) and the 3x3 same-pad conv, each
// with the BN-affine (+ relu) prologue of its input and the per-channel
// sum / sum-of-squares epilogue of its output.
//
// Replaces the TPU kernels of deeplearning4j_tpu/nn/layers/bottleneck.py:
//   conv1x1 <- `_fwd1x1_kernel` (pallas_call in `_fwd_conv_stats`)
//   conv3x3 <- `_fwd3x3_kernel` (pallas_call in `_fwd_conv_stats`)
// Each computes what its TPU kernel computes: o = act(x[::s, ::s] sc +
// bb) rounded to w's dtype, times w, accumulated in f32, rounded to x's
// dtype and stored; sum o and sum o^2 over the stored values. The 3x3
// pads the activated image (a tap outside it adds 0, not act(bb)) and
// reads the weight tap-major, [9, C, K] with t = kh * 3 + kw.
//
// Translation. The TPU kernel holds one whole image and the whole weight
// in VMEM per grid step and carries the channel sums across the
// sequential grid. Here the batch, height and width fold into the GEMM's
// M = N Ho Wo rows and the 3x3's nine taps into its reduction (9C); a
// block owns a tile of output pixels of any image, and the sums go
// through per-block partials and conv_gemm.cuh's fixed-order second pass
// (f64): the same sums on every run, no atomics.
//
// What bounds it on an H100 (bf16, ResNet50 at B=128): the 1x1s their
// stores (the s2 conv_c: 51 MB read, 206 MB written, 0.077 ms at 3.35
// TB/s against 13 GFLOP, 0.013 ms at 989 TFLOP/s); the 3x3s bytes and
// products near even (the s2 3x3: 0.031 ms of bytes, 0.030 ms of
// products; every 3x3 of the net is the same 29.6 GFLOP, the s5 3x3 (512
// channels at 7x7) has a reduction of 4,608).
//
// bf16, the main path's dtype, runs on the tensor cores: fwd_tc_kernel
// with the sums epilogue (kSums), in conv_fwd_tc.cuh, which the fused
// bn -> act -> 1x1 forward (fused.cu) shares with the bias epilogue. That
// header says how the design meets the bound (a persistent grid whose
// copy ring runs on between pixel blocks, mma.sync tiles fed by ldmatrix,
// round-toward-zero fragments promoted round-to-nearest) and what still
// holds it back (each block's copy, conversion, products and stores one
// after another at one or two blocks an SM; mma.sync's rate below
// wgmma's). This file adds the sums' fixed-order reduction and the
// launchers' checks: a `tiles` short of the grid's block rows, or a
// tensor of 2^31 - 1 elements or more, is refused before any launch.
// The f32 instantiations stay exact f32 (no TF32) on conv_gemm.cuh's
// CUDA-core tiles (128 x 64 output tiles, 16-deep steps); the
// whole-network f32 references hold the fused plan to them.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "conv_fwd_tc.cuh"
#include "conv_gemm.cuh"

#include <climits>
#include <type_traits>

namespace {

using dl4j_conv::Geometry;
using dl4j_fwd::Fwd;
using dl4j_fwd::fwd_geometry;
using dl4j_fwd::fwd_slots;
using dl4j_mma::aligned16;

// One bf16 conv on the tensor cores and its sums' fixed-order reduction.
// `tiles` must cover the grid's block rows (fwd_slots), and no tensor
// may hold 2^31 - 1 elements or more (the kernel indexes with ints):
// cudaErrorInvalidValue, before any launch, otherwise.
template <int TAPS>
int conv_tc(const void* x, const void* sc, const void* bb, const void* w,
            void* out, void* part1, void* part2, void* s1, void* s2, int n,
            int h, int wd, int c, int k, int stride, int relu, int tiles,
            void* stream) {
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if ((stride != 1 && stride != 2) || (TAPS == 9 && stride != 1) ||
      static_cast<int64_t>(n) * h * wd * c >= INT_MAX ||
      static_cast<int64_t>(n) * (h / stride) * (wd / stride) * k >=
          INT_MAX ||
      static_cast<int64_t>(TAPS) * c * k >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = c % 8 == 0 && k % 8 == 0 && aligned16(x) &&
                  aligned16(w) && aligned16(out);
  Fwd s = fwd_geometry<TAPS>(n, h, wd, c, k, stride, relu, vec, tiles);
  if (s.tile.patches == 0 || k == 0)
    return static_cast<int>(cudaGetLastError());
  s.slots = fwd_slots(s.tile.patches, k, sms);
  if (s.slots > tiles) return static_cast<int>(cudaErrorInvalidValue);
  const int err = dl4j_fwd::launch_fwd_for<TAPS, dl4j_fwd::kSums>(
      x, sc, bb, w, nullptr, out, part1, part2, s, cs);
  if (err) return err;
  dl4j_conv::reduce_partials_kernel<<<k, dl4j_conv::kReduceThreads, 0,
                                      cs>>>(
      static_cast<const float*>(part1), static_cast<const float*>(part2),
      s.slots, tiles, static_cast<float*>(s1), static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

// f32 on the CUDA cores, bf16 on the tensor cores.
template <typename T>
int conv1x1(const void* x, const void* sc, const void* bb, const void* w,
            void* out, void* part1, void* part2, void* s1, void* s2, int n,
            int h, int wd, int c, int k, int stride, int relu, int tiles,
            void* stream) {
  if constexpr (std::is_same<T, float>::value) {
    Geometry g{n, h, wd, c, h / stride, wd / stride, k, stride, c, relu,
               tiles};
    return dl4j_conv::launch<T, dl4j_conv::kConv1x1>(
        x, sc, bb, w, out, part1, part2, s1, s2, g, stream);
  } else {
    return conv_tc<1>(x, sc, bb, w, out, part1, part2, s1, s2, n, h, wd, c,
                      k, stride, relu, tiles, stream);
  }
}

template <typename T>
int conv3x3(const void* x, const void* sc, const void* bb, const void* w,
            void* out, void* part1, void* part2, void* s1, void* s2, int n,
            int h, int wd, int c, int k, int relu, int tiles, void* stream) {
  if constexpr (std::is_same<T, float>::value) {
    Geometry g{n, h, wd, c, h, wd, k, 1, 9 * c, relu, tiles};
    return dl4j_conv::launch<T, dl4j_conv::kConv3x3>(
        x, sc, bb, w, out, part1, part2, s1, s2, g, stream);
  } else {
    return conv_tc<9>(x, sc, bb, w, out, part1, part2, s1, s2, n, h, wd, c,
                      k, 1, relu, tiles, stream);
  }
}

}  // namespace

extern "C" {

int dl4j_conv1x1_f32(const void* x, const void* sc, const void* bb,
                     const void* w, void* out, void* part1, void* part2,
                     void* s1, void* s2, int n, int h, int wd, int c, int k,
                     int stride, int relu, int tiles, void* stream) {
  return conv1x1<float>(x, sc, bb, w, out, part1, part2, s1, s2, n, h, wd,
                        c, k, stride, relu, tiles, stream);
}

int dl4j_conv1x1_bf16(const void* x, const void* sc, const void* bb,
                      const void* w, void* out, void* part1, void* part2,
                      void* s1, void* s2, int n, int h, int wd, int c, int k,
                      int stride, int relu, int tiles, void* stream) {
  return conv1x1<__nv_bfloat16>(x, sc, bb, w, out, part1, part2, s1, s2, n,
                                h, wd, c, k, stride, relu, tiles, stream);
}

int dl4j_conv3x3_f32(const void* x, const void* sc, const void* bb,
                     const void* w, void* out, void* part1, void* part2,
                     void* s1, void* s2, int n, int h, int wd, int c, int k,
                     int relu, int tiles, void* stream) {
  return conv3x3<float>(x, sc, bb, w, out, part1, part2, s1, s2, n, h, wd,
                        c, k, relu, tiles, stream);
}

int dl4j_conv3x3_bf16(const void* x, const void* sc, const void* bb,
                      const void* w, void* out, void* part1, void* part2,
                      void* s1, void* s2, int n, int h, int wd, int c, int k,
                      int relu, int tiles, void* stream) {
  return conv3x3<__nv_bfloat16>(x, sc, bb, w, out, part1, part2, s1, s2, n,
                                h, wd, c, k, relu, tiles, stream);
}

// The f32 kernels' output rows per block: their partials' tiles.
int dl4j_conv_row_tile() { return dl4j_conv::kBM; }

// Bytes of dynamic shared memory a bf16 conv (taps 1 or 9) launches with.
int dl4j_conv_tc_smem(int n, int h, int wd, int k, int stride, int taps) {
  return static_cast<int>(
      dl4j_fwd::fwd_smem_for(n, h, wd, k, stride, taps));
}

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
