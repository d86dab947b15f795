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
// pads the activated image (a tap outside it adds 0) and reads the
// weight tap-major, [9, C, K] with t = kh * 3 + kw.
//
// Translation. The TPU kernel holds one whole image and the whole weight
// in VMEM per grid step and carries the channel sums across the
// sequential grid. Here the batch, height and width fold into the GEMM's
// M = N Ho Wo rows and the 3x3's nine taps into its reduction (9C), so a
// block owns a 128-pixel x 64-channel output tile of any image; the sums
// go through per-block partials and a second, fixed-order pass
// (conv_gemm.cuh).
//
// What bounds it on an H100. At ResNet50's shapes the forward convs of a
// bottleneck are bound by bytes in bf16 at B=128: the s2 conv_c (64 ->
// 256 channels at 56x56) reads 51 MB and writes 206 MB for 13 GFLOP, so
// 3.35 TB/s gives 0.077 ms and 989 TFLOP/s 0.013 ms; the 3x3 convs at
// 512 channels are nearer the line. This first version is the simple,
// right one: every product on the f32 CUDA cores (67 TFLOP/s), A tiles
// gathered element by element through the prologue; its ceiling is the
// f32 rate, not the bytes. Tensor-core tiles (mma.sync, then wgmma) fed
// by cp.async or TMA, with the prologue applied in registers, are a later
// kernel's work.
//
// Built with route (b): nvcc -gencode arch=compute_90a,code=sm_90a into a
// shared library with a plain C interface, loaded through ctypes
// (deeplearning4j_tpu_torch/cuda_library.py). Every entry point launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include "conv_gemm.cuh"

namespace {

using dl4j_conv::Geometry;

template <typename T>
int conv1x1(const void* x, const void* sc, const void* bb, const void* w,
            void* out, void* part1, void* part2, void* s1, void* s2, int n,
            int h, int wd, int c, int k, int stride, int relu, int tiles,
            void* stream) {
  Geometry g{n, h, wd, c, h / stride, wd / stride, k, stride, c, relu,
             tiles};
  return dl4j_conv::launch<T, dl4j_conv::kConv1x1>(
      x, sc, bb, w, out, part1, part2, s1, s2, g, stream);
}

template <typename T>
int conv3x3(const void* x, const void* sc, const void* bb, const void* w,
            void* out, void* part1, void* part2, void* s1, void* s2, int n,
            int h, int wd, int c, int k, int relu, int tiles, void* stream) {
  Geometry g{n, h, wd, c, h, wd, k, 1, 9 * c, relu, tiles};
  return dl4j_conv::launch<T, dl4j_conv::kConv3x3>(
      x, sc, bb, w, out, part1, part2, s1, s2, g, stream);
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

int dl4j_conv_row_tile() { return dl4j_conv::kBM; }

const char* dl4j_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
