// The NaN-propagating maximum, minimum and relu of the convolution and
// pooling kernels on Hopper (sm_90a).
//
// fmaxf and __hmax2 return the other operand where one is NaN, so a
// relu written as fmaxf(z, 0.f) turns a NaN into 0 and a window maximum
// skips a NaN element. The JAX kernels these replace take jnp.maximum,
// and the plain versions torch.clamp_min / torch.maximum: both return
// NaN. These take PTX max.NaN / min.NaN (one instruction, no branch):
// NaN (the canonical one) where an operand is NaN, and otherwise the
// same value as fmaxf / fminf / __hmax2, with +0 ordered above -0 as
// max orders it, so on finite data every kernel's output is bit for bit
// what it was with fmaxf.
//
// Used by conv_gemm.cuh and conv_mma.cuh (the prologue relu of the
// bottleneck forward and backward, the fused forward), stem.cu (the
// forward pool's window extremes) and stem_bwd.cu (the pool backward's
// relu and window maxima).

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace dl4j_nan {

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// relu(z) = max(z, 0), NaN where z is NaN
__device__ __forceinline__ float relu_nan(float z) { return max_nan(z, 0.f); }

// the maximum of two bf16 pairs held in 32-bit words (__hmax2_nan)
__device__ __forceinline__ uint32_t hmax2_nan_bits(uint32_t a, uint32_t b) {
  const __nv_bfloat162 m =
      __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                  *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&m);
}

}  // namespace dl4j_nan
