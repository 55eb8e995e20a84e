// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library exposes a plain C interface (loaded with ctypes): its
// launch functions take device pointers, sizes and the caller's CUDA stream,
// launch on that stream without synchronising, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DMN_EXPORT extern "C" __attribute__((visibility("default")))

// Every library can name its error codes for the wrapper's message.
#define DMN_DEFINE_ERROR_STRING(prefix)                      \
  DMN_EXPORT const char* prefix##_error_string(int code) {   \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }

namespace dmn {

// Round an f32 value to bf16 and back: the seams where the JAX kernels cast
// an intermediate to the compute dtype.
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum of (a, b) over the whole block; every thread gets the result.
// `scratch` holds at least 2 * 32 floats. blockDim.x is a multiple of 32.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) {
    scratch[warp] = a;
    scratch[32 + warp] = b;
  }
  __syncthreads();
  float ra = 0.f, rb = 0.f;
  for (int w = 0; w < nwarps; ++w) {  // fixed order: deterministic
    ra += scratch[w];
    rb += scratch[32 + w];
  }
  return make_float2(ra, rb);
}

// One-pass GroupNorm statistics as flax computes them: E[x^2] - E[x]^2,
// clipped at zero, eps inside the rsqrt. Returns (mean, rstd).
__device__ __forceinline__ float2 fast_variance_stats(float sum, float sumsq,
                                                      float count, float eps) {
  const float mean = sum / count;
  const float var = fmaxf(sumsq / count - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dmn
