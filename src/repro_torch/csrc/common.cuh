// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/_build._DTYPE_CODES); int8 and
// fp8 (e4m3) are quantized payloads, always with f32 scales beside them:
// GEMM operands with per-row / per-column scales, KV pages with scale pages
enum ReproDType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kF8 = 3 };

// activation codes (kernels/mx_matmul.ACT_CODES)
enum ReproAct : int { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kSwiglu = 4 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Epilogue operands whose dtype is chosen at run time (bias, residual,
// output): one uniform branch per element.
__device__ __forceinline__ float load_dt(const void* p, int dt, int64_t i) {
  return dt == kBF16
             ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
             : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_dt(void* p, int dt, int64_t i, float v) {
  if (dt == kBF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

// jax.nn.silu / jax.nn.gelu (approximate=True, the tanh form) / relu
__device__ __forceinline__ float silu_f(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * x * (1.0f + tanhf(k0 * (x + k1 * x * x * x)));
}

__device__ __forceinline__ float activation_f(float x, int act) {
  switch (act) {
    case kRelu: return fmaxf(x, 0.0f);
    case kGelu: return gelu_tanh_f(x);
    case kSilu: return silu_f(x);
    default: return x;
  }
}

#define REPRO_EXPORT_ERROR_STRING                                   \
  extern "C" const char* repro_cuda_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err));       \
  }
