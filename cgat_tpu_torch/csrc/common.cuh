// Shared helpers of the port's CUDA kernels: the exported C interface and
// bf16/f32 vector loads and stores. Each kernel source is built into its own
// shared library (cgat_tpu_torch/ops/kernels/build.py) and called through
// ctypes, so every entry point is a plain C function that returns the
// cudaError_t of its launch.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CGAT_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

// human-readable text of an error code returned by an entry point
CGAT_EXPORT const char* cgat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// VEC consecutive elements as f32; VEC is 1 or 4 (4 needs 16-byte aligned
// f32 or 8-byte aligned bf16 addresses)
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const bf16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const float* v) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned int*>(&a);
    t.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}
