// Element access shared by the port's kernels: an f32 or bf16 tensor element
// loaded and stored as f32, and an f32 value rounded to the element type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace typed_io {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v rounded to the element type T, held in f32.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace typed_io
