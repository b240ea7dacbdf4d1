// Device helpers shared by the port's CUDA sources (included, not built
// on its own; kernels/_build.py hashes it into every source's build key).
#pragma once

#include <cuda_bf16.h>

namespace repro_torch {

// Floored modulo, as jnp `%`: C++ `%` truncates toward zero.  m >= 1.
__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// float32 / bfloat16 loads and stores through float.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro_torch
