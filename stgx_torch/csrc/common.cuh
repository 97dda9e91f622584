// Shared pieces of the port's kernels: the block size, the limits of the
// graph-conv kernels, type conversion and small integer helpers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stgx {

constexpr int kThreads = 256;  // threads per block, all kernels
constexpr int kMaxV = 32;      // joints the graph-conv kernels take
constexpr int kMaxP = 4;       // partitions the graph-conv kernels take
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

}  // namespace stgx
