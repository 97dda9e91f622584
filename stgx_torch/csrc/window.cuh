// The window sums over time of the fused layer kernels (rt_fused.cu,
// rt_fused_bwd.cu): the causal sum of the graph conv's output z,
//   y[n,t] = sum_{j<K} z[n, t - j*s]           (frames before t = 0 are zero)
// and the anti-causal sum of the upstream gradient (frames past L are
// zero); with K = 1 it adds the backward's partial gx slices.
//
// One block a row (a frame of the flattened N * L), threads along the
// contiguous columns, four columns a thread in one 16- or 8-byte load; each
// output sums its taps in fp32 in the order j = 0, 1, ..., the order of
// window_sum.cu, so an fp32 input gives its bits; the rows a tap reads again
// come from L2 (on the H100 this ran faster than blocks that stage a tile
// of rows and its halo in shared memory).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace stgx {

// Where the lo part of a bf16 hi + lo pair of n-element arrays starts (16
// bytes aligned).
__host__ __device__ inline long long lo_offset(long long n) { return (n + 7) / 8 * 8; }

// Four consecutive values as floats, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
// What a bf16 store of v leaves out: v minus v rounded to bf16.
__device__ __forceinline__ float4 bf16_rest(float4 v) {
  auto rest = [](float a) { return a - __bfloat162float(__float2bfloat16(a)); };
  return make_float4(rest(v.x), rest(v.y), rest(v.z), rest(v.w));
}

// out[r, q] = sum_{j < taps} src(r - j*s, q) (REVERSE: r + j*s, frames past
// the sequence's end zero) for row r = blockIdx.x of the (R, Q) view,
// t = r % L; src(row, q) = sum_{k < groups} in[k * n + row * Q + q], n =
// R * Q, in fp32. The result is stored in TO: with out_lo set (TO = bf16)
// as hi + lo parts, a sum of bf16 values not being one bf16. vec: Q a
// multiple of 4 and every pointer aligned for four values a load.
template <typename TI, typename TO, bool REVERSE>
__global__ void __launch_bounds__(kThreads)
    window_row_kernel(const TI* __restrict__ in, int groups, TO* __restrict__ out,
                      TO* __restrict__ out_lo, int L, long long Q, long long n, int K,
                      int stride, bool vec) {
  const long long r = blockIdx.x;
  const int t = (int)(r % L);
  const int taps = imin(K, (REVERSE ? L - 1 - t : t) / stride + 1);
  const long long hop = (REVERSE ? (long long)stride : -(long long)stride) * Q;
  const TI* src = in + r * Q;
  if (vec) {
    for (long long q = threadIdx.x * 4LL; q < Q; q += kThreads * 4) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < taps; ++j)
        for (int k = 0; k < groups; ++k) {
          const float4 v = load4(src + k * n + j * hop + q);
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
      store4(out + r * Q + q, s);
      if constexpr (sizeof(TO) == 2) {
        if (out_lo != nullptr) store4(out_lo + r * Q + q, bf16_rest(s));
      }
    }
    return;
  }
  for (long long q = threadIdx.x; q < Q; q += kThreads) {
    float s = 0.f;
    for (int j = 0; j < taps; ++j)
      for (int k = 0; k < groups; ++k) s += to_f(src[k * n + j * hop + q]);
    const TO h = from_f<TO>(s);
    out[r * Q + q] = h;
    if constexpr (sizeof(TO) == 2) {
      if (out_lo != nullptr) out_lo[r * Q + q] = from_f<TO>(s - to_f(h));
    }
  }
}

template <typename TI, typename TO, bool REVERSE>
cudaError_t window_rows(const TI* in, int groups, TO* out, TO* out_lo, long long R, int L,
                        long long Q, int K, int stride, cudaStream_t stream) {
  auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool vec = Q % 4 == 0 && aligned(in, 4 * sizeof(TI)) && aligned(out, 4 * sizeof(TO)) &&
                   (out_lo == nullptr || aligned(out_lo, 4 * sizeof(TO)));
  window_row_kernel<TI, TO, REVERSE><<<(unsigned)R, kThreads, 0, stream>>>(
      in, groups, out, out_lo, L, Q, R * Q, K, stride, vec);
  return cudaGetLastError();
}

}  // namespace stgx
