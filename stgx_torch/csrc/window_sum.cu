// Causal window-sum over time:  y[n,t,q] = sum_{j<K} x[n, t - j*s, q],
// frames before t = 0 read as zero; with reverse = 1 the anti-causal sum
// y[n,t,q] = sum_{j<K} x[n, t + j*s, q] (its vector-Jacobian product),
// frames past the end read as zero.
//
// Replaces stgx/ops/pallas_acc.py:_kernel (launched by _call, forward and
// reverse). The TPU kernel ran the sum as 128 x 128 block-Toeplitz products
// on the MXU and so reached at most 128 frames back; this one takes any
// (K - 1) * s.
//
// Bound on the H100: bytes. K <= 9 adds per element against one read and
// one write of the (N, L, V*C) activation; the floor is 2 * N*L*Q * itemsize
// bytes at 3.35 TB/s.
//
// Design: one block per (n, t) row; threads run over the contiguous
// Q = V*C axis, so every tap's load is coalesced. Each output sums its K
// taps in fp32 in the order j = 0, 1, ... and is written once in the input's
// type. The K - 1 re-reads of a row come from L1/L2, not device memory.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(stgx::kThreads)
    window_sum_kernel(const T* __restrict__ x, T* __restrict__ y, int L,
                      long long Q, int K, int stride, int reverse) {
  const long long nt = blockIdx.x;  // row (n, t) of the (N*L, Q) view
  const int t = (int)(nt % L);
  const long long row0 = nt - t;  // row of (n, 0)
  for (long long q = threadIdx.x; q < Q; q += stgx::kThreads) {
    float acc = 0.f;
    for (int j = 0; j < K; ++j) {
      const int tt = reverse ? t + j * stride : t - j * stride;
      if (tt < 0 || tt >= L) break;
      acc += stgx::to_f(x[(row0 + tt) * Q + q]);
    }
    y[nt * Q + q] = stgx::from_f<T>(acc);
  }
}

}  // namespace

// x, y (N, L, Q) contiguous, one type: dtype 0 = float32, 1 = bfloat16.
// Returns the CUDA error of the launch (0 on success).
extern "C" int stgx_window_sum(const void* x, void* y, long long N, int L,
                               long long Q, int K, int stride, int reverse,
                               int dtype, void* stream) {
  if (N <= 0 || L <= 0 || Q <= 0 || K < 1 || stride < 1 ||
      N * L > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(N * L);
  if (dtype == 0) {
    window_sum_kernel<float><<<grid, stgx::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), L, Q, K, stride,
        reverse);
  } else if (dtype == 1) {
    window_sum_kernel<__nv_bfloat16><<<grid, stgx::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        L, Q, K, stride, reverse);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
