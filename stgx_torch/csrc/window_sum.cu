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
// Bound on the H100: bytes at Gamma = 9 (K <= 9 adds an element against one
// read and one write of the (N, L, V*C) activation, 2 * N*L*Q * itemsize
// bytes at 3.35 TB/s); at Gamma = 69 the K = 69 (34) fp32 adds an output
// at 33.5e12 a second come close to the bytes in fp32 and bind in bf16.
//
// Design: the window pass of window.cuh (window_pass). A block stages a
// chunk of frames and its halo for a 32-column tile in shared memory with
// cp.async, each frame read from device memory once; a thread keeps 8
// accumulators and walks its frames from the newest to the oldest, adding
// each to every output whose window holds it. Each output sums its K taps
// in fp32 in the order j = 0, 1, ... and is written once in the input's
// type: the bits of the plain version. The kernel it replaced read every tap
// from L2, K loads an output, one block a frame.
#include "window.cuh"

// x, y (N, L, Q) contiguous, one type: dtype 0 = float32, 1 = bfloat16.
// chunk: outputs a block takes (ops/window_sum.py::window_plan). Returns the
// CUDA error of the launch (0 on success).
extern "C" int stgx_window_sum(const void* x, void* y, long long N, int L, long long Q, int K,
                               int stride, int reverse, int dtype, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)stgx::window_pass<float, float>(static_cast<const float*>(x), 1,
                                                static_cast<float*>(y), nullptr, N, L, Q, K,
                                                stride, reverse != 0, chunk, s);
  if (dtype == 1)
    return (int)stgx::window_pass<__nv_bfloat16, __nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), 1, static_cast<__nv_bfloat16*>(y), nullptr, N, L, Q,
        K, stride, reverse != 0, chunk, s);
  return (int)cudaErrorInvalidValue;
}
