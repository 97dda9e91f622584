// Learnable per-channel temporal shift (Shift-GCN):
//   y[n,t,v,c] = (1 - a_c) * x[n, t*s + f_c, v, c] + a_c * x[n, t*s + f_c + 1, v, c]
// with s_c = clip(shift_c, -K, K), f_c = floor(s_c), a_c = s_c - f_c, frames
// outside [0, L) reading as zero, and ceil(L / s) output frames.
//
// Replaces stgx/ops/shift.py:_shift_kernel (launched by
// _temporal_shift_pallas_fwd_impl). The TPU kernel blended a static band of
// 2K + 2 = 18 taps, sum_k w_k(c) * x[t + k], over every input frame and
// dropped the frames the stride skips afterwards: a per-channel gather fights
// the TPU's lanes. Here each output is its two taps (two products, one add)
// and only the ceil(L / s) kept frames are formed.
//
// Bound on the H100: bytes. Each input frame feeds at most two outputs, so
// the least traffic is one read of x and one write of y: 2 flops an output
// against (L + ceil(L / s)) * itemsize bytes per (n, v, c) column.
//
// Design: one block per (n, v) column, 32-channel chunk and tile of output
// frames. Channels next to each other have different f_c, so a warp reading
// its taps straight from device memory would touch up to 18 frame rows at
// once. Instead the block stages the rows its tile needs, (tile - 1) * s +
// 2K + 2 frames by 32 channels, in shared memory: each row's 32 channels are
// contiguous in device memory, so the staging load coalesces, and frames
// outside [0, L) are stored as zeros without being read. Each lane owns one
// channel, computes f_c and a_c once, and reads its two taps from its own
// bank (slab row r, column lane), free of conflicts. At the Shift-GCN widths
// (L <= 50) one tile covers the whole sequence, so every x element is read
// from device memory once. The products and the add are rounded separately
// in fp32 (no contraction into an FMA), as the plain banded sum rounds them,
// and the result is rounded once to the output type.
#include "common.cuh"

namespace {

constexpr int kLanes = 32;                          // channels per block
constexpr int kRowsPar = stgx::kThreads / kLanes;   // frames handled at once
constexpr int kSlabRows = 160;                      // staged frames per block

template <typename T>
__global__ void __launch_bounds__(stgx::kThreads)
    temporal_shift_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                          T* __restrict__ y, int L, int Lo, int V, int C,
                          int stride, int K, int tile) {
  __shared__ float slab[kSlabRows * kLanes];
  const long long col = blockIdx.x;  // (n, v)
  const long long n = col / V;
  const int v = (int)(col - n * V);
  const int c0 = blockIdx.y * kLanes;
  const int t0 = blockIdx.z * tile;
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  const int c = c0 + lane;
  const int nt = stgx::imin(tile, Lo - t0);
  const int first = t0 * stride - K;  // input frame of slab row 0
  const int rows = (nt - 1) * stride + 2 * K + 2;

  for (int r = part; r < rows; r += kRowsPar) {
    const int t = first + r;
    float val = 0.f;
    if (t >= 0 && t < L && c < C)
      val = stgx::to_f(x[((n * L + t) * V + v) * C + c]);
    slab[r * kLanes + lane] = val;
  }
  // the shift in x's type, as the JAX op takes it; clip, floor and the
  // fraction are exact in fp32
  const float sc = c < C ? fminf(fmaxf(stgx::to_f(shift[c]), (float)-K), (float)K)
                         : 0.f;
  const float f = floorf(sc);
  const float a = sc - f;
  const float wa = 1.f - a;
  const int off = (int)f + K;  // slab row of output 0's first tap
  __syncthreads();
  if (c >= C) return;
  for (int to = part; to < nt; to += kRowsPar) {
    const int r = to * stride + off;
    const float p0 = __fmul_rn(wa, slab[r * kLanes + lane]);
    const float p1 = __fmul_rn(a, slab[(r + 1) * kLanes + lane]);
    y[((n * Lo + t0 + to) * V + v) * C + c] = stgx::from_f<T>(__fadd_rn(p0, p1));
  }
}

}  // namespace

// x (N, L, V, C), shift (C), y (N, ceil(L / stride), V, C), contiguous, one
// type: dtype 0 = float32, 1 = bfloat16. K is the clip of the shifts (the
// JAX op's max_shift). Returns the CUDA error of the launch (0 on success).
extern "C" int stgx_temporal_shift(const void* x, const void* shift, void* y,
                                   long long N, int L, int V, int C, int stride,
                                   int K, int dtype, void* stream) {
  if (N <= 0 || L <= 0 || V <= 0 || C <= 0 || stride < 1 || K < 0 ||
      2 * K + 2 > kSlabRows || N * V > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int Lo = (L + stride - 1) / stride;
  // output frames per block: as many as the slab holds with their halo
  const int tile = stgx::imin((kSlabRows - 2 * K - 2) / stride + 1, Lo);
  const dim3 grid((unsigned)(N * V), (unsigned)((C + kLanes - 1) / kLanes),
                  (unsigned)((Lo + tile - 1) / tile));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    temporal_shift_kernel<float><<<grid, stgx::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<float*>(y), L, Lo, V, C, stride, K, tile);
  } else if (dtype == 1) {
    temporal_shift_kernel<__nv_bfloat16><<<grid, stgx::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(shift),
        static_cast<__nv_bfloat16*>(y), L, Lo, V, C, stride, K, tile);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
