// The window pass: the causal window sum over time of window_sum.cu,
//   y[n,t,q] = sum_{j<K} x[n, t - j*s, q]      (frames before t = 0 zero)
// or the anti-causal one (frames past L - 1 zero), and the fused layer
// kernels' sums: rt_fused.cu's of the graph conv's output z, rt_fused_bwd.cu's
// of the upstream gradient and, with K = 1, of its partial gx slices.
//
// Each output sums its taps in fp32 in the order j = 0, 1, ..., K - 1,
// starting from its first tap, and is rounded once to the output type (with
// out_lo, a bf16 output: also the rest out - bf16(out), rounded to bf16, a
// sum of bf16 values not being one bf16): the bits of window_sum_plain.
//
// Bound on the H100: bytes at Gamma = 9 (one read of the input, one write
// of the output); at Gamma = 69 the K - 1 fp32 adds an output come close to
// the bytes in fp32 and bind in bf16.
//
// Design. A block takes a tile of kWinCols columns and a chunk of `chunk`
// consecutive outputs of one sequence (the plan, chosen on the host:
// ops/window_sum.py::window_plan). It stages the chunk's frames and its halo
// of (K - 1) * s frames before it (after it in reverse) in shared memory, in
// the input's type, each frame of the tile read from device memory once:
// cp.async copies of 16 (fp32) or 8 (bf16) bytes a thread, all in flight at
// once, frames outside [0, L) zero-filled; bf16 rows are padded by 8 bytes so
// that two rows a half-warp reads fall in different banks. A thread owns
// four columns (one column on the scalar route) and, in turn, groups of
// kWinR outputs t, t + s, ..., t + (kWinR - 1) * s of one residue class, one
// accumulator each in registers. It walks the group's kWinR + K - 1 frames
// from the newest to the oldest (oldest to newest in reverse) and adds each
// frame to every accumulator whose window holds it: every output still takes
// its taps in the order j = 0, 1, ..., and each staged frame is read
// (K - 1) / kWinR + 1 times from shared memory, not K times from L2. A halo
// too long for shared memory leaves the tile unstaged and the walk reads
// device memory (through L1) instead: no limit on (K - 1) * s.
//
// Measured on the H100 (PERF.md): staging through registers left the
// Gamma = 69 walk idle while its loads were in flight; 16 accumulators a
// thread (128 registers, two blocks an SM) and chunks long enough that the
// halo is a tenth of them lost to 8 accumulators and 256-output chunks, with
// four blocks an SM and the halo's second read served by L2.
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
// ------------------------------------------------------------ window pass

constexpr int kWinCols = 32;  // columns a block takes
constexpr int kWinR = 8;      // outputs a thread sums at once

// Elements from one staged row to the next: 128 bytes of fp32, 64 of bf16
// and 8 of padding.
template <typename T>
__host__ __device__ constexpr int win_stride() {
  return sizeof(T) == 4 ? kWinCols : kWinCols + 4;
}

// Shared memory a staged chunk and its halo take; above kMaxSmem the pass
// reads device memory directly.
template <typename T>
__host__ __device__ inline long long window_smem(int chunk, int halo) {
  return (long long)(chunk + halo) * win_stride<T>() * (long long)sizeof(T);
}

template <int VEC>
struct WinVec;
template <>
struct WinVec<4> {
  using F = float4;
  __device__ static F zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  template <typename T>
  __device__ static F load(const T* p) { return load4(p); }
  __device__ static void add(F& a, F v) { a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w; }
  template <typename T>
  __device__ static void store(T* p, F v) { store4(p, v); }
  __device__ static F rest(F v) { return bf16_rest(v); }
};
template <>
struct WinVec<1> {
  using F = float;
  __device__ static F zero() { return 0.f; }
  template <typename T>
  __device__ static F load(const T* p) { return to_f(*p); }
  __device__ static void add(F& a, F v) { a += v; }
  template <typename T>
  __device__ static void store(T* p, F v) { *p = from_f<T>(v); }
  __device__ static F rest(F v) { return v - to_f(__float2bfloat16(v)); }
};

// VEC columns of a frame of the source: the groups' slices summed in order.
template <typename TI, int VEC>
__device__ __forceinline__ typename WinVec<VEC>::F win_src(const TI* p, int groups,
                                                           long long n_group) {
  using W = WinVec<VEC>;
  auto v = W::load(p);
  for (int k = 1; k < groups; ++k) W::add(v, W::load(p + k * n_group));
  return v;
}

// BYTES from global to shared memory, or BYTES zeros when !ok (src, then
// not read, is still a valid address).
template <int BYTES>
__device__ __forceinline__ void win_cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 8 : 0));
}

template <typename TI, typename TO, int VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const TI* __restrict__ in, int groups, long long n_group, TO* __restrict__ out,
                  TO* __restrict__ out_lo, int L, long long Q, int K, int stride, int reverse,
                  int chunk) {
  using W = WinVec<VEC>;
  using F = typename W::F;
  constexpr int R = kWinR;
  constexpr int kLanes = kWinCols / VEC;     // threads along a frame
  constexpr int kTRows = kThreads / kLanes;  // groups at once
  constexpr int kStride = win_stride<TI>();
  extern __shared__ float4 win_smem[];
  TI* tile = reinterpret_cast<TI*>(win_smem);
  const int chunks = (L + chunk - 1) / chunk;
  const long long seq = blockIdx.x / chunks;
  const int c0 = (int)(blockIdx.x % chunks) * chunk;
  const int lane = threadIdx.x % kLanes, trow = threadIdx.x / kLanes;
  const long long col = (long long)blockIdx.y * kWinCols + lane * VEC;
  const bool live = col < Q;  // VEC = 4: Q is a multiple of 4
  const int halo = (K - 1) * stride;
  const int first = reverse ? c0 : c0 - halo;  // frame of tile row 0
  const TI* src = in + seq * L * Q + col;

  if constexpr (STAGED) {
    const int rows = chunk + halo;
    TI* dst = tile + lane * VEC;
    for (int r = trow; r < rows; r += kTRows) {
      const int t = first + r;
      const bool ok = live && t >= 0 && t < L;
      if constexpr (VEC == 4) {  // one source slice (window_pass checks it)
        win_cp_async<(int)(4 * sizeof(TI))>(dst + r * kStride, ok ? src + (long long)t * Q : in, ok);
      } else {
        const float v = ok ? win_src<TI, 1>(src + (long long)t * Q, groups, n_group) : 0.f;
        dst[r * kStride] = from_f<TI>(v);
      }
    }
    if constexpr (VEC == 4) {
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (!live) return;
  const int dir = reverse ? -1 : 1;
  // frame m of a group (m = R - 1 newest ... -(K - 1) oldest; output i
  // takes frames m = i, i - 1, ..., i - K + 1) sits at time base + dir*m*s
  auto frame = [&](int base, int m) -> F {
    const int t = base + dir * m * stride;
    if constexpr (STAGED) {
      return W::load(tile + (t - first) * kStride + lane * VEC);
    } else {
      return t >= 0 && t < L ? win_src<TI, VEC>(src + (long long)t * Q, groups, n_group)
                             : W::zero();
    }
  };
  const int ngroups = chunk / R;
  for (int g = trow; g < ngroups; g += kTRows) {
    const int lo_t = c0 + g % stride + (g / stride) * R * stride;  // earliest output
    if (lo_t >= L) continue;
    const int base = reverse ? lo_t + (R - 1) * stride : lo_t;  // output i = 0
    F acc[R];
    // frames m = R - 1 ... 0: the first tap of output m, then the later taps
    // of the outputs after it
#pragma unroll
    for (int m = R - 1; m >= 0; --m) {
      const F v = frame(base, m);
      acc[m] = v;
#pragma unroll
      for (int i = m + 1; i < R; ++i)
        if (i - m < K) W::add(acc[i], v);
    }
    // frames m = -1 ... -(K - R): a tap of every output
#pragma unroll 4
    for (int d = 1; d <= K - R; ++d) {
      const F v = frame(base, -d);
#pragma unroll
      for (int i = 0; i < R; ++i) W::add(acc[i], v);
    }
    // the oldest R - 1 frames, m = -(K - 1 - e): the last tap of outputs <= e
#pragma unroll
    for (int e = R - 2; e >= 0; --e) {
      if (e <= K - 2) {
        const F v = frame(base, -(K - 1 - e));
#pragma unroll
        for (int i = 0; i <= e; ++i) W::add(acc[i], v);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = base + dir * i * stride;
      if (t >= L) continue;
      const long long o = (seq * L + t) * Q + col;
      W::store(out + o, acc[i]);
      if constexpr (sizeof(TO) == 2) {
        if (out_lo != nullptr) W::store(out_lo + o, W::rest(acc[i]));
      }
    }
  }
}

template <typename TI, typename TO, int VEC>
cudaError_t window_launch(const TI* in, int groups, TO* out, TO* out_lo, long long N, int L,
                          long long Q, int K, int stride, bool reverse, int chunk,
                          cudaStream_t stream) {
  const long long smem = window_smem<TI>(chunk, (K - 1) * stride);
  const long long chunks = (L + chunk - 1) / chunk;
  const dim3 grid((unsigned)(N * chunks), (unsigned)((Q + kWinCols - 1) / kWinCols));
  if (smem <= kMaxSmem) {
    auto kernel = window_kernel<TI, TO, VEC, true>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, (size_t)smem, stream>>>(in, groups, N * L * Q, out, out_lo, L, Q, K,
                                                    stride, reverse, chunk);
  } else {
    window_kernel<TI, TO, VEC, false><<<grid, kThreads, 0, stream>>>(
        in, groups, N * L * Q, out, out_lo, L, Q, K, stride, reverse, chunk);
  }
  return cudaGetLastError();
}

// The window pass over N sequences of L frames and Q columns, `chunk`
// outputs a block (a multiple of kWinR * stride; ops/window_sum.py::
// window_plan). With groups > 1 the input is fp32 and sums `groups` slices
// of N * L * Q values each. The vector route takes Q a multiple of 4 and
// every pointer aligned for four values a load, one source slice when it
// stages; else the scalar one.
template <typename TI, typename TO>
cudaError_t window_pass(const TI* in, int groups, TO* out, TO* out_lo, long long N, int L,
                        long long Q, int K, int stride, bool reverse, int chunk,
                        cudaStream_t stream) {
  const long long chunks = chunk > 0 ? (L + chunk - 1) / chunk : 0;
  if (N <= 0 || L <= 0 || Q <= 0 || K < 1 || stride < 1 || groups < 1 || chunk <= 0 ||
      chunk % (kWinR * stride) != 0 || (groups > 1 && sizeof(TI) != 4) ||
      N * chunks > 2147483647LL || (Q + kWinCols - 1) / kWinCols > 65535 ||
      (long long)(K - 1) * stride > (1 << 24))
    return cudaErrorInvalidValue;
  auto aligned = [](const void* p, size_t bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  const bool staged = window_smem<TI>(chunk, (K - 1) * stride) <= kMaxSmem;
  const bool vec = Q % 4 == 0 && aligned(in, 4 * sizeof(TI)) && aligned(out, 4 * sizeof(TO)) &&
                   (out_lo == nullptr || aligned(out_lo, 4 * sizeof(TO))) &&
                   (groups == 1 || !staged);
  if (vec)
    return window_launch<TI, TO, 4>(in, groups, out, out_lo, N, L, Q, K, stride, reverse, chunk,
                                    stream);
  return window_launch<TI, TO, 1>(in, groups, out, out_lo, N, L, Q, K, stride, reverse, chunk,
                                  stream);
}

}  // namespace stgx
