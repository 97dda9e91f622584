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

// ---------------------------------------------------------------- backward
//
// The shift's vector-Jacobian product, from the same (x, shift) and the
// upstream gradient g (N, Lo, V, C). With G the gradient on the input grid
// (G[t*s] = g[t], zero between and outside):
//   gx[i]      = (1 - a_c) * G[i - f_c] + a_c * G[i - f_c - 1]
//   g_shift[c] = inside_c * sum_{n,t,v} g[t] * (x[t*s + f_c + 1] - x[t*s + f_c])
// inside_c = 1 inside the clip, 1/2 at exactly +-K, 0 beyond (the gradient
// of JAX's clip). The JAX package has no backward kernel: its VJP is XLA
// (stgx/ops/shift.py:_ts_bwd, the banded form's jax.vjp).
//
// Bound on the H100: bytes, one read of g and of x and one write of gx.
//
// Design: the forward's layout. One block per (n, v) column, 32-channel
// chunk and tile of output frames; the block stages in shared memory the
// rows of g (placed on the input grid) and of x that the tile needs, each
// row's 32 channels one coalesced load, and each lane owns one channel and
// reads its taps from its own bank. The block forms gx for the input frames
// of its tile (i in [t0*s, (t0 + tile)*s)), the products and the add
// rounded separately in fp32 (no FMA contraction): the plain version's bits,
// rounded once to x's type. It also sums g * dx over its frames in fp32,
// eight thread rows in turn, added in row order, and writes that partial
// for its 32 channels. Two passes add the partials in a fixed order, spans
// of kSpan partials and then the spans: no atomics, the same bits from run
// to run. The blocks are small, so occupancy hides their latency: 32
// registers a thread let eight blocks share an SM (48 allowed five, and ran
// 8 % slower on the H100).
constexpr int kSpan = 256;  // partials the first reduction pass adds a block

// Bytes of the x and g rows a block stages: a full tile's, at most 2 *
// kSlabRows rows of kLanes floats (40 KB), little at the short sequences of
// Shift-GCN's later units, so that more blocks share an SM.
inline size_t shift_bwd_smem(int tile, int stride, int K) {
  return (size_t)((tile - 1) * stride + 2 * K + 2 + tile * stride + 2 * K + 1) * kLanes *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(stgx::kThreads, 8)
    temporal_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                              const T* __restrict__ g, T* __restrict__ gx,
                              float* __restrict__ partial, int L, int Lo, int V, int C,
                              int stride, int K, int tile) {
  // xs: the tile's x rows, gs: its g rows on the input grid, each as many
  // as the tile needs (shift_bwd_smem)
  extern __shared__ float shift_smem[];
  __shared__ float red[kRowsPar * kLanes];
  const long long col = blockIdx.x;  // (n, v)
  const long long n = col / V;
  const int v = (int)(col - n * V);
  const int c0 = blockIdx.y * kLanes;
  const int t0 = blockIdx.z * tile;
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  const int c = c0 + lane;
  const int nt = stgx::imin(tile, Lo - t0);
  const int xfirst = t0 * stride - K;       // input frame of xs row 0
  const int xrows = (nt - 1) * stride + 2 * K + 2;
  const int gfirst = t0 * stride - K - 1;   // input-grid frame of gs row 0
  const int grows = nt * stride + 2 * K + 1;
  float* xs = shift_smem;
  float* gs = shift_smem + ((tile - 1) * stride + 2 * K + 2) * kLanes;

  for (int r = part; r < xrows; r += kRowsPar) {
    const int t = xfirst + r;
    float val = 0.f;
    if (t >= 0 && t < L && c < C) val = stgx::to_f(x[((n * L + t) * V + v) * C + c]);
    xs[r * kLanes + lane] = val;
  }
  for (int r = part; r < grows; r += kRowsPar) {
    const int j = gfirst + r;
    float val = 0.f;
    if (j >= 0 && j % stride == 0 && j / stride < Lo && c < C)
      val = stgx::to_f(g[((n * Lo + j / stride) * V + v) * C + c]);
    gs[r * kLanes + lane] = val;
  }
  const float sc = c < C ? fminf(fmaxf(stgx::to_f(shift[c]), (float)-K), (float)K) : 0.f;
  const float f = floorf(sc);
  const float a = sc - f;
  const float wa = 1.f - a;
  const int fi = (int)f;
  __syncthreads();
  float dot = 0.f;
  if (c < C) {
    const int i1 = stgx::imin(L, (t0 + nt) * stride);
    for (int i = t0 * stride + part; i < i1; i += kRowsPar) {
      const int r = i - fi - gfirst;  // gs row of G[i - f]
      const float p0 = __fmul_rn(wa, gs[r * kLanes + lane]);
      const float p1 = __fmul_rn(a, gs[(r - 1) * kLanes + lane]);
      gx[((n * L + i) * V + v) * C + c] = stgx::from_f<T>(__fadd_rn(p0, p1));
    }
    for (int to = part; to < nt; to += kRowsPar) {
      const int t = (t0 + to) * stride;
      const int r = t + fi - xfirst;  // xs row of x[t*s + f]
      const float dx = __fsub_rn(xs[(r + 1) * kLanes + lane], xs[r * kLanes + lane]);
      dot = __fadd_rn(dot, __fmul_rn(gs[(t - gfirst) * kLanes + lane], dx));
    }
  }
  red[part * kLanes + lane] = dot;
  __syncthreads();
  if (part == 0 && c < C) {
    float sum = red[lane];
    for (int p = 1; p < kRowsPar; ++p) sum = __fadd_rn(sum, red[p * kLanes + lane]);
    const long long b = (col * gridDim.z + blockIdx.z);  // partial index
    partial[b * C + c] = sum;
  }
}

// spans[s][c] = sum of partials [s * kSpan, (s + 1) * kSpan) of channel c,
// in order: eight thread rows each add a run of kSpan / 8 in order, then the
// rows are added in row order.
__global__ void __launch_bounds__(stgx::kThreads)
    shift_span_kernel(const float* __restrict__ partial, float* __restrict__ spans,
                      long long P, int C) {
  __shared__ float red[kRowsPar * kLanes];
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  const int c = blockIdx.x * kLanes + lane;
  const long long p0 = (long long)blockIdx.y * kSpan + part * (kSpan / kRowsPar);
  const long long p1 = stgx::lmin(p0 + kSpan / kRowsPar, P);
  float sum = 0.f;
  if (c < C)
    for (long long p = p0; p < p1; ++p) sum = __fadd_rn(sum, partial[p * C + c]);
  red[part * kLanes + lane] = sum;
  __syncthreads();
  if (part == 0 && c < C) {
    float s = red[lane];
    for (int q = 1; q < kRowsPar; ++q) s = __fadd_rn(s, red[q * kLanes + lane]);
    spans[(long long)blockIdx.y * C + c] = s;
  }
}

// g_shift[c] = inside_c * sum of the spans of channel c, in order.
template <typename T>
__global__ void __launch_bounds__(stgx::kThreads)
    shift_grad_kernel(const float* __restrict__ spans, const T* __restrict__ shift,
                      T* __restrict__ gshift, int S, int C, int K) {
  const int c = blockIdx.x * stgx::kThreads + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum = __fadd_rn(sum, spans[(long long)s * C + c]);
  const float sh = fabsf(stgx::to_f(shift[c]));
  const float inside = sh < (float)K ? 1.f : sh == (float)K ? 0.5f : 0.f;
  gshift[c] = stgx::from_f<T>(__fmul_rn(sum, inside));
}

template <typename T>
int shift_bwd(const void* xv, const void* shiftv, const void* gv, void* gxv, void* gshiftv,
              float* ws, long long N, int L, int Lo, int V, int C, int stride, int K, int tile,
              cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* shift = static_cast<const T*>(shiftv);
  const int tiles = (Lo + tile - 1) / tile;
  const long long P = N * V * tiles;
  const long long S = (P + kSpan - 1) / kSpan;
  float* spans = ws + P * C;
  const dim3 grid((unsigned)(N * V), (unsigned)((C + kLanes - 1) / kLanes), (unsigned)tiles);
  temporal_shift_bwd_kernel<T><<<grid, stgx::kThreads, shift_bwd_smem(tile, stride, K), s>>>(
      x, shift, static_cast<const T*>(gv), static_cast<T*>(gxv), ws, L, Lo, V, C, stride, K,
      tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  shift_span_kernel<<<dim3((unsigned)((C + kLanes - 1) / kLanes), (unsigned)S), stgx::kThreads,
                      0, s>>>(ws, spans, P, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  shift_grad_kernel<T><<<(C + stgx::kThreads - 1) / stgx::kThreads, stgx::kThreads, 0, s>>>(
      spans, shift, static_cast<T*>(gshiftv), (int)S, C, K);
  return (int)cudaGetLastError();
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

// x (N, L, V, C), shift (C), g (N, ceil(L / stride), V, C), gx like x,
// g_shift like shift: contiguous, one type (dtype 0 = float32, 1 =
// bfloat16). tile: output frames a block takes, with (tile - 1) * stride +
// 2K + 2 and tile * stride + 2K + 1 rows at most kSlabRows
// (ops/shift.py::shift_bwd_tile). ws: fp32 workspace of (P + ceil(P / 256))
// * C floats, P = N * V * ceil(Lo / tile) partials. Returns the CUDA error
// of the launches (0 on success).
extern "C" int stgx_temporal_shift_bwd(const void* x, const void* shift, const void* g,
                                       void* gx, void* gshift, float* ws, long long N, int L,
                                       int V, int C, int stride, int K, int tile, int dtype,
                                       void* stream) {
  const int Lo = (L + stride - 1) / stride;
  if (N <= 0 || L <= 0 || V <= 0 || C <= 0 || stride < 1 || K < 0 || tile < 1 ||
      (tile - 1) * stride + 2 * K + 2 > kSlabRows || tile * stride + 2 * K + 1 > kSlabRows ||
      N * V > 2147483647LL || (C + kLanes - 1) / kLanes > 65535 ||
      (Lo + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return shift_bwd<float>(x, shift, g, gx, gshift, ws, N, L, Lo, V, C, stride, K, tile, s);
  if (dtype == 1)
    return shift_bwd<__nv_bfloat16>(x, shift, g, gx, gshift, ws, N, L, Lo, V, C, stride, K,
                                    tile, s);
  return (int)cudaErrorInvalidValue;
}
