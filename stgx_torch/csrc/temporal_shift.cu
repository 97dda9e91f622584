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
// Design (ops/shift.py::shift_plan sizes every launch):
//  * Columns of 16 bytes. A block takes 32 columns, one a lane, each W = 4
//    fp32 or 8 bf16 channels of one (n, v) pair, and a tile of output
//    frames. Channels next to each other take their taps from different
//    frames, so the block stages the rows its tile needs, (tile - 1) * s +
//    2K + 2 frames of its 32 columns, in shared memory first. The columns
//    follow the channel width: a pair's channels take cbv = min(8, C / W)
//    columns (a power of two) and the block takes 32 / cbv pairs, so at 8 or
//    16 channels (TP's blocks) a block still fills its 32 lanes.
//  * Asynchronous staging. Every row of a column is one 16-byte cp.async,
//    all of a tile's rows in flight at once (34 KB a block at L = 50);
//    frames outside [0, L) are zero-filled with a source size of 0, unread.
//  * Reads without bank conflicts. A lane reads each of its W channels from
//    the row of that channel's tap; lanes l, l + 8, l + 16, l + 24 hold
//    columns on the same banks, so each takes its channels in an order
//    rotated by (l / 8) words, and un-rotates them in registers before its
//    one 16-byte store.
//  * A C that is not a multiple of W, or a tensor not 16-byte aligned, runs
//    the same kernel with columns of one channel, staged by plain loads.
// The products and the add are rounded separately in fp32 (no contraction
// into an FMA), as the plain banded sum rounds them, and the result is
// rounded once to the output type: in fp32 the plain version's bits, in
// bf16 the fp32 plain version's of the widened x and shift, rounded once.
#include <stdint.h>

#include <initializer_list>

#include "common.cuh"
#include "mma.cuh"

namespace {

using stgx::mma::cp_async16;

constexpr int kCols = 32;                          // columns a block, one a lane
constexpr int kParts = stgx::kThreads / kCols;     // warps: frames formed at once
constexpr int kGroup = 4;                          // (n, v) pairs a g_shift partial adds
constexpr int kRedWarps = 32;                      // warps of the g_shift reduction

// A launch's shape and plan (ops/shift.py::shift_plan).
struct Shape {
  long long pairs;  // N * V
  int L, Lo, V, C, stride, K;
  int tile;  // output frames a block
  int lcbv;  // log2 of the columns a pair takes in a block
};

// Where lane `col`'s column lies: its (n, v) pair and first channel. False
// past the pairs or the channels: such a column is staged as zeros and never
// stored.
template <int W>
__device__ __forceinline__ bool column(const Shape& sh, int col, long long& n, int& v, int& c) {
  const int cbv = 1 << sh.lcbv;
  const long long pair = (long long)blockIdx.x * (kCols >> sh.lcbv) + (col >> sh.lcbv);
  c = ((int)blockIdx.y * cbv + (col & (cbv - 1))) * W;
  n = pair / sh.V;
  v = (int)(pair - n * sh.V);
  return pair < sh.pairs && c < sh.C;
}

// Stage frames [first, first + rows) of a column (src: its frame 0, frames
// fs elements apart, `frames` of them) into slab rows of kCols * W values:
// 16 bytes through cp.async where a column is 16 bytes, else one value by a
// plain load. Frames outside [0, frames) and invalid columns stage zeros.
template <typename T, int W>
__device__ __forceinline__ void stage(T* slab, const T* src, const T* any, bool ok, int first,
                                      int rows, int frames, long long fs, int col, int part) {
  for (int r = part; r < rows; r += kParts) {
    const int t = first + r;
    const bool in = ok && t >= 0 && t < frames;
    T* d = slab + (r * kCols + col) * W;
    if constexpr (W * sizeof(T) == 16) {
      cp_async16(d, in ? (const void*)(src + t * fs) : (const void*)any, in);
    } else {
      *d = in ? src[t * fs] : stgx::from_f<T>(0.f);
    }
  }
  if constexpr (W * sizeof(T) == 16) stgx::mma::cp_async_commit();
}

// Wait for all but the last committed group of cp.async copies.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Words a lane rotates its channels by: lanes 8 apart hold columns on the
// same banks, and (l / 8) mod 4 sets them on four different words of them.
template <int W>
__device__ __forceinline__ int rotation(int col) {
  return W >= 4 ? (col >> 3) & 3 : 0;
}

// Channel of a column taken j-th.
template <int W>
__device__ __forceinline__ int channel_at(int j, int rot) {
  return (j + rot * (W / 4)) & (W - 1);
}

// Store W values taken in rotated order as one 16-byte row piece (one value
// where a column is one channel), rounded once to T.
template <typename T, int W>
__device__ __forceinline__ void store(T* dst, const float (&o)[W], int rot) {
  if constexpr (W == 1) {
    *dst = stgx::from_f<T>(o[0]);
  } else {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 4) {
        u[k] = __float_as_uint(o[k]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
        u[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    // word k of the row piece is word (k - rot) mod 4 of u
    const bool r1 = rot & 1, r2 = rot & 2;
    const uint32_t a0 = r1 ? u[3] : u[0], a1 = r1 ? u[0] : u[1];
    const uint32_t a2 = r1 ? u[1] : u[2], a3 = r1 ? u[2] : u[3];
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(r2 ? a2 : a0, r2 ? a3 : a1, r2 ? a0 : a2, r2 ? a1 : a3);
  }
}

// The two taps of each of a lane's channels, in its rotated order: the
// weights 1 - a and a, and the slab index of output 0's first tap. The shift
// is in x's type, as the JAX op takes it; clip, floor and the fraction are
// exact in fp32.
template <typename T, int W>
struct Taps {
  float a[W], wa[W];
  int f[W];    // floor of the clipped shift
  int ce[W];   // the channel's place in a slab row
  int at[W];   // its slab index in row f + K: output 0's first tap
  __device__ __forceinline__ Taps(const T* shift, bool ok, int c, int col, int rot, int K) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int e = channel_at<W>(j, rot);
      const float sc = ok ? fminf(fmaxf(stgx::to_f(shift[c + e]), (float)-K), (float)K) : 0.f;
      const float fl = floorf(sc);
      a[j] = sc - fl;
      wa[j] = 1.f - a[j];
      f[j] = (int)fl;
      ce[j] = col * W + e;
      at[j] = (f[j] + K) * kCols * W + ce[j];
    }
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(stgx::kThreads)
    temporal_shift_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                          T* __restrict__ y, Shape sh) {
  extern __shared__ __align__(16) unsigned char shift_smem[];
  constexpr int kRow = kCols * W;  // slab values a row
  T* slab = reinterpret_cast<T*>(shift_smem);
  const int col = threadIdx.x % kCols, part = threadIdx.x / kCols;
  long long n;
  int v, c;
  const bool ok = column<W>(sh, col, n, v, c);
  const long long fs = (long long)sh.V * sh.C;  // elements a frame
  const int t0 = blockIdx.z * sh.tile;
  const int nt = stgx::imin(sh.tile, sh.Lo - t0);
  const int s = sh.stride;
  stage<T, W>(slab, x + (n * sh.L * sh.V + v) * sh.C + c, x, ok, t0 * s - sh.K,
              (nt - 1) * s + 2 * sh.K + 2, sh.L, fs, col, part);
  const int rot = rotation<W>(col);
  const Taps<T, W> tp(shift, ok, c, col, rot, sh.K);
  if constexpr (W * sizeof(T) == 16) stgx::mma::cp_async_wait_all();
  __syncthreads();
  if (!ok) return;
  T* yc = y + (n * sh.Lo * sh.V + v) * sh.C + c;
  for (int to = part; to < nt; to += kParts) {
    const int base = to * s * kRow;
    float o[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float p0 = __fmul_rn(tp.wa[j], stgx::to_f(slab[base + tp.at[j]]));
      const float p1 = __fmul_rn(tp.a[j], stgx::to_f(slab[base + tp.at[j] + kRow]));
      o[j] = __fadd_rn(p0, p1);
    }
    store<T, W>(yc + (t0 + to) * fs, o, rot);
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
// Design: the forward's columns, vector width and rotation. A block stages
// its g rows at their own (stride-compressed) frames, t0 - B to t0 + tile +
// A with B = ceil((K+1)/s) and A = ceil(K/s), then its tile's x rows as the
// forward does, both by cp.async in two groups: gx, which needs g alone, is
// formed while x's rows are still arriving. gx places g on the input grid in the
// index arithmetic of its read: G[j] is g row j / s where s divides j (one
// row read, a select for which tap it is), so stride 1 reads two rows and
// stride 2 one. Its products and add are rounded separately in fp32, the
// plain version's bits, rounded once to x's type, one 16-byte store a frame.
// g_shift's sum has an order fixed by (N, L, V, stride, K) alone, never by C
// or the block's channels, so TP's channel blocks join bit for bit with the
// whole launch, and free of atomics, so a run repeats its bits:
//  1. each warp w sums g * dx over its tile's frames to = w, w + 8, ... in
//     order, for each channel of each pair (fp32, products and adds
//     rounded separately);
//  2. the block adds the eight warps' sums in warp order, then the pairs of
//     each aligned group of kGroup = 4 pairs in pair order: one partial a
//     (group, tile, channel). A block holds whole groups (32 / cbv >= 4
//     pairs, aligned), so the partial is the same whatever its width;
//  3. one reduction launch adds each channel's ceil(NV / 4) * tiles
//     partials: 32 warps each add a contiguous span in order, then the 32
//     span sums in warp order, times inside_c.
// The tile is sized by rows alone (shift_plan), so it too is the same for
// every width and type.

template <typename T, int W, int S>
__global__ void __launch_bounds__(stgx::kThreads)
    temporal_shift_bwd_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                              const T* __restrict__ g, T* __restrict__ gx,
                              float* __restrict__ partial, Shape sh) {
  extern __shared__ __align__(16) unsigned char shift_smem[];
  constexpr int kRow = kCols * W;
  const int s = S > 0 ? S : sh.stride;  // S = 0: any stride past 2
  const int K = sh.K;
  const int back = (K + s) / s, ahead = (K + s - 1) / s;  // g rows before and after
  T* xs = reinterpret_cast<T*>(shift_smem);
  T* gs = xs + ((sh.tile - 1) * s + 2 * K + 2) * kRow;
  const int col = threadIdx.x % kCols, part = threadIdx.x / kCols;
  long long n;
  int v, c;
  const bool ok = column<W>(sh, col, n, v, c);
  const long long fs = (long long)sh.V * sh.C;
  const int t0 = blockIdx.z * sh.tile;
  const int nt = stgx::imin(sh.tile, sh.Lo - t0);
  const long long xoff = (n * sh.L * sh.V + v) * sh.C + c;
  // g first: gx needs only g, and is formed while x's rows arrive
  stage<T, W>(gs, g + (n * sh.Lo * sh.V + v) * sh.C + c, g, ok, t0 - back, nt + back + ahead,
              sh.Lo, fs, col, part);
  stage<T, W>(xs, x + xoff, x, ok, t0 * s - K, (nt - 1) * s + 2 * K + 2, sh.L, fs, col, part);
  const int rot = rotation<W>(col);
  const Taps<T, W> tp(shift, ok, c, col, rot, K);
  int gat[W];  // input-grid frame of gs row 0 of channel j's first tap, less i
#pragma unroll
  for (int j = 0; j < W; ++j) gat[j] = (back - t0) * s - tp.f[j];
  if constexpr (W * sizeof(T) == 16) cp_async_wait_one();
  __syncthreads();

  if (ok) {
    const int i1 = stgx::imin(sh.L, (t0 + nt) * s);
    for (int i = t0 * s + part; i < i1; i += kParts) {
      float o[W];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int jr = i + gat[j];  // G[i - f] is input-grid frame jr of gs, >= 0
        const int e = tp.ce[j];
        float g0, g1;
        if constexpr (S == 1) {
          g0 = stgx::to_f(gs[jr * kRow + e]);
          g1 = stgx::to_f(gs[(jr - 1) * kRow + e]);
        } else {
          const int q = jr / s, m = jr - q * s;  // G[jr] and G[jr - 1] share row q
          const float val = stgx::to_f(gs[q * kRow + e]);
          g0 = m == 0 ? val : 0.f;
          g1 = m == 1 ? val : 0.f;
        }
        o[j] = __fadd_rn(__fmul_rn(tp.wa[j], g0), __fmul_rn(tp.a[j], g1));
      }
      store<T, W>(gx + xoff + i * fs, o, rot);
    }
  }
  if constexpr (W * sizeof(T) == 16) stgx::mma::cp_async_wait_all();
  __syncthreads();
  float dot[W];
#pragma unroll
  for (int j = 0; j < W; ++j) dot[j] = 0.f;
  for (int to = part; to < nt; to += kParts) {
    const int base = to * s * kRow, grow = (to + back) * kRow;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float gv = stgx::to_f(gs[grow + tp.ce[j]]);
      const float dx = __fsub_rn(stgx::to_f(xs[base + tp.at[j] + kRow]),
                                 stgx::to_f(xs[base + tp.at[j]]));
      dot[j] = __fadd_rn(dot[j], __fmul_rn(gv, dx));
    }
  }
  __syncthreads();  // the slab is read; its start holds the warps' sums now
  float* red = reinterpret_cast<float*>(shift_smem);  // [kParts][kRow]
#pragma unroll
  for (int j = 0; j < W; ++j) red[part * kRow + col * W + channel_at<W>(j, rot)] = dot[j];
  __syncthreads();
  for (int k = threadIdx.x; k < kRow; k += stgx::kThreads) {
    float sum = red[k];
    for (int p = 1; p < kParts; ++p) sum = __fadd_rn(sum, red[p * kRow + k]);
    red[k] = sum;
  }
  __syncthreads();
  const int cbv = 1 << sh.lcbv, per_group = kGroup * cbv * W;
  const long long groups = (sh.pairs + kGroup - 1) / kGroup;
  for (int k = threadIdx.x; k < (kCols / kGroup) * W; k += stgx::kThreads) {
    const int gi = k / (cbv * W), r = k - gi * cbv * W;  // r = column-in-pair * W + channel
    float sum = red[gi * per_group + r];
    for (int q = 1; q < kGroup; ++q) sum = __fadd_rn(sum, red[gi * per_group + q * cbv * W + r]);
    const long long group = (long long)blockIdx.x * ((kCols >> sh.lcbv) / kGroup) + gi;
    const int ch = (int)blockIdx.y * cbv * W + r;
    if (group < groups && ch < sh.C)
      partial[(group * gridDim.z + blockIdx.z) * sh.C + ch] = sum;
  }
}

// g_shift[c] = inside_c * the sum of channel c's P partials: 32 warps each
// add a span of ceil(P / 32) in order, eight loads in flight, then the
// spans are added in order.
template <typename T>
__global__ void __launch_bounds__(kRedWarps * 32)
    shift_grad_kernel(const float* __restrict__ partial, const T* __restrict__ shift,
                      T* __restrict__ gshift, long long P, int C, int K) {
  __shared__ float red[kRedWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const long long span = (P + kRedWarps - 1) / kRedWarps;
  const long long p1 = stgx::lmin((warp + 1) * span, P);
  float sum = 0.f;
  if (c < C) {
    long long p = warp * span;
    for (; p + 8 <= p1; p += 8) {
      float val[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) val[u] = partial[(p + u) * C + c];
#pragma unroll
      for (int u = 0; u < 8; ++u) sum = __fadd_rn(sum, val[u]);
    }
    for (; p < p1; ++p) sum = __fadd_rn(sum, partial[p * C + c]);
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < C) {
    float total = red[0][lane];
    for (int w = 1; w < kRedWarps; ++w) total = __fadd_rn(total, red[w][lane]);
    const float sh = fabsf(stgx::to_f(shift[c]));
    const float inside = sh < (float)K ? 1.f : sh == (float)K ? 0.5f : 0.f;
    gshift[c] = stgx::from_f<T>(__fmul_rn(total, inside));
  }
}

// The plan's geometry, checked: the grid and the shared memory of a block
// whose slab holds `rows` rows. Returns cudaSuccess or the reason to refuse.
cudaError_t geometry(const Shape& sh, int W, int itemsize, int rows, dim3& grid, size_t& smem) {
  if (sh.pairs <= 0 || sh.L <= 0 || sh.V <= 0 || sh.C <= 0 || sh.stride < 1 || sh.K < 0 ||
      sh.tile < 1 || sh.tile > sh.Lo || sh.lcbv < 0 || sh.lcbv > 3 || sh.C % W != 0)
    return cudaErrorInvalidValue;
  const long long pblocks = (sh.pairs + (kCols >> sh.lcbv) - 1) / (kCols >> sh.lcbv);
  const long long chunks = ((sh.C / W) + (1 << sh.lcbv) - 1) >> sh.lcbv;
  const long long tiles = (sh.Lo + sh.tile - 1) / sh.tile;
  smem = (size_t)rows * kCols * W * itemsize;
  if (pblocks > 2147483647LL || chunks > 65535 || tiles > 65535 || smem > (size_t)stgx::kMaxSmem)
    return cudaErrorInvalidValue;
  grid = dim3((unsigned)pblocks, (unsigned)chunks, (unsigned)tiles);
  return cudaSuccess;
}

template <typename K>
cudaError_t launch_smem(K kernel, size_t smem) {
  return smem > 48 * 1024 ? stgx::mma::allow_smem(kernel, smem) : cudaSuccess;
}

template <typename T, int W>
int shift_fwd(const void* x, const void* shift, void* y, const Shape& sh, cudaStream_t s) {
  dim3 grid;
  size_t smem;
  cudaError_t e = geometry(sh, W, sizeof(T), (sh.tile - 1) * sh.stride + 2 * sh.K + 2, grid, smem);
  if (e != cudaSuccess) return (int)e;
  auto kernel = temporal_shift_kernel<T, W>;
  if ((e = launch_smem(kernel, smem)) != cudaSuccess) return (int)e;
  kernel<<<grid, stgx::kThreads, smem, s>>>(static_cast<const T*>(x),
                                            static_cast<const T*>(shift), static_cast<T*>(y), sh);
  return (int)cudaGetLastError();
}

template <typename T, int W, int S>
int shift_bwd(const void* x, const void* shift, const void* g, void* gx, void* gshift, float* ws,
              const Shape& sh, cudaStream_t s) {
  const int back = (sh.K + sh.stride) / sh.stride, ahead = (sh.K + sh.stride - 1) / sh.stride;
  const int rows = (sh.tile - 1) * sh.stride + 2 * sh.K + 2 + sh.tile + back + ahead;
  dim3 grid;
  size_t smem;
  cudaError_t e = geometry(sh, W, sizeof(T), rows, grid, smem);
  if (e != cudaSuccess) return (int)e;
  // the warps' sums reuse the slab: kParts rows of kCols * W floats
  smem = smem > (size_t)kParts * kCols * W * 4 ? smem : (size_t)kParts * kCols * W * 4;
  auto kernel = temporal_shift_bwd_kernel<T, W, S>;
  if ((e = launch_smem(kernel, smem)) != cudaSuccess) return (int)e;
  kernel<<<grid, stgx::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift), static_cast<const T*>(g),
      static_cast<T*>(gx), ws, sh);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long P = (sh.pairs + kGroup - 1) / kGroup * grid.z;
  shift_grad_kernel<T><<<(sh.C + 31) / 32, kRedWarps * 32, 0, s>>>(
      ws, static_cast<const T*>(shift), static_cast<T*>(gshift), P, sh.C, sh.K);
  return (int)cudaGetLastError();
}

template <typename T>
int shift_bwd_stride(const void* x, const void* shift, const void* g, void* gx, void* gshift,
                     float* ws, const Shape& sh, bool vec, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (sh.stride == 1)
    return vec ? shift_bwd<T, kVec, 1>(x, shift, g, gx, gshift, ws, sh, s)
               : shift_bwd<T, 1, 1>(x, shift, g, gx, gshift, ws, sh, s);
  if (sh.stride == 2)
    return vec ? shift_bwd<T, kVec, 2>(x, shift, g, gx, gshift, ws, sh, s)
               : shift_bwd<T, 1, 2>(x, shift, g, gx, gshift, ws, sh, s);
  return vec ? shift_bwd<T, kVec, 0>(x, shift, g, gx, gshift, ws, sh, s)
             : shift_bwd<T, 1, 0>(x, shift, g, gx, gshift, ws, sh, s);
}

bool aligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (!stgx::mma::aligned16(p)) return false;
  return true;
}

Shape make_shape(long long N, int L, int V, int C, int stride, int K, int tile, int lcbv) {
  const int Lo = stride >= 1 ? (L + stride - 1) / stride : 0;
  return Shape{N * V, L, Lo, V, C, stride, K, tile, lcbv};
}

}  // namespace

// x (N, L, V, C), shift (C), y (N, ceil(L / stride), V, C), contiguous, one
// type: dtype 0 = float32, 1 = bfloat16. K is the clip of the shifts (the
// JAX op's max_shift). tile, lcbv and vec are ops/shift.py::shift_plan's:
// output frames a block, log2 of the columns a pair takes, and columns of
// 16 bytes (vec = 1: C a multiple of 16 bytes' channels, x and y 16-byte
// aligned) or of one channel. Returns the CUDA error of the launch
// (0 on success).
extern "C" int stgx_temporal_shift(const void* x, const void* shift, void* y, long long N, int L,
                                   int V, int C, int stride, int K, int tile, int lcbv, int vec,
                                   int dtype, void* stream) {
  if (N <= 0 || N * V > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(N, L, V, C, stride, K, tile, lcbv);
  if (vec && !aligned({x, y})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? shift_fwd<float, 4>(x, shift, y, sh, s) : shift_fwd<float, 1>(x, shift, y, sh, s);
  if (dtype == 1)
    return vec ? shift_fwd<__nv_bfloat16, 8>(x, shift, y, sh, s)
               : shift_fwd<__nv_bfloat16, 1>(x, shift, y, sh, s);
  return (int)cudaErrorInvalidValue;
}

// x (N, L, V, C), shift (C), g (N, ceil(L / stride), V, C), gx like x,
// g_shift like shift: contiguous, one type (dtype 0 = float32, 1 =
// bfloat16). tile, lcbv and vec as for stgx_temporal_shift, from the
// backward's plan. ws: fp32 workspace of P * C floats, P = ceil(N * V / 4) *
// ceil(ceil(L / stride) / tile) partials. Returns the CUDA error of the
// launches (0 on success).
extern "C" int stgx_temporal_shift_bwd(const void* x, const void* shift, const void* g,
                                       void* gx, void* gshift, float* ws, long long N, int L,
                                       int V, int C, int stride, int K, int tile, int lcbv,
                                       int vec, int dtype, void* stream) {
  if (N <= 0 || N * V > 2147483647LL) return (int)cudaErrorInvalidValue;
  const Shape sh = make_shape(N, L, V, C, stride, K, tile, lcbv);
  if (vec && !aligned({x, g, gx})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return shift_bwd_stride<float>(x, shift, g, gx, gshift, ws, sh, vec, s);
  if (dtype == 1) return shift_bwd_stride<__nv_bfloat16>(x, shift, g, gx, gshift, ws, sh, vec, s);
  return (int)cudaErrorInvalidValue;
}
