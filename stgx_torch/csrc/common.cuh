// Shared pieces of the port's kernels: type conversion, and the graph-conv
// tile that gcn_core.cu and rt_fused.cu both run.
//
// The graph conv  y[r,w,d] = sum_{p,v,c} x[r,v,c] * A[p,v,w] * W[p,c,d]  is a
// matrix product over the flattened output rows m = (r, w):
//   y[m, d] = sum_{(p,c)} T[m, (p,c)] * W[(p,c), d],
//   T[m, (p,c)] = sum_v x[r(m), v, c] * A[p, v, w(m)],
// where the left factor T (the per-partition neighbourhood aggregate) is
// formed in shared memory, one (p, C_in chunk) at a time, and never reaches
// device memory. Everything is summed in fp32; inputs may be fp32 or bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stgx {

constexpr int kThreads = 256;  // threads per block, all kernels
constexpr int kKC = 16;        // C_in chunk staged per contraction step
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

// Tile geometry for a BN-wide column chunk: each of the 256 threads owns a
// 4x4 block of outputs (4 rows m, 4 columns d), so a tile is BM x BN.
template <int BN>
struct Geo {
  static constexpr int NX = BN / 4;          // threads across columns
  static constexpr int NY = kThreads / NX;   // threads across rows
  static constexpr int BM = NY * 4;          // rows m per tile
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// (row, joint) pairs of x staged for a tile of bm rows m: the rows it
// touches span at most (bm - 1) / V + 2 input rows of V joints each.
__host__ __device__ inline int x_stage_pairs(int bm, int V) {
  return ((bm - 1) / V + 2) * V;
}

// Shared-memory floats of one tile: A (fp32), the staged x chunk, the T
// chunk and the W chunk, each a multiple of 4 floats so float4 reads align.
template <int BN>
__host__ __device__ inline int tile_smem_floats(int P, int V) {
  return round4(P * V * V) + x_stage_pairs(Geo<BN>::BM, V) * kKC +
         kKC * Geo<BN>::BM + kKC * BN;
}

// Carves the tile's buffers out of the block's dynamic shared memory.
template <int BN>
struct TileSmem {
  float* A;   // (P, V, V)
  float* X;   // (staged pairs, kKC)
  float* T;   // (kKC, BM)
  float* W;   // (kKC, BN)
  float* end; // first float after the tile
  __device__ TileSmem(float* base, int P, int V) {
    A = base;
    X = A + round4(P * V * V);
    T = X + x_stage_pairs(Geo<BN>::BM, V) * kKC;
    W = T + kKC * Geo<BN>::BM;
    end = W + kKC * BN;
  }
};

template <typename T>
__device__ void load_adjacency(float* As, const T* __restrict__ A, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) As[i] = to_f(A[i]);
}

// acc[i][j] = sum_{p,c} T[m, (p,c)] * W[p, c, d] for the thread's rows
// m = m0 + ty*4 + i and columns d = d0 + tx*4 + j. Rows m are local to the
// caller: input row r(m) = row_base + m / V and joint w(m) = m % V. Input
// rows outside [row_lo, row_hi) read as zero; rows m >= m_end are not
// formed. A must already sit in s.A; the first barrier below publishes it.
// m0 and m_end are the same for the whole block, so every thread reaches
// every barrier.
template <typename T, int BN>
__device__ void gcn_tile(float (&acc)[4][4], const T* __restrict__ x,
                         const T* __restrict__ W, const TileSmem<BN>& s,
                         long long row_base, long long row_lo,
                         long long row_hi, int m0, int m_end, int V, int P,
                         int Cin, int Cout, int d0) {
  using G = Geo<BN>;
  const int tid = threadIdx.x;
  const int tx = tid % G::NX, ty = tid / G::NX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int m_last = imin(m0 + G::BM, m_end) - 1;
  if (m_last < m0) return;
  const int lr0 = m0 / V;                       // first local input row
  const int pairs = (m_last / V - lr0 + 1) * V;  // staged (row, joint) pairs

  for (int p = 0; p < P; ++p) {
    const float* Ap = s.A + p * V * V;
    for (int c0 = 0; c0 < Cin; c0 += kKC) {
      __syncthreads();  // the last step's readers are done with X, T, W
      for (int i = tid; i < pairs * kKC; i += kThreads) {
        const int k = i % kKC, rv = i / kKC;
        const long long row = row_base + lr0 + rv / V;
        const int c = c0 + k;
        float val = 0.f;
        if (row >= row_lo && row < row_hi && c < Cin)
          val = to_f(x[(row * V + rv % V) * Cin + c]);
        s.X[i] = val;
      }
      for (int i = tid; i < kKC * BN; i += kThreads) {
        const int n = i % BN, k = i / BN;
        const int c = c0 + k, d = d0 + n;
        s.W[i] = (c < Cin && d < Cout)
                     ? to_f(W[((long long)p * Cin + c) * Cout + d])
                     : 0.f;
      }
      __syncthreads();
      // aggregate: T[k][m] = sum_v x[r(m), v, c0 + k] * A[p, v, w(m)]
      for (int i = tid; i < kKC * G::BM; i += kThreads) {
        const int ml = i % G::BM, k = i / G::BM;
        const int m = m0 + ml;
        float t = 0.f;
        if (m <= m_last) {
          const float* xr = s.X + (m / V - lr0) * V * kKC + k;
          const int w = m % V;
          for (int v = 0; v < V; ++v) t += xr[v * kKC] * Ap[v * V + w];
        }
        s.T[i] = t;
      }
      __syncthreads();
      // channel mix: acc += T[:, rows] x W[:, cols] over this chunk
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(s.T + k * G::BM + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(s.W + k * BN + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }
}

}  // namespace stgx
