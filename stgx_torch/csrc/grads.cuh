// The backward kernels of rt_fused_bwd.cu, which alone uses this header
// (gcn_grads.cu has tensor-core kernels of its own): the parameter
// gradients of the graph conv
//
//   y[r,w,d] = sum_{p,v,c} x[r,v,c] * A[p,v,w] * W[p,c,d]
//
// taken against a row gradient G (R, V, C_out): the anti-causal window-sum
// gy[r] = sum_{j<taps} g[r + j*stride] within each sequence of L rows of
// the upstream gradient g (g itself for taps = 1). G is formed from g as it is staged into shared memory and
// never reaches device memory.
//
//   gW[p,c,d] = sum_{r,w} T_p[(r,w),c] * G[(r,w),d],
//               T_p[(r,w),c] = sum_v x[r,v,c] * A[p,v,w]
//   gA[p,v,w] = sum_{r,c} x[r,v,c] * U_p[(r,w),c],
//               U_p[(r,w),c] = sum_d G[(r,w),d] * W[p,c,d]
//   gx[r,v,c] = sum_{p,w} A[p,v,w] * U_p[(r,w),c]        (rt_fused_bwd only)
//   gbe[w,d]  = sum_r G[(r,w),d]                          (rt_fused_bwd only)
//
// Both sums run over all R rows into small fp32 outputs. The TPU kernels
// carried them in VMEM across a sequential grid; blocks on the H100 run in
// no order, so each block sums its own split of the rows into an fp32
// partial in a workspace the wrapper allocates, and a second pass adds the
// partials in split order. No atomics: the result is the same run to run.
//
// Two kernels do the work:
//  * gw_partial: one block per (64 x 64 tile of (c, d), row split). It steps
//    over its rows kRBw input rows at a time, stages x and G for them once,
//    and for each partition forms T_p in shared memory and adds T_p^T G
//    into a 4 x 4 register tile per thread and partition. It also sums G's
//    columns for gbe.
//  * ga_partial: one block per (64-wide tile of c, row split). It steps over
//    its rows a few input rows at a time (at most 64 (row, joint) pairs),
//    stages x and all of G for them, and for each partition forms the tile
//    U_p = G W_p^T (a product of depth C_out in 16-deep chunks) in
//    registers, then in shared memory. From U_p it adds x^T U_p into gA
//    partials held in registers (each thread owns up to 4 (v, w) pairs)
//    and, for rt_fused_bwd, A_p U_p into the gx tile, which is written once
//    per step in x's type.
// Everything is summed in fp32; inputs may be fp32 or bf16.
#pragma once

#include "common.cuh"

namespace stgx {
namespace {

constexpr int kGT = 64;        // tile edge of the grads kernels
constexpr int kGLD = kGT + 1;  // padded row of the ga tiles (no bank clash)
constexpr int kRBw = 4;        // input rows per step of gw_partial
constexpr int kPairs = (kMaxV * kMaxV + kThreads - 1) / kThreads;  // 4
constexpr int kBeCols = (kMaxV * kGT + kThreads - 1) / kThreads;   // 8

// G[r, inner] for row r of (R, V*C_out) g, whose frame in its sequence of
// L rows is t: g itself for taps = 1, else the anti-causal window-sum over
// the taps that stay inside the sequence, summed in fp32 in the order
// j = 0, 1, ...
template <typename T>
__device__ __forceinline__ float grad_row(const T* __restrict__ g, long long r,
                                          int t, long long inner,
                                          long long row_len, int L, int taps,
                                          int stride) {
  const T* gr = g + r * row_len + inner;
  const long long hop = (long long)stride * row_len;
  float s = 0.f;
  for (int j = 0; j < taps && t + j * stride < L; ++j) s += to_f(gr[j * hop]);
  return s;
}

// Frame of each of a step's rows in its sequence (one 64-bit division a
// row, not one an element), into rt[0..nr). The caller syncs before use.
__device__ __forceinline__ void row_frames(int* rt, long long r0, int nr,
                                           int L) {
  for (int i = threadIdx.x; i < nr; i += kThreads) rt[i] = (int)((r0 + i) % L);
}

// Shared-memory floats of gw_partial.
__host__ __device__ inline int gw_smem_floats(int P, int V) {
  return round4(P * V * V) + 3 * kRBw * V * kGT + kRBw;
}

// Two blocks an SM (the host's split counts assume it): at most 128
// registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    gw_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ A, float* __restrict__ ws,
                      float* __restrict__ ws_be, long long R,
                      long long rows_per_split, int V, int P, int Cin,
                      int Cout, int L, int taps, int stride) {
  extern __shared__ __align__(16) float smem[];
  const int ct_n = (Cin + kGT - 1) / kGT;
  const int c0 = (blockIdx.x % ct_n) * kGT;
  const int d0 = (blockIdx.x / ct_n) * kGT;
  const long long split = blockIdx.y;
  const int MS = kRBw * V;  // (row, joint) pairs a step stages
  float* As = smem;                    // (P, V, V)
  float* Xs = As + round4(P * V * V);  // (MS, kGT): x[r, v, c0 + cc]
  float* Ts = Xs + MS * kGT;           // (MS, kGT): T_p[(r, w), c0 + cc]
  float* Gs = Ts + MS * kGT;           // (MS, kGT): G[(r, w), d0 + dd]
  int* rt = reinterpret_cast<int*>(Gs + MS * kGT);  // (kRBw): row frames
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < P * V * V; i += kThreads) As[i] = to_f(A[i]);
  // the c-tile 0 blocks also sum G's columns for gbe
  const bool do_be = ws_be != nullptr && c0 == 0;
  float be[kBeCols];
#pragma unroll
  for (int k = 0; k < kBeCols; ++k) be[k] = 0.f;
  float acc[kMaxP][4][4];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][i][j] = 0.f;

  const long long row_len = (long long)V * Cout;
  const long long r_begin = split * rows_per_split;
  const long long r_end = lmin(r_begin + rows_per_split, R);
  for (long long r0 = r_begin; r0 < r_end; r0 += kRBw) {
    const int nr = (int)lmin(kRBw, r_end - r0);
    const int ms = nr * V;
    __syncthreads();  // the last step's readers are done with Xs, Ts, Gs
    row_frames(rt, r0, nr, L);
    __syncthreads();
    for (int i = tid; i < MS * kGT; i += kThreads) {
      const int cc = i % kGT, m = i / kGT;
      float xv = 0.f, gv = 0.f;
      if (m < ms) {
        const int rr = m / V, vw = m % V;
        const long long r = r0 + rr;
        if (c0 + cc < Cin) xv = to_f(x[(r * V + vw) * Cin + c0 + cc]);
        if (d0 + cc < Cout)
          gv = grad_row(g, r, rt[rr], (long long)vw * Cout + d0 + cc, row_len,
                        L, taps, stride);
      }
      Xs[i] = xv;
      Gs[i] = gv;
    }
    // x and G are staged once a step and serve every partition
#pragma unroll
    for (int p = 0; p < kMaxP; ++p) {
      if (p >= P) break;
      __syncthreads();  // staging visible; the last product's readers done
      // T_p[m][cc] = sum_v x[r(m), v, cc] * A[p, v, w(m)]
      const float* Ap = As + p * V * V;
      for (int i = tid; i < MS * kGT; i += kThreads) {
        const int cc = i % kGT, m = i / kGT;
        float t = 0.f;
        if (m < ms) {
          const float* xr = Xs + (m / V) * V * kGT + cc;
          const int w = m % V;
          for (int v = 0; v < V; ++v) t += xr[v * kGT] * Ap[v * V + w];
        }
        Ts[i] = t;
      }
      if (do_be && p == 0) {
#pragma unroll
        for (int k = 0; k < kBeCols; ++k) {
          const int e = tid + k * kThreads;
          float sum = 0.f;
          if (e < V * kGT)
            for (int rr = 0; rr < nr; ++rr)
              sum += Gs[(rr * V + e / kGT) * kGT + e % kGT];
          be[k] += sum;
        }
      }
      __syncthreads();
      // step = T_p[m, rows]^T x G[m, cols] over the step's pairs m, added
      // to acc once a step: two-level sums keep fp32 chains short (a split
      // may hold thousands of rows)
      float step[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
      for (int m = 0; m < ms; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(Ts + m * kGT + ty * 4);
        const float4 b = *reinterpret_cast<const float4*>(Gs + m * kGT + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) step[i][j] += av[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][i][j] += step[i][j];
    }
  }

#pragma unroll
  for (int p = 0; p < kMaxP; ++p) {
    if (p >= P) break;
    float* out = ws + (split * P + p) * (long long)Cin * Cout;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      if (c >= Cin) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + tx * 4 + j;
        if (d < Cout) out[(long long)c * Cout + d] = acc[p][i][j];
      }
    }
  }
  if (do_be) {
    float* ob = ws_be + split * (long long)V * Cout;
#pragma unroll
    for (int k = 0; k < kBeCols; ++k) {
      const int e = tid + k * kThreads;
      const int d = d0 + e % kGT;
      if (e < V * kGT && d < Cout) ob[(e / kGT) * Cout + d] = be[k];
    }
  }
}

// Input rows a ga_partial step takes: as many as keep (row, joint) pairs
// within one 64-row register tile.
__host__ __device__ inline int ga_rows(int V) { return V >= kGT ? 1 : kGT / V; }
__host__ __device__ inline int pad_kc(int n) { return (n + kKC - 1) / kKC * kKC; }

// Shared-memory floats of ga_partial.
__host__ __device__ inline int ga_smem_floats(int V, int P, int Cout, bool gx) {
  const int mb = ga_rows(V) * V;
  return round4(P * V * V) + round4(mb * kGLD) + mb * pad_kc(Cout) +
         kKC * kGT + round4(mb * kGLD) + (gx ? round4(mb * kGLD) : 0) + kGT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ A, const T* __restrict__ W,
                      float* __restrict__ ws_a, T* __restrict__ gx,
                      long long R, long long rows_per_split, int V, int P,
                      int Cin, int Cout, int L, int taps, int stride) {
  extern __shared__ __align__(16) float smem[];
  const int rb = ga_rows(V), mb = rb * V, cp = pad_kc(Cout);
  float* As = smem;                          // (P, V, V)
  float* Xs = As + round4(P * V * V);        // (mb, kGLD): x[r, v, c0 + cc]
  float* Gs = Xs + round4(mb * kGLD);        // (mb, cp): G[(r, w), d]
  float* Wc = Gs + mb * cp;                  // (kKC, kGT): W[p, c0 + cc, d]
  float* Us = Wc + kKC * kGT;                // (mb, kGLD): U_p[(r, w), c0 + cc]
  float* GXs = Us + round4(mb * kGLD);       // (mb, kGLD): gx tile
  int* rt = reinterpret_cast<int*>(GXs + (gx != nullptr ? round4(mb * kGLD) : 0));
  const int c0 = blockIdx.x * kGT;
  const long long split = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < P * V * V; i += kThreads) As[i] = to_f(A[i]);

  float ga[kMaxP][kPairs];
#pragma unroll
  for (int p = 0; p < kMaxP; ++p)
#pragma unroll
    for (int k = 0; k < kPairs; ++k) ga[p][k] = 0.f;

  const long long row_len = (long long)V * Cout;
  const long long r_begin = split * rows_per_split;
  const long long r_end = lmin(r_begin + rows_per_split, R);
  for (long long r0 = r_begin; r0 < r_end; r0 += rb) {
    const int nr = (int)lmin(rb, r_end - r0);
    const int ms = nr * V;
    __syncthreads();  // the last step's readers are done with every buffer
    row_frames(rt, r0, nr, L);
    __syncthreads();
    for (int i = tid; i < mb * kGT; i += kThreads) {
      const int cc = i % kGT, m = i / kGT;
      float xv = 0.f;
      if (m < ms && c0 + cc < Cin)
        xv = to_f(x[((r0 + m / V) * V + m % V) * Cin + c0 + cc]);
      Xs[m * kGLD + cc] = xv;
      if (gx != nullptr) GXs[m * kGLD + cc] = 0.f;
    }
    for (int i = tid; i < mb * cp; i += kThreads) {
      const int d = i % cp, m = i / cp;
      float gv = 0.f;
      if (m < ms && d < Cout)
        gv = grad_row(g, r0 + m / V, rt[m / V], (long long)(m % V) * Cout + d,
                      row_len, L, taps, stride);
      Gs[i] = gv;
    }

    for (int p = 0; p < P; ++p) {
      // U_p tile: acc[i][j] = sum_d G[m, d] * W[p, c, d], m = ty*4 + i,
      // c = c0 + tx*4 + j, over 16-deep chunks of d
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int dk = 0; dk < Cout; dk += kKC) {
        __syncthreads();  // staging visible; the last chunk's readers done
        for (int i = tid; i < kKC * kGT; i += kThreads) {
          const int k = i % kKC, cc = i / kKC;
          const int c = c0 + cc, d = dk + k;
          Wc[k * kGT + cc] =
              (c < Cin && d < Cout)
                  ? to_f(W[((long long)p * Cin + c) * Cout + d])
                  : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kKC; ++k) {
          const float4 b =
              *reinterpret_cast<const float4*>(Wc + k * kGT + tx * 4);
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = ty * 4 + i;
            const float a = m < mb ? Gs[m * cp + dk + k] : 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += a * bv[j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
        if (m >= mb) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) Us[m * kGLD + tx * 4 + j] = acc[i][j];
      }
      __syncthreads();
      // gA[p, v, w] += sum_{r, cc} x[r, v, cc] * U_p[(r, w), cc]
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int q = tid + k * kThreads;
        if (q >= V * V) continue;
        const int v = q / V, w = q % V;
        float s = 0.f;
        for (int rr = 0; rr < nr; ++rr) {
          const float* xr = Xs + (rr * V + v) * kGLD;
          const float* ur = Us + (rr * V + w) * kGLD;
          for (int cc = 0; cc < kGT; ++cc) s += xr[cc] * ur[cc];
        }
#pragma unroll
        for (int pp = 0; pp < kMaxP; ++pp)
          if (pp == p) ga[pp][k] += s;
      }
      // gx[r, v, cc] += sum_w A[p, v, w] * U_p[(r, w), cc]
      if (gx != nullptr) {
        const float* Ap = As + p * V * V;
        for (int i = tid; i < ms * kGT; i += kThreads) {
          const int cc = i % kGT, m = i / kGT;
          const int rr = m / V, v = m % V;
          const float* ur = Us + rr * V * kGLD + cc;
          float s = 0.f;
          for (int w = 0; w < V; ++w) s += Ap[v * V + w] * ur[w * kGLD];
          GXs[m * kGLD + cc] += s;
        }
      }
      // the next partition's first barrier orders these reads before Us
      // is written again
    }
    if (gx != nullptr) {
      __syncthreads();
      for (int i = tid; i < ms * kGT; i += kThreads) {
        const int cc = i % kGT, m = i / kGT;
        if (c0 + cc < Cin)
          gx[((r0 + m / V) * V + m % V) * Cin + c0 + cc] =
              from_f<T>(GXs[m * kGLD + cc]);
      }
    }
  }

  const long long blk = split * gridDim.x + blockIdx.x;
  for (int p = 0; p < P; ++p) {
    float* out = ws_a + (blk * P + p) * (long long)V * V;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int q = tid + k * kThreads;
      if (q < V * V) out[q] = ga[p][k];
    }
  }
}

// out[i] = sum_{s < S} ws[s, i], in split order.
__global__ void __launch_bounds__(kThreads)
    reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                         int S, long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

inline cudaError_t reduce_splits(const float* ws, float* out, int S,
                                 long long n, cudaStream_t stream) {
  const long long blocks = lmin((n + kThreads - 1) / kThreads, 1024);
  reduce_splits_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(ws, out, S,
                                                                   n);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The whole backward: the two partial-sum kernels, then the reductions.
// ws_w holds splits_w * P * Cin * Cout floats, ws_a splits_a * ceil(Cin/64)
// * P * V * V, ws_be (when gbe is set) splits_w * V * Cout. gx and gbe may
// be null.
template <typename T>
int grads(const void* x, const void* g, const void* A, const void* W,
          void* gx, float* gA, float* gW, float* gbe, float* ws_w,
          float* ws_a, float* ws_be, long long R, int V, int P, int Cin,
          int Cout, int L, int taps, int stride, int splits_w, int splits_a,
          cudaStream_t stream) {
  const int ct_n = (Cin + kGT - 1) / kGT, dt_n = (Cout + kGT - 1) / kGT;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* At = static_cast<const T*>(A);
  const T* Wt = static_cast<const T*>(W);

  const size_t smem_w = gw_smem_floats(P, V) * sizeof(float);
  cudaError_t e = allow_smem(gw_partial_kernel<T>, smem_w);
  if (e != cudaSuccess) return (int)e;
  const long long rows_w = (R + splits_w - 1) / splits_w;
  gw_partial_kernel<T><<<dim3(ct_n * dt_n, splits_w), kThreads, smem_w,
                         stream>>>(xt, gt, At, ws_w, gbe ? ws_be : nullptr, R,
                                   rows_w, V, P, Cin, Cout, L, taps, stride);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t smem_a = ga_smem_floats(V, P, Cout, gx != nullptr) * sizeof(float);
  if ((e = allow_smem(ga_partial_kernel<T>, smem_a)) != cudaSuccess)
    return (int)e;
  const long long rows_a = (R + splits_a - 1) / splits_a;
  ga_partial_kernel<T><<<dim3(ct_n, splits_a), kThreads, smem_a, stream>>>(
      xt, gt, At, Wt, ws_a, static_cast<T*>(gx), R, rows_a, V, P, Cin, Cout,
      L, taps, stride);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((e = reduce_splits(ws_w, gW, splits_w, (long long)P * Cin * Cout,
                         stream)) != cudaSuccess)
    return (int)e;
  if ((e = reduce_splits(ws_a, gA, splits_a * ct_n, (long long)P * V * V,
                         stream)) != cudaSuccess)
    return (int)e;
  if (gbe != nullptr &&
      (e = reduce_splits(ws_be, gbe, splits_w, (long long)V * Cout, stream)) !=
          cudaSuccess)
    return (int)e;
  return 0;
}

}  // namespace
}  // namespace stgx
