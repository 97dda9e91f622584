// Fused RT-ST-GCN layer core:
//   z[n,t] = gcn(x, A, W)[n,t] + beff        (zero for t < 0)
//   y[n,t] = sum_{j<K} z[n, t - j*s]
// in one pass, with z kept in shared memory.
//
// Replaces stgx/ops/rt_fused.py:_fwd_kernel (launched by _fwd_call).
//
// Bound on the H100: operations, as for gcn_core.cu: the graph conv's
// 2*V*P*C_in*(V + C_out) flops a frame dwarf the read of x and the write of
// y, which are all the device memory this kernel touches.
//
// Design: recompute the halo. The TPU kernel walked time in order and
// carried the last (K-1)*s frames of z from one grid step to the next;
// blocks on the H100 run in no order, so nothing can be carried. A block
// owns (n, a tile of TT frames, a chunk of BN output channels). It computes
// z for its TT frames and for the H = (K-1)*s frames before them into
// shared memory (frames before t = 0 are zero, not beff, so the empty-FIFO
// start stays exact), then writes the window-sum of its TT frames, summed in
// fp32 before the cast to the output type. The recomputed halo costs H / TT
// more graph-conv work (8 / 32 at Gamma = 9, s = 1) and buys independent
// blocks. TT and BN are picked on the host so that z fits in shared memory.
#include "common.cuh"

namespace {

constexpr int kMaxTT = 32;

template <typename T, int BN>
__global__ void __launch_bounds__(stgx::kThreads)
    rt_fused_kernel(const T* __restrict__ x, const T* __restrict__ A,
                    const T* __restrict__ W, const T* __restrict__ beff,
                    T* __restrict__ y, int L, int V, int P, int Cin, int Cout,
                    int K, int stride, int TT) {
  using G = stgx::Geo<BN>;
  extern __shared__ __align__(16) float smem[];
  const stgx::TileSmem<BN> s(smem, P, V);
  float* Z = s.end;  // (TT + H frames, V, BN), fp32
  stgx::load_adjacency(s.A, A, P * V * V);

  const int H = (K - 1) * stride;
  const int t0 = blockIdx.x * TT;
  const int d0 = blockIdx.y * BN;
  const long long n = blockIdx.z;
  const long long row_lo = n * L, row_hi = row_lo + L;
  const long long row_base = row_lo + t0 - H;  // input row of local frame 0
  // local frames f hold t = t0 - H + f; only t < L is ever read
  const int frames = stgx::imin(TT + H, L - t0 + H);
  const int m_end = frames * V;
  const int tx = threadIdx.x % G::NX, ty = threadIdx.x / G::NX;

  for (int m0 = 0; m0 < m_end; m0 += G::BM) {
    float acc[4][4];
    stgx::gcn_tile<T, BN>(acc, x, W, s, row_base, row_lo, row_hi, m0, m_end,
                          V, P, Cin, Cout, d0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= m_end) continue;
      const int t = t0 - H + m / V, w = m % V;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dl = tx * 4 + j, d = d0 + dl;
        float z = 0.f;
        if (t >= 0 && d < Cout) z = acc[i][j] + stgx::to_f(beff[w * Cout + d]);
        Z[m * BN + dl] = z;
      }
    }
  }
  __syncthreads();

  const int tt_n = stgx::imin(TT, L - t0);
  for (int i = threadIdx.x; i < tt_n * V * BN; i += stgx::kThreads) {
    const int dl = i % BN, rest = i / BN;
    const int w = rest % V, tt = rest / V;
    const int d = d0 + dl;
    if (d >= Cout) continue;
    float acc = 0.f;
    for (int j = 0; j < K; ++j) acc += Z[((H + tt - j * stride) * V + w) * BN + dl];
    y[((row_lo + t0 + tt) * V + w) * Cout + d] = stgx::from_f<T>(acc);
  }
}

// Frames of time tile the shared memory leaves room for at column chunk BN.
template <int BN>
int pick_tile(int L, int V, int P, int H) {
  const long long tile = stgx::tile_smem_floats<BN>(P, V) * (long long)sizeof(float);
  const long long per_frame = (long long)V * BN * sizeof(float);
  const long long frames = (stgx::kMaxSmem - tile) / per_frame;
  return (int)stgx::lmin(stgx::imin(kMaxTT, L), frames - H);
}

template <typename T, int BN>
int launch(const void* x, const void* A, const void* W, const void* beff,
           void* y, int N, int L, int V, int P, int Cin, int Cout, int K,
           int stride, int TT, cudaStream_t stream) {
  const int H = (K - 1) * stride;
  const size_t smem = (stgx::tile_smem_floats<BN>(P, V) +
                       (size_t)(TT + H) * V * BN) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rt_fused_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((L + TT - 1) / TT),
                  (unsigned)((Cout + BN - 1) / BN), (unsigned)N);
  rt_fused_kernel<T, BN><<<grid, stgx::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(A),
      static_cast<const T*>(W), static_cast<const T*>(beff),
      static_cast<T*>(y), L, V, P, Cin, Cout, K, stride, TT);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* A, const void* W, const void* beff,
             void* y, int N, int L, int V, int P, int Cin, int Cout, int K,
             int stride, cudaStream_t stream) {
  const int H = (K - 1) * stride;
  // prefer 32-wide column chunks; narrow to 16 when a long halo leaves
  // room for too few frames
  const int tt32 = pick_tile<32>(L, V, P, H);
  if (tt32 >= stgx::imin(8, L))
    return launch<T, 32>(x, A, W, beff, y, N, L, V, P, Cin, Cout, K, stride,
                         tt32, stream);
  const int tt16 = pick_tile<16>(L, V, P, H);
  if (tt16 >= 1)
    return launch<T, 16>(x, A, W, beff, y, N, L, V, P, Cin, Cout, K, stride,
                         tt16, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (N, L, V, Cin), A (P, V, V), W (P, Cin, Cout), beff (V, Cout) ->
// y (N, L, V, Cout), all contiguous and of one type: dtype 0 = float32,
// 1 = bfloat16. K taps spaced stride frames apart. Returns the CUDA error of
// the launch (0 on success); cudaErrorInvalidValue if the halo leaves no
// room in shared memory.
extern "C" int stgx_rt_fused(const void* x, const void* A, const void* W,
                             const void* beff, void* y, int N, int L, int V,
                             int P, int Cin, int Cout, int K, int stride,
                             int dtype, void* stream) {
  if (N <= 0 || N > 65535 || L <= 0 || V < 1 || V > stgx::kMaxV || P < 1 ||
      P > stgx::kMaxP || Cin < 1 || Cout < 1 || K < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, A, W, beff, y, N, L, V, P, Cin, Cout, K, stride,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, A, W, beff, y, N, L, V, P, Cin, Cout, K,
                                   stride, s);
  return (int)cudaErrorInvalidValue;
}
