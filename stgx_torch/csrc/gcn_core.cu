// Graph-conv core  y[r,w,d] = sum_{p,v,c} x[r,v,c] * A[p,v,w] * W[p,c,d].
//
// Replaces stgx/ops/pallas_gcn.py:_kernel (launched by _core_fwd_impl).
//
// Bound on the H100: operations. At the main path's widths a row r costs
// 2*V*P*C_in*(V + C_out) flops against (C_in + C_out)*V values moved, some
// 65-210 flops a byte in fp32, far above the card's 20 flops a byte for
// fp32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s). The batch form has R = N*L rows; the
// streaming cell has R = B streams, down to R = 1, where the W read
// (3*C_in*C_out values) and the launch dominate.
//
// Design: one block owns a 64 x 64 tile of the flattened output
// (m = (r, w), d). Per (partition, 16-channel chunk) it stages the x rows
// the tile touches and a 16 x 64 slice of W in shared memory, forms the
// aggregate T = x^T A_p there in fp32, and adds T x W into a 4 x 4 register
// tile per thread (common.cuh). Neither T nor any P-expanded intermediate
// reaches device memory: the kernel reads x and W and writes y. W is read
// through L2 chunk by chunk (768 KB fp32 at 256 x 256 x 3 does not fit in
// shared memory). Plain fp32 FMAs, no tensor cores: right first, fast later.
#include "common.cuh"

namespace {

constexpr int kBN = 64;

template <typename T>
__global__ void __launch_bounds__(stgx::kThreads)
    gcn_core_kernel(const T* __restrict__ x, const T* __restrict__ A,
                    const T* __restrict__ W, T* __restrict__ y, long long R,
                    int V, int P, int Cin, int Cout) {
  using G = stgx::Geo<kBN>;
  extern __shared__ __align__(16) float smem[];
  const stgx::TileSmem<kBN> s(smem, P, V);
  stgx::load_adjacency(s.A, A, P * V * V);

  // local rows m count from the block's first input row, so they stay small
  const long long gm0 = (long long)blockIdx.x * G::BM;
  const long long row_base = gm0 / V;
  const int m0 = (int)(gm0 - row_base * V);
  const long long m_total = (R - row_base) * V;
  const int m_end = (int)stgx::lmin(m0 + G::BM, m_total);
  const int d0 = blockIdx.y * kBN;

  float acc[4][4];
  stgx::gcn_tile<T, kBN>(acc, x, W, s, row_base, 0, R, m0, m_end, V, P, Cin,
                         Cout, d0);

  const int tx = threadIdx.x % G::NX, ty = threadIdx.x / G::NX;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_end) continue;
    const long long gm = row_base * V + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tx * 4 + j;
      if (d < Cout) y[gm * Cout + d] = stgx::from_f<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* A, const void* W, void* y, long long R,
           int V, int P, int Cin, int Cout, cudaStream_t stream) {
  using G = stgx::Geo<kBN>;
  const size_t smem = stgx::tile_smem_floats<kBN>(P, V) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gcn_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((R * V + G::BM - 1) / G::BM),
                  (unsigned)((Cout + kBN - 1) / kBN));
  gcn_core_kernel<T><<<grid, stgx::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(A),
      static_cast<const T*>(W), static_cast<T*>(y), R, V, P, Cin, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, V, Cin), A (P, V, V), W (P, Cin, Cout) -> y (R, V, Cout), all
// contiguous and of one type: dtype 0 = float32, 1 = bfloat16. Returns the
// CUDA error of the launch (0 on success).
extern "C" int stgx_gcn_core(const void* x, const void* A, const void* W,
                             void* y, long long R, int V, int P, int Cin,
                             int Cout, int dtype, void* stream) {
  if (R <= 0 || V < 1 || V > stgx::kMaxV || P < 1 || P > stgx::kMaxP ||
      Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, A, W, y, R, V, P, Cin, Cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, A, W, y, R, V, P, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* stgx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
