// Graph-conv core  y[r,w,d] = sum_{p,v,c} x[r,v,c] * A[p,v,w] * W[p,c,d].
//
// Replaces stgx/ops/pallas_gcn.py:_kernel (launched by _core_fwd_impl).
//
// Bound on the H100: operations. A row r costs 2*V*P*C_in*(V + C_out)
// flops against (C_in + C_out)*V values moved, 65-210 flops a byte in fp32
// at the main path's widths: above the card's 20 for fp32 FMAs (67 TFLOP/s
// over 3.35 TB/s); in bf16 (989 TFLOP/s on the tensor cores, 2 bytes a
// value) near its balance point of ~300. The batch form has R = N*L rows;
// the streaming cell has R = B streams, down to R = 1, where the W read
// (P*C_in*C_out values) and the launch dominate.
//
// Design, both routes: the aggregate first, in the tile that this kernel
// and rt_fused.cu share (gcn_core.cuh). A block owns one tile of
// output rows m = (r, w) and BN output columns, up to 256: all of C_out on
// the main path, so the aggregate is formed once for all of them. It steps
// over (partition p, C_in chunk); per step it
//  * stages the chunk's x rows and the W_p chunk with cp.async, double
//    buffered, so the next step's copies run under this step's products;
//  * forms the aggregate T_p[(r, w), c] = sum_v x[r, v, c] A[p, v, w] for
//    its rows into shared memory;
//  * adds T_p W_p (rows x chunk by chunk x BN) into the block's registers.
// T never reaches device memory: the kernel reads x and W and writes y.
//
// Routes:
//  * fp32, core_fma_kernel: both products on the CUDA cores in fp32 FMAs,
//    8 x 8 outputs a thread (4 x 4 in the narrow tile) from float4 shared
//    loads (4 loads to 64 FMAs), rows m dense (no joint padding). Its sums
//    run in one fixed order (T over v from zero, y over (p, c) in one
//    chain), so it gives the same bits as rt_fused's graph conv. The three-pass TF32 split on the tensor cores was tried
//    first: it held the kernel-vs-plain tolerance, but the tensor cores
//    round their adds toward zero, and on RT-ST-GCN's activations (x >= 0
//    after a ReLU, A >= 0) its first-step gradients came out 6.9e-4 from
//    float64 (layers.7.gcn.kernel, over the 5e-4 tolerance) where these
//    FMAs give 1.6e-4 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//  * bf16, core_mma_kernel: both products on the tensor cores, mma.sync
//    m16n8k16 (mma.cuh), one pass, fp32 sums; each row's V <= 32 joints
//    padded to 32 (two 16-row tiles). T is rounded to bf16 before the mix,
//    as the TPU kernel's second dot_general did under default precision
//    (pallas_gcn.py:81-86).
//
// Tiles (chosen by the wrapper, ops/gcn_core.py:core_tile): three wide
// tiles of 64 x 256, 128 x 128 and 128 x 64 rows m x columns, by C_out,
// and a narrow one for small R (the streaming cell), where the wide tiles
// would leave most of the card idle: 64 x 64 in fp32, 32 x 64 (one row r)
// in bf16.
#include "gcn_core.cuh"

namespace {

using namespace stgx;
using namespace stgx::gcn;
using mma::aligned16;
using mma::allow_smem;

// ------------------------------------------------------------ fp32, FMAs

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    core_fma_kernel(const float* __restrict__ x, const float* __restrict__ A,
                    const float* __restrict__ W, float* __restrict__ y, long long R,
                    int V, int P, int Cin, int Cout, bool vec_x, bool vec_w) {
  constexpr int NTX = BN / TN, MG = TM / 4, NG = TN / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
  const long long M = R * V, m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * BN;
  const bool quad = Cout % 4 == 0;
  fma_tile<BM, BN, TM, TN>(
      x, A, W, M, m0, d0, V, P, Cin, Cout, vec_x, vec_w, smem_raw,
      [&](const float (&acc)[TM][TN]) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long m = m0 + (i / 4) * (BM / MG) + ty * 4 + i % 4;
          if (m >= M) continue;
          float* yr = y + m * Cout;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int d = d0 + g * (BN / NG) + tx * 4;
            if (quad && d + 3 < Cout) {
              *reinterpret_cast<float4*>(yr + d) = make_float4(
                  acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (d + j < Cout) yr[d + j] = acc[i][4 * g + j];
            }
          }
        }
      });
}

template <int BM, int BN, int TM, int TN>
int launch_fma(const void* x, const void* A, const void* W, void* y, long long R, int V,
               int P, int Cin, int Cout, cudaStream_t stream) {
  auto kernel = core_fma_kernel<BM, BN, TM, TN>;
  const size_t smem = FmaSmem<BM, BN>::bytes(P);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (R * V + BM - 1) / BM;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN)), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(A), static_cast<const float*>(W),
      static_cast<float*>(y), R, V, P, Cin, Cout, Cin % 4 == 0 && aligned16(x),
      Cout % 4 == 0 && aligned16(W));
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16, mma.sync

template <int NR, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    core_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ A,
                    const bf16* __restrict__ W, bf16* __restrict__ y, long long R, int V,
                    int P, int Cin, int Cout, bool vec_x, bool vec_w) {
  constexpr int TM = NR * kVPad / WM, TN = BN / WN, MT = TM / 16, NT = TN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const long long r0 = (long long)blockIdx.x * NR;
  const int d0 = blockIdx.y * BN;
  mma_tile<NR, BN, WM, WN>(
      x, A, W, R, r0, d0, V, P, Cin, Cout, vec_x, vec_w, smem_raw,
      [&](const float (&acc)[MT][NT][4]) {
        // rows m = (r, w) with w < V and r < R, columns d < C_out
        const int g = mma::lane_id() >> 2, tq = mma::lane_id() & 3;
        const bool pair = Cout % 2 == 0;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = wm * TM + i * 16 + g + 8 * h;
            const long long r = r0 + m / kVPad;
            const int w = m % kVPad;
            if (r >= R || w >= V) continue;
            bf16* yr = y + (r * V + w) * Cout;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int d = d0 + wn * TN + j * 8 + 2 * tq;
              const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
              if (pair && d + 1 < Cout) {
                *reinterpret_cast<__nv_bfloat162*>(yr + d) = __floats2bfloat162_rn(v0, v1);
              } else {
                if (d < Cout) yr[d] = __float2bfloat16(v0);
                if (d + 1 < Cout) yr[d + 1] = __float2bfloat16(v1);
              }
            }
          }
      });
}

template <int NR, int BN, int WM, int WN>
int launch_mma(const void* x, const void* A, const void* W, void* y, long long R, int V,
               int P, int Cin, int Cout, cudaStream_t stream) {
  auto kernel = core_mma_kernel<NR, BN, WM, WN>;
  const size_t smem = MmaSmem<NR, BN>::bytes(P);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (R + NR - 1) / NR;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN)), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(A), static_cast<const bf16*>(W),
      static_cast<bf16*>(y), R, V, P, Cin, Cout, Cin % 8 == 0 && aligned16(x),
      Cout % 8 == 0 && aligned16(W));
  return (int)cudaGetLastError();
}

}  // namespace

// x (R, V, Cin), A (P, V, V), W (P, Cin, Cout) -> y (R, V, Cout), all
// contiguous and of one type. `mode` holds the type in its low byte (0 =
// float32, 1 = bfloat16) and the tile above it (0-3: rows m x columns
// 64 x 256, 128 x 128, 128 x 64, and the narrow 64 x 64 in fp32, 32 x 64 in
// bf16). Returns the CUDA error of the launch (0 on success).
extern "C" int stgx_gcn_core(const void* x, const void* A, const void* W,
                             void* y, long long R, int V, int P, int Cin,
                             int Cout, int mode, void* stream) {
  if (R <= 0 || V < 1 || V > stgx::kMaxV || P < 1 || P > stgx::kMaxP ||
      Cin < 1 || Cout < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dtype = mode & 0xff, tile = mode >> 8;
  if (dtype == 0) {
    switch (tile) {
      case 0: return launch_fma<64, 256, 8, 8>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 1: return launch_fma<128, 128, 8, 8>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 2: return launch_fma<128, 64, 8, 4>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 3: return launch_fma<64, 64, 4, 4>(x, A, W, y, R, V, P, Cin, Cout, s);
    }
  } else if (dtype == 1) {
    switch (tile) {
      case 0: return launch_mma<2, 256, 2, 4>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 1: return launch_mma<4, 128, 2, 4>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 2: return launch_mma<4, 64, 4, 2>(x, A, W, y, R, V, P, Cin, Cout, s);
      case 3: return launch_mma<1, 64, 2, 4>(x, A, W, y, R, V, P, Cin, Cout, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* stgx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
