// Fused RT-ST-GCN layer core:
//   z[n,t] = gcn(x, A, W)[n,t] + beff        (zero for t < 0)
//   y[n,t] = sum_{j<K} z[n, t - j*s]
//
// Replaces stgx/ops/rt_fused.py:_fwd_kernel (launched by _fwd_call).
//
// Bound on the H100: operations, as for gcn_core.cu: the graph conv's
// 2*V*P*C_in*(V + C_out) flops a frame dwarf the read of x and the write of
// y, which are all the device memory the function needs.
//
// Design: gcn_core's tile with the bias in its epilogue, then one window
// pass. The TPU kernel walked time in order in a sequential grid and kept z
// in VMEM, carrying the last H = (K-1)*s frames of it from one time tile to
// the next. On the H100 two such designs were built and measured first, and
// both gave way:
//  * a block that walks a span of frames in order and keeps z of the last
//    H frames in a ring in shared memory lost to the unfused chain in both
//    types: the ring takes the shared memory a second block an SM would
//    need, and every span forms the graph conv of its H halo frames twice;
//  * the window moved onto the input (the graph conv is linear and acts on
//    each frame alone, so y = gcn(sum_j x[t - j*s]) + taps(t) * beff) was
//    the fastest, but its fp32 sums round differently from the unfused
//    chain's, and the first training step's gradients of the layers'
//    graph-conv weights, sums over 200,000 terms that cancel after
//    BatchNorm, came out as far from float64 as the all-plain run's, over
//    the tolerance the kernels are held to.
// So this kernel keeps the unfused chain's arithmetic and cuts its passes:
//  * the graph conv in gcn_core's tile (gcn_core.cuh) at gcn_core's
//    tiles, occupancy and order of sums, writing z = acc + beff once, in
//    fp32, to a workspace (the unfused chain writes z, then reads and
//    writes it again to add the bias);
//  * the window pass (window.cuh: window_pass, window_sum.cu's) sums each
//    output's K taps of z in fp32 in the order j = 0, 1, ... and writes y
//    once in x's type.
// In fp32 y has the bits of gcn_core, the bias add and window_sum; bf16
// keeps z and the window in fp32, as the TPU kernel did.
//
// Routes, as gcn_core.cu's: fp32 on CUDA-core FMAs; bf16 on mma.sync
// m16n8k16 with the aggregate rounded to bf16 before the mix.
//
// Tiles (index in the mode word, chosen on the host by ops/gcn_core.py:
// core_tile): gcn_core's, 64 x 256, 128 x 128, 128 x 64 and the narrow one.
#include "gcn_core.cuh"
#include "window.cuh"

namespace {

using namespace stgx;
using namespace stgx::gcn;
using mma::aligned16;
using mma::allow_smem;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    z_fma_kernel(const float* __restrict__ x, const float* __restrict__ A,
                 const float* __restrict__ W, const float* __restrict__ beff,
                 float* __restrict__ z, long long R, int V, int P, int Cin, int Cout, bool vec_x,
                 bool vec_w) {
  constexpr int NTX = BN / TN, MG = TM / 4, NG = TN / 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
  const long long M = R * V, m0 = (long long)blockIdx.x * BM;
  const int d0 = blockIdx.y * BN;
  const bool quad = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(beff) % 16 == 0;
  fma_tile<BM, BN, TM, TN>(
      x, A, W, M, m0, d0, V, P, Cin, Cout, vec_x, vec_w, smem_raw,
      [&](const float (&acc)[TM][TN]) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const long long m = m0 + (i / 4) * (BM / MG) + ty * 4 + i % 4;
          if (m >= M) continue;
          const float* be = beff + (m % V) * Cout;
          float* zr = z + m * Cout;
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int d = d0 + g * (BN / NG) + tx * 4;
            if (quad && d + 3 < Cout) {
              const float4 b = *reinterpret_cast<const float4*>(be + d);
              *reinterpret_cast<float4*>(zr + d) =
                  make_float4(acc[i][4 * g] + b.x, acc[i][4 * g + 1] + b.y,
                              acc[i][4 * g + 2] + b.z, acc[i][4 * g + 3] + b.w);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (d + j < Cout) zr[d + j] = acc[i][4 * g + j] + be[d + j];
            }
          }
        }
      });
}

template <int NR, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    z_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ A,
                 const bf16* __restrict__ W, const bf16* __restrict__ beff,
                 float* __restrict__ z, long long R, int V, int P, int Cin, int Cout, bool vec_x,
                 bool vec_w) {
  constexpr int TM = NR * kVPad / WM, TN = BN / WN, MT = TM / 16, NT = TN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, wm = warp / WN, wn = warp % WN;
  const long long r0 = (long long)blockIdx.x * NR;
  const int d0 = blockIdx.y * BN;
  const bool pair = Cout % 2 == 0;
  mma_tile<NR, BN, WM, WN>(
      x, A, W, R, r0, d0, V, P, Cin, Cout, vec_x, vec_w, smem_raw,
      [&](const float (&acc)[MT][NT][4]) {
        // rows m = (r, w) with w < V and r < R, columns d < C_out
        const int g = mma::lane_id() >> 2, tq = mma::lane_id() & 3;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = wm * TM + i * 16 + g + 8 * h;
            const long long r = r0 + m / kVPad;
            const int w = m % kVPad;
            if (r >= R || w >= V) continue;
            const bf16* be = beff + w * Cout;
            float* zr = z + (r * V + w) * Cout;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int d = d0 + wn * TN + j * 8 + 2 * tq;
              if (pair && d + 1 < Cout) {
                const float2 b =
                    __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(be + d));
                *reinterpret_cast<float2*>(zr + d) =
                    make_float2(acc[i][j][2 * h] + b.x, acc[i][j][2 * h + 1] + b.y);
              } else {
                if (d < Cout) zr[d] = acc[i][j][2 * h] + to_f(be[d]);
                if (d + 1 < Cout) zr[d + 1] = acc[i][j][2 * h + 1] + to_f(be[d + 1]);
              }
            }
          }
      });
}

template <int BM, int BN, int TM, int TN>
int launch_fma(const void* x, const void* A, const void* W, const void* beff, float* z,
               long long R, int V, int P, int Cin, int Cout, cudaStream_t stream) {
  auto kernel = z_fma_kernel<BM, BN, TM, TN>;
  const size_t smem = FmaSmem<BM, BN>::bytes(P);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (R * V + BM - 1) / BM;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN)), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(A), static_cast<const float*>(W),
      static_cast<const float*>(beff), z, R, V, P, Cin, Cout, Cin % 4 == 0 && aligned16(x),
      Cout % 4 == 0 && aligned16(W));
  return (int)cudaGetLastError();
}

template <int NR, int BN, int WM, int WN>
int launch_mma(const void* x, const void* A, const void* W, const void* beff, float* z,
               long long R, int V, int P, int Cin, int Cout, cudaStream_t stream) {
  auto kernel = z_mma_kernel<NR, BN, WM, WN>;
  const size_t smem = MmaSmem<NR, BN>::bytes(P);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (R + NR - 1) / NR;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, (unsigned)((Cout + BN - 1) / BN)), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(A), static_cast<const bf16*>(W),
      static_cast<const bf16*>(beff), z, R, V, P, Cin, Cout, Cin % 8 == 0 && aligned16(x),
      Cout % 8 == 0 && aligned16(W));
  return (int)cudaGetLastError();
}

// z = gcn(x) + beff for the tile of the mode word.
int z_pass(int dtype, int tile, const void* x, const void* A, const void* W, const void* beff,
           float* z, long long R, int V, int P, int Cin, int Cout, cudaStream_t s) {
  switch (dtype << 8 | tile) {
    case 0: return launch_fma<64, 256, 8, 8>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 1: return launch_fma<128, 128, 8, 8>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 2: return launch_fma<128, 64, 8, 4>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 3: return launch_fma<64, 64, 4, 4>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 256: return launch_mma<2, 256, 2, 4>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 257: return launch_mma<4, 128, 2, 4>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 258: return launch_mma<4, 64, 4, 2>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
    case 259: return launch_mma<1, 64, 2, 4>(x, A, W, beff, z, R, V, P, Cin, Cout, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (N, L, V, Cin), A (P, V, V), W (P, Cin, Cout), beff (V, Cout) ->
// y (N, L, V, Cout), all contiguous and of one type. K taps spaced stride
// frames apart. z is an fp32 workspace of N * L * V * Cout floats. `mode`
// holds the type in its low byte (0 = float32, 1 = bfloat16) and the tile
// above it (0-3, as gcn_core's). Returns the CUDA error of the launches (0
// on success).
extern "C" int stgx_rt_fused(const void* x, const void* A, const void* W,
                             const void* beff, void* y, float* z, int N, int L, int V,
                             int P, int Cin, int Cout, int K, int stride,
                             int mode, int chunk, void* stream) {
  const long long R = (long long)N * L;
  const int dtype = mode & 0xff, tile = mode >> 8;
  if (N <= 0 || L <= 0 || R > 2147483647LL || V < 1 || V > stgx::kMaxV || P < 1 ||
      P > stgx::kMaxP || Cin < 1 || Cout < 1 || K < 1 || stride < 1 || dtype > 1 ||
      tile < 0 || tile > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = z_pass(dtype, tile, x, A, W, beff, z, R, V, P, Cin, Cout, s);
  if (e != 0) return e;
  const long long Q = (long long)V * Cout;
  if (dtype == 0)
    return (int)window_pass<float, float>(z, 1, static_cast<float*>(y), nullptr, N, L, Q, K,
                                          stride, false, chunk, s);
  return (int)window_pass<float, bf16>(z, 1, static_cast<bf16*>(y), nullptr, N, L, Q, K, stride,
                                       false, chunk, s);
}
