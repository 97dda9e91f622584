// The int8 products of the quantized streaming cells
// (stgx_torch/bench/quant.py::int8_matmul):
//
//   int8_gemm_kernel:  C[m,n] = float(sum_k A[m,k] * B[k,n]) * (s_a * s_b[n]) (+ bias[n]),
//                      A, B int8, the sum in int32;
//   w8_gemm_kernel:    C[m,n] = (sum_k X[m,k] * float(B[k,n])) * s_b[n] (+ bias[n]),
//                      X fp32, B int8 widened in registers, fp32 FMAs.
//
// Replaces stgx/bench/quant.py:199 (the int8 x int8 -> int32 dot_general of
// int8_matmul, XLA on the TPU's MXU; :189 for an int8 input that is already
// quantized) and :194 (the w8 dot_general with the weight widened inside
// it). Neither is a Pallas kernel; PyTorch has no int8 product behind
// torch.matmul on the card, and torch._int_mm (cuBLASLt) takes neither
// M <= 16 nor K or N off a multiple of 8, which the cells have (M = 1, K = 3,
// N = 52).
//
// Shapes of the cells: M = B * 25 rows (B for the classifier), K in {3, 64,
// 128, 192, 384, 768} and, for CoST-GCN's temporal conv, Gamma * C up to
// 69 * 256 = 17,664; N in {52, 64, 128, 256}.
//
// Bound on the H100: the larger of the bytes (A, B, C read or written once:
// M*K + K*N + 4*M*N for int8, 4*M*K + K*N + 4*M*N for w8) over 3.35 TB/s and
// 2*M*N*K operations over 1,979 TOP/s (int8 tensor cores) or 67 TFLOP/s
// (w8, fp32 FMAs). At B = 1 the weight's bytes bind both (M = 25); at
// B = 4096 int8 is still bytes-bound (K <= 768: at most 2*768 / 5 ~ 300
// operations a byte against the int8 ridge of ~590), w8 operations-bound.
//
// Design, right and simple first (wgmma and TMA are later work):
//  * int8: 64 x 64 output tiles, four warps of 32 x 32, each k step of 32 one
//    mma.sync m16n8k32 s8 per 16 x 8 piece; A and B staged 64 bytes of k at a
//    time in shared memory with cp.async, double buffered. B arrives
//    column-major (the weight layout quantize_* makes once: k contiguous in
//    each output column), which is the layout the B fragment wants, so both
//    operands stage as rows of k. A takes a row stride (a FIFO view needs no
//    copy). Ragged M, N and K (K = 3, N = 52) are zero-filled at staging.
//  * w8: 64 x 64 output tiles, 256 threads of 4 x 4 fp32 sums, 32 k a
//    stage; x staged transposed in shared memory, the weight widened from
//    int8 to fp32 as it is staged: no fp32 copy of the weight exists in
//    device memory.
//  * Few output tiles (small M) and a deep K would leave most SMs idle, so
//    the host (ops/int8_gemm.py::gemm_plan) splits K over up to `splits`
//    blocks; each writes its partial sums to a workspace and a second kernel
//    adds them in split order (int32 exact; fp32 in a fixed order, so a run
//    repeats bit for bit) and applies the epilogue.
//  * The epilogue rounds as the plain version does: s_a * s_b[n] in fp32,
//    then its product with float(acc), then + bias, each with __fmul_rn /
//    __fadd_rn, so that no FMA contracts them. s_a is read from device
//    memory (a 0-d tensor): no host value per call, so a quantize that
//    measures its scale on the device and a CUDA graph both work.
#include <stdint.h>

#include "mma.cuh"

namespace stgx {
namespace {

// ---------------------------------------------------------------- int8 x int8

constexpr int kI8BM = 64, kI8BN = 64, kI8BK = 64;  // tile; BK in bytes of k
constexpr int kI8Ld = kI8BK + 16;  // shared row length, 20 words: conflict-free fragments
constexpr int kI8Threads = 128;

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage rows [0, 64) x k [k0, k0 + 64) of a row-major int8 matrix (row i at
// base + i * ld) into dst; rows at or past `rows` and k at or past K are zero.
__device__ __forceinline__ void stage_i8(int8_t* dst, const int8_t* base, long long ld,
                                         int rows, int k0, int K, bool vec) {
  for (int i = threadIdx.x; i < kI8BM * (kI8BK / 16); i += kI8Threads) {
    const int r = i >> 2, c = (i & 3) * 16;
    int8_t* d = dst + r * kI8Ld + c;
    const int8_t* s = base + (long long)r * ld + k0 + c;
    if (vec) {  // K % 16 == 0: a 16-byte chunk is all in or all out
      const bool ok = r < rows && k0 + c < K;
      mma::cp_async16(d, ok ? s : base, ok);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + c + 4 * q + j;
          const uint32_t byte = (r < rows && k < K) ? (uint8_t)s[4 * q + j] : 0u;
          v |= byte << (8 * j);
        }
        w[q] = v;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ float i8_epilogue(int acc, float sa, const float* s_b,
                                             const float* bias, int n) {
  float y = __fmul_rn(__int2float_rn(acc), __fmul_rn(sa, s_b[n]));
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return y;
}

// grid (M tiles, N tiles, splits); split z sums k tiles [z*kper, (z+1)*kper).
__global__ void __launch_bounds__(kI8Threads) int8_gemm_kernel(
    const int8_t* __restrict__ A, long long lda, const int8_t* __restrict__ B, long long ldb,
    const float* __restrict__ s_a, const float* __restrict__ s_b,
    const float* __restrict__ bias, float* __restrict__ C, int* __restrict__ ws, int M,
    int N, int K, int kper) {
  __shared__ __align__(16) int8_t sA[2][kI8BM * kI8Ld];
  __shared__ __align__(16) int8_t sB[2][kI8BN * kI8Ld];
  const int m0 = blockIdx.x * kI8BM, n0 = blockIdx.y * kI8BN;
  const int rows_a = M - m0, rows_b = N - n0;
  const int8_t* a_base = A + (long long)m0 * lda;
  const int8_t* b_base = B + (long long)n0 * ldb;
  const bool vec_a = K % 16 == 0 && lda % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vec_b = K % 16 == 0 && ldb % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int ktiles = (K + kI8BK - 1) / kI8BK;
  const int kt0 = blockIdx.z * kper, kt1 = imin(ktiles, kt0 + kper);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4] = {};

  auto stage = [&](int buf, int kt) {
    stage_i8(sA[buf], a_base, lda, rows_a, kt * kI8BK, K, vec_a);
    stage_i8(sB[buf], b_base, ldb, rows_b, kt * kI8BK, K, vec_b);
  };
  if (kt0 < kt1) stage(0, kt0);
  mma::cp_async_commit();
  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) & 1;
    if (kt + 1 < kt1) stage(cur ^ 1, kt + 1);
    mma::cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int8_t* a_s = sA[cur];
    const int8_t* b_s = sB[cur];
#pragma unroll
    for (int ks = 0; ks < kI8BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = a_s + (wm + mi * 16 + g) * kI8Ld + ks + 4 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Ld);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kI8Ld + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = b_s + (wn + ni * 8 + g) * kI8Ld + ks + 4 * t;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma::mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  const float sa = ws == nullptr ? *s_a : 0.f;
  int* part = ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + g + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + 2 * t + j;
          if (n >= N) continue;
          const int v = acc[mi][ni][2 * h + j];
          if (part != nullptr)
            part[(long long)m * N + n] = v;
          else
            C[(long long)m * N + n] = i8_epilogue(v, sa, s_b, bias, n);
        }
      }
}

// The splits' int32 partials summed (exact in any order), then the epilogue.
__global__ void __launch_bounds__(kThreads) int8_splits_kernel(
    const int* __restrict__ ws, int splits, const float* __restrict__ s_a,
    const float* __restrict__ s_b, const float* __restrict__ bias, float* __restrict__ C,
    int M, int N) {
  const long long mn = (long long)M * N;
  const float sa = *s_a;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < mn;
       i += (long long)gridDim.x * kThreads) {
    int acc = 0;
    for (int z = 0; z < splits; ++z) acc += ws[z * mn + i];
    C[i] = i8_epilogue(acc, sa, s_b, bias, (int)(i % N));
  }
}

// ---------------------------------------------------------------- fp32 x int8

constexpr int kW8BM = 64, kW8BN = 64, kW8BK = 32;
constexpr int kW8Ld = kW8BM + 4;  // floats; rows of 16-byte groups

__device__ __forceinline__ float w8_epilogue(float acc, const float* s_b, const float* bias,
                                             int n) {
  float y = __fmul_rn(acc, s_b[n]);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return y;
}

// grid (M tiles, N tiles, splits), kThreads threads of 4 x 4 outputs.
__global__ void __launch_bounds__(kThreads) w8_gemm_kernel(
    const float* __restrict__ X, long long ldx, const int8_t* __restrict__ B, long long ldb,
    const float* __restrict__ s_b, const float* __restrict__ bias, float* __restrict__ C,
    float* __restrict__ ws, int M, int N, int K, int kper) {
  __shared__ __align__(16) float sX[kW8BK * kW8Ld];  // [k][m]
  __shared__ __align__(16) float sW[kW8BK * kW8Ld];  // [k][n], widened
  const int m0 = blockIdx.x * kW8BM, n0 = blockIdx.y * kW8BN;
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const bool vec_b = K % 8 == 0 && ldb % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 8 == 0;
  const int ktiles = (K + kW8BK - 1) / kW8BK;
  const int kt0 = blockIdx.z * kper, kt1 = imin(ktiles, kt0 + kper);
  float acc[4][4] = {};

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kW8BK;
    // x: 64 rows x 32 k, read along k (coalesced), stored [k][m]
#pragma unroll
    for (int q = 0; q < kW8BM * kW8BK / kThreads; ++q) {
      const int i = tid + q * kThreads, r = i / kW8BK, c = i % kW8BK;
      const int m = m0 + r, k = k0 + c;
      sX[c * kW8Ld + r] = (m < M && k < K) ? X[(long long)m * ldx + k] : 0.f;
    }
    // the weight: column n of 32 k, 8 bytes a thread, widened, stored [k][n]
    {
      const int r = tid >> 2, c = (tid & 3) * 8, n = n0 + r;
      const int8_t* s = B + (long long)n * ldb + k0 + c;
      int8_t v[8];
      if (vec_b && n < N && k0 + c < K) {
        *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(s);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (n < N && k0 + c + j < K) ? s[j] : (int8_t)0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sW[(c + j) * kW8Ld + r] = (float)v[j];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kW8BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sX + k * kW8Ld + 4 * tm);
      const float4 b = *reinterpret_cast<const float4*>(sW + k * kW8Ld + 4 * tn);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* part = ws == nullptr ? nullptr : ws + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n >= N) continue;
      if (part != nullptr)
        part[(long long)m * N + n] = acc[i][j];
      else
        C[(long long)m * N + n] = w8_epilogue(acc[i][j], s_b, bias, n);
    }
  }
}

// The splits' fp32 partials added in split order, then the epilogue.
__global__ void __launch_bounds__(kThreads) w8_splits_kernel(
    const float* __restrict__ ws, int splits, const float* __restrict__ s_b,
    const float* __restrict__ bias, float* __restrict__ C, int M, int N) {
  const long long mn = (long long)M * N;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < mn;
       i += (long long)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc = __fadd_rn(acc, ws[z * mn + i]);
    C[i] = w8_epilogue(acc, s_b, bias, (int)(i % N));
  }
}

int reduce_blocks(long long mn) {
  return (int)lmin((mn + kThreads - 1) / kThreads, 132LL * 16);
}

}  // namespace
}  // namespace stgx

// A (M, K) int8 with row stride lda; B (K, N) int8 column-major (column n at
// b + n * ldb); s_a one fp32 in device memory; s_b, bias (nullable) (N,) fp32;
// C (M, N) fp32 contiguous. splits > 1 needs ws, (splits, M, N) int32; split z
// takes the k tiles of 64 from z * kper. Returns the launch's CUDA error.
extern "C" int stgx_int8_gemm(const void* a, long long lda, const void* b, long long ldb,
                              const void* s_a, const void* s_b, const void* bias, void* c,
                              void* ws, int M, int N, int K, int splits, int kper,
                              void* stream) {
  using namespace stgx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || splits < 1 || (splits > 1 && ws == nullptr)) return 0;
  const dim3 grid((M + kI8BM - 1) / kI8BM, (N + kI8BN - 1) / kI8BN, splits);
  int8_gemm_kernel<<<grid, kI8Threads, 0, st>>>(
      static_cast<const int8_t*>(a), lda, static_cast<const int8_t*>(b), ldb,
      static_cast<const float*>(s_a), static_cast<const float*>(s_b),
      static_cast<const float*>(bias), static_cast<float*>(c),
      splits > 1 ? static_cast<int*>(ws) : nullptr, M, N, K, kper);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  int8_splits_kernel<<<reduce_blocks((long long)M * N), kThreads, 0, st>>>(
      static_cast<const int*>(ws), splits, static_cast<const float*>(s_a),
      static_cast<const float*>(s_b), static_cast<const float*>(bias), static_cast<float*>(c),
      M, N);
  return (int)cudaGetLastError();
}

// X (M, K) fp32 with row stride ldx; B, s_b, bias, C as above; ws (splits, M, N)
// fp32; split z takes the k tiles of 32 from z * kper.
extern "C" int stgx_w8_gemm(const void* x, long long ldx, const void* b, long long ldb,
                            const void* s_b, const void* bias, void* c, void* ws, int M, int N,
                            int K, int splits, int kper, void* stream) {
  using namespace stgx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || splits < 1 || (splits > 1 && ws == nullptr)) return 0;
  const dim3 grid((M + kW8BM - 1) / kW8BM, (N + kW8BN - 1) / kW8BN, splits);
  w8_gemm_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), ldx, static_cast<const int8_t*>(b), ldb,
      static_cast<const float*>(s_b), static_cast<const float*>(bias), static_cast<float*>(c),
      splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, kper);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  w8_splits_kernel<<<reduce_blocks((long long)M * N), kThreads, 0, st>>>(
      static_cast<const float*>(ws), splits, static_cast<const float*>(s_b),
      static_cast<const float*>(bias), static_cast<float*>(c), M, N);
  return (int)cudaGetLastError();
}
