// The int8 products of the quantized streaming cells on the shapes TMA
// cannot take (the "staged" route of ops/int8_gemm.py; int8_gemm_tma.cu is
// the route for every other shape):
//
//   int8_gemm_kernel:  C[m,n] = float(sum_k q(A)[m,k] * B[k,n]) * (s_a * s_b[n]) (+ bias[n]),
//                      B int8, A int8 codes or fp32 quantized as it is staged,
//                      the sum in int32;
//   w8_gemm_kernel:    C[m,n] = (sum_k X[m,k] * float(B[k,n])) * s_b[n] (+ bias[n]),
//                      X fp32, B int8 widened as it is staged, fp32 FMAs.
//
// A bf16 operand takes the tma route alone (the cells hand one only to
// CoST-GCN's temporal convs, whose rows TMA reads).
//
// Replaces stgx/bench/quant.py:199 (the int8 x int8 -> int32 dot_general of
// int8_matmul, XLA on the TPU's MXU; :189 for an int8 input that is already
// quantized) and :194 (the w8 dot_general with the weight widened inside
// it), where a row of A or of the weight is not a multiple of 16 bytes:
// the cells' fcn_in (K = 3) and ragged shapes. Neither is a Pallas kernel.
//
// Bound on the H100: the larger of the bytes (A, B, C read or written once)
// over 3.35 TB/s and 2*M*N*K operations over 1,979 TOP/s (int8 tensor
// cores) or 67 TFLOP/s (w8, fp32 FMAs). At fcn_in (K = 3) the output's
// bytes bind.
//
// Design, right and simple (the shapes it takes are small):
//  * int8: 64 x 64 output tiles, four warps of 32 x 32, each k step of 32 one
//    mma.sync m16n8k32 s8 per 16 x 8 piece; A and B staged 64 bytes of k at a
//    time in shared memory, double buffered (cp.async for int8 rows that are
//    16-byte aligned, else element by element, an fp32 A quantized
//    there: clamp(rint(x / s_a), -127, 127), IEEE division, half to even).
//    B arrives column-major (the weight layout quantize_* makes once: k
//    contiguous in each output column), the layout the B fragment wants.
//    Ragged M, N and K are zero-filled at staging.
//  * w8: 64 x 64 output tiles, 256 threads of 4 x 4 fp32 sums, 32 k a
//    stage; x staged transposed in shared memory, the weight widened from
//    int8 to fp32 as it is staged.
//  * One launch a call: K is not split on this route.
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

// The int8 code of one element of A: int8 as it is, fp32 quantized under
// sa.
__device__ __forceinline__ uint32_t code_of(int8_t v, float) { return (uint8_t)v; }
__device__ __forceinline__ uint32_t code_of(float v, float sa) {
  const int q = __float2int_rn(__fdiv_rn(v, sa));
  return (uint8_t)(int8_t)max(-127, min(127, q));
}

// Stage rows [0, 64) x k [k0, k0 + 64) of a row-major matrix (row i at
// base + i * ld elements) into dst as int8 codes; rows at or past `rows`
// and k at or past K are zero. `vec`: int8 rows 16-byte aligned, copied with
// cp.async.
template <typename T>
__device__ __forceinline__ void stage_i8(int8_t* dst, const T* base, long long ld, int rows,
                                         int k0, int K, bool vec, float sa) {
  for (int i = threadIdx.x; i < kI8BM * (kI8BK / 16); i += kI8Threads) {
    const int r = i >> 2, c = (i & 3) * 16;
    int8_t* d = dst + r * kI8Ld + c;
    const T* s = base + (long long)r * ld + k0 + c;
    if (sizeof(T) == 1 && vec) {  // K % 16 == 0: a 16-byte chunk is all in or all out
      const bool ok = r < rows && k0 + c < K;
      mma::cp_async16(d, ok ? (const void*)s : (const void*)base, ok);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + c + 4 * q + j;
          const uint32_t byte = (r < rows && k < K) ? code_of(s[4 * q + j], sa) : 0u;
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

// grid (M tiles, N tiles).
template <typename T>
__global__ void __launch_bounds__(kI8Threads) int8_gemm_kernel(
    const T* __restrict__ A, long long lda, const int8_t* __restrict__ B, long long ldb,
    const float* __restrict__ s_a, const float* __restrict__ s_b,
    const float* __restrict__ bias, float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) int8_t sA[2][kI8BM * kI8Ld];
  __shared__ __align__(16) int8_t sB[2][kI8BN * kI8Ld];
  const int m0 = blockIdx.x * kI8BM, n0 = blockIdx.y * kI8BN;
  const int rows_a = M - m0, rows_b = N - n0;
  const T* a_base = A + (long long)m0 * lda;
  const int8_t* b_base = B + (long long)n0 * ldb;
  const bool vec_a = K % 16 == 0 && lda % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vec_b = K % 16 == 0 && ldb % 16 == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  const int ktiles = (K + kI8BK - 1) / kI8BK;
  const float sa = *s_a;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4] = {};

  auto stage = [&](int buf, int kt) {
    stage_i8(sA[buf], a_base, lda, rows_a, kt * kI8BK, K, vec_a, sa);
    stage_i8(sB[buf], b_base, ldb, rows_b, kt * kI8BK, K, vec_b, 1.f);
  };
  stage(0, 0);
  mma::cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) stage(cur ^ 1, kt + 1);
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
          if (n < N) C[(long long)m * N + n] = i8_epilogue(acc[mi][ni][2 * h + j], sa, s_b, bias, n);
        }
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

// grid (M tiles, N tiles), kThreads threads of 4 x 4 outputs.
__global__ void __launch_bounds__(kThreads) w8_gemm_kernel(
    const float* __restrict__ X, long long ldx, const int8_t* __restrict__ B, long long ldb,
    const float* __restrict__ s_b, const float* __restrict__ bias, float* __restrict__ C,
    int M, int N, int K) {
  __shared__ __align__(16) float sX[kW8BK * kW8Ld];  // [k][m]
  __shared__ __align__(16) float sW[kW8BK * kW8Ld];  // [k][n], widened
  const int m0 = blockIdx.x * kW8BM, n0 = blockIdx.y * kW8BN;
  const int tid = threadIdx.x, tm = tid >> 4, tn = tid & 15;
  const bool vec_b = K % 8 == 0 && ldb % 8 == 0 && reinterpret_cast<uintptr_t>(B) % 8 == 0;
  const int ktiles = (K + kW8BK - 1) / kW8BK;
  float acc[4][4] = {};

  for (int kt = 0; kt < ktiles; ++kt) {
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tn + j;
      if (n < N) C[(long long)m * N + n] = w8_epilogue(acc[i][j], s_b, bias, n);
    }
  }
}

}  // namespace
}  // namespace stgx

// A (M, K) with row stride lda elements: a_type 0 int8 codes, 1 fp32
// (quantized under s_a); B (K, N) int8 column-major (column n at
// b + n * ldb); s_a one fp32 in device memory; s_b, bias (nullable) (N,)
// fp32; C (M, N) fp32 contiguous. Returns the launch's CUDA error.
extern "C" int stgx_int8_gemm(int a_type, const void* a, long long lda, const void* b,
                              long long ldb, const void* s_a, const void* s_b, const void* bias,
                              void* c, int M, int N, int K, void* stream) {
  using namespace stgx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + kI8BM - 1) / kI8BM, (N + kI8BN - 1) / kI8BN);
  const int8_t* bq = static_cast<const int8_t*>(b);
  const float *sa = static_cast<const float*>(s_a), *sb = static_cast<const float*>(s_b),
              *bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(c);
  if (a_type == 0)
    int8_gemm_kernel<<<grid, kI8Threads, 0, st>>>(static_cast<const int8_t*>(a), lda, bq, ldb,
                                                   sa, sb, bi, out, M, N, K);
  else if (a_type == 1)
    int8_gemm_kernel<<<grid, kI8Threads, 0, st>>>(static_cast<const float*>(a), lda, bq, ldb,
                                                   sa, sb, bi, out, M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// X (M, K) fp32 with row stride ldx; B, s_b, bias, C as above.
extern "C" int stgx_w8_gemm(const void* x, long long ldx, const void* b,
                            long long ldb, const void* s_b, const void* bias, void* c, int M,
                            int N, int K, void* stream) {
  using namespace stgx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((M + kW8BM - 1) / kW8BM, (N + kW8BN - 1) / kW8BN);
  const int8_t* bq = static_cast<const int8_t*>(b);
  const float *sb = static_cast<const float*>(s_b), *bi = static_cast<const float*>(bias);
  float* out = static_cast<float*>(c);
  w8_gemm_kernel<<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), ldx, bq, ldb, sb, bi,
                                            out, M, N, K);
  return (int)cudaGetLastError();
}
