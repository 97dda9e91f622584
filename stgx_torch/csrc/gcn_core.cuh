// One block's tile of the graph-conv core, shared by gcn_core.cu and
// rt_fused.cu (which differ only in what they write):
//   y[m, d] = sum_{(p,c)} T_p[m, c] * W[p, c, d],
//   T_p[m, c] = sum_v x[r(m), v, c] * A[p, v, w(m)],   m = (r, w).
//
// A block owns one tile of rows m and BN output columns. It steps over
// (partition p, C_in chunk); per step it
//  * stages the chunk's x rows and the W_p chunk with cp.async, double
//    buffered, so the next step's copies run under this step's products;
//  * forms the aggregate T_p of its rows for the chunk into shared memory,
//    once for all BN columns;
//  * adds T_p W_p into the block's registers.
// After the last step it hands the accumulators to the caller's epilogue.
//
// Routes:
//  * fp32, fma_tile: both products on the CUDA cores in fp32 FMAs, TM x TN
//    outputs a thread from float4 shared loads, rows m dense (no joint
//    padding). Its sums run in one fixed order: T over v from zero, y over
//    (p, c) in one chain, so both callers get the same bits for the same
//    rows (gcn_core.cu says why fp32 is not on the tensor cores).
//  * bf16, mma_tile: both products on the tensor cores, mma.sync m16n8k16
//    (mma.cuh), fp32 sums; a tile takes NR input rows, each row's V <= 32
//    joints padded to 32 (two 16-row tiles). T is rounded to bf16 before
//    the mix, as the TPU kernels' second dot_general did under default
//    precision.
#pragma once

#include "mma.cuh"

namespace stgx {
namespace gcn {

constexpr int kVPad = 32;  // bf16 route: joints padded to 32

// ------------------------------------------------------------ fp32, FMAs

constexpr int kFC = 16;  // C_in chunk a step

template <int BM, int BN>
struct FmaSmem {
  static constexpr int XROWS = BM + 2 * kMaxV;  // (row, joint) pairs a tile touches
  static constexpr int X_ELEMS = XROWS * kFC, T_ELEMS = kFC * BM, W_ELEMS = kFC * BN;
  __host__ __device__ static constexpr size_t bytes(int P) {
    return sizeof(float) * ((size_t)P * kVPad * kVPad + 2 * X_ELEMS + T_ELEMS + 2 * W_ELEMS);
  }
};

// The tile of rows [m0, m0 + BM) of x (M rows (r, w) in all: R * V) and
// columns [d0, d0 + BN); then epi(acc): the thread's TM x TN outputs, in
// groups of 4 rows and 4 columns spread over the tile (so a warp's float4
// loads are contiguous or broadcast): output (i, j) is row m0 + (i / 4) *
// (BM / (TM / 4)) + ty * 4 + i % 4 and column d0 + (j / 4) * (BN / (TN / 4))
// + tx * 4 + j % 4, tx = tid % (BN / TN), ty = tid / (BN / TN). smem holds
// FmaSmem<BM, BN>::bytes(P).
template <int BM, int BN, int TM, int TN, typename Epi>
__device__ __forceinline__ void fma_tile(const float* __restrict__ x, const float* __restrict__ A,
                                         const float* __restrict__ W, long long M, long long m0,
                                         int d0, int V, int P, int Cin, int Cout, bool vec_x,
                                         bool vec_w, unsigned char* smem, Epi epi) {
  using S = FmaSmem<BM, BN>;
  constexpr int NTX = BN / TN, MG = TM / 4, NG = TN / 4;
  static_assert(NTX * (BM / TM) == kThreads && BM * kFC % (4 * kThreads) == 0, "thread grid");

  float* As = reinterpret_cast<float*>(smem);  // (P, 32, 32): A[p][v][w], zero padded
  float* Xs = As + P * kVPad * kVPad;          // 2 x (XROWS, kFC)
  float* Ts = Xs + 2 * S::X_ELEMS;             // (kFC, BM): T[k][m]
  float* Ws = Ts + S::T_ELEMS;                 // 2 x (kFC, BN)

  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const long long pair0 = m0 / V * V;  // first staged (row, joint) pair
  const int nck = (Cin + kFC - 1) / kFC, steps = P * nck;

  for (int i = tid; i < P * kVPad * kVPad; i += kThreads) {
    const int p = i / (kVPad * kVPad), v = (i / kVPad) % kVPad, w = i % kVPad;
    As[i] = (v < V && w < V) ? A[((long long)p * V + v) * V + w] : 0.f;
  }

  auto stage = [&](int s) {
    const int p = s / nck, c0 = (s % nck) * kFC, buf = s & 1;
    mma::stage_tile<float>(Xs + buf * S::X_ELEMS, kFC, S::XROWS, kFC, Cin - c0, vec_x, x,
                           [&](int i) -> const float* {
                             const long long q = pair0 + i;
                             return q < M ? x + q * Cin + c0 : nullptr;
                           });
    mma::stage_tile<float>(Ws + buf * S::W_ELEMS, BN, kFC, BN, Cout - d0, vec_w, W,
                           [&](int k) -> const float* {
                             return c0 + k < Cin
                                        ? W + ((long long)p * Cin + c0 + k) * Cout + d0
                                        : nullptr;
                           });
    mma::cp_async_commit();
  };

  // each thread's share of the aggregate: one row m (its joint w and the
  // offset of its x row in the staged chunk) and CH channels, every step
  constexpr int CH = BM * kFC / kThreads;
  const int task_m = tid % BM, task_k = tid / BM * CH;
  const int task_w = (int)((m0 + task_m) % V);
  const int task_x = (int)((m0 + task_m) / V * V - pair0) * kFC + task_k;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  stage(0);
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait_all();
    __syncthreads();  // step s staged; every thread done with step s - 1
    if (s + 1 < steps) stage(s + 1);
    const float* Xb = Xs + (s & 1) * S::X_ELEMS;
    const float* Wb = Ws + (s & 1) * S::W_ELEMS;
    const float* Ap = As + (s / nck) * kVPad * kVPad;

    // T[k][m] = sum_v x[r(m), v, c0 + k] * A[p, v, w(m)]; a warp on 32
    // consecutive rows m
    {
      const float* xr = Xb + task_x;
      const float* ar = Ap + task_w;
      float t[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) t[j] = 0.f;
      for (int v = 0; v < V; ++v) {
        const float a = ar[v * kVPad];
#pragma unroll
        for (int j = 0; j < CH; j += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + v * kFC + j);
          t[j] += xv.x * a;
          t[j + 1] += xv.y * a;
          t[j + 2] += xv.z * a;
          t[j + 3] += xv.w * a;
        }
      }
#pragma unroll
      for (int j = 0; j < CH; ++j) Ts[(task_k + j) * BM + task_m] = t[j];
    }
    __syncthreads();

    // channel mix: acc += T[:, rows]^T W[:, cols] over this chunk
#pragma unroll
    for (int k = 0; k < kFC; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(Ts + k * BM + g * (BM / MG) + ty * 4);
        a[4 * g] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(Wb + k * BN + g * (BN / NG) + tx * 4);
        b[4 * g] = v.x; b[4 * g + 1] = v.y; b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
    }
  }
  epi(acc);
}

// ------------------------------------------------------------ bf16, mma.sync

using bf16 = __nv_bfloat16;
constexpr int kMC = 64;  // C_in chunk a step (128 bytes a row)

template <int NR, int BN>
struct MmaSmem {
  static constexpr int BM = NR * kVPad;
  static constexpr int LDA = mma::pad_mk<bf16>(kVPad);  // A^T[p][w][v], A operand
  static constexpr int LDX = mma::pad_kn(kMC);          // X[(r, v)][c], B operand
  static constexpr int LDT = mma::pad_mk<bf16>(kMC);    // T[(r, w)][c], A operand
  static constexpr int LDW = mma::pad_kn(BN);           // W[c][d], B operand
  static constexpr int X_ELEMS = BM * LDX, W_ELEMS = kMC * LDW, T_ELEMS = BM * LDT;
  __host__ __device__ static constexpr size_t bytes(int P) {
    return sizeof(bf16) * ((size_t)P * kVPad * LDA + 2 * X_ELEMS + 2 * W_ELEMS + T_ELEMS);
  }
};

// The 16 x 8 accumulator tile c into rows [0, 16), columns [0, 8) of p.
__device__ __forceinline__ void store_tile(bf16* p, int ld, const float (&c)[4]) {
  const int g = mma::lane_id() >> 2, t = mma::lane_id() & 3;
  *reinterpret_cast<__nv_bfloat162*>(p + g * ld + 2 * t) = __floats2bfloat162_rn(c[0], c[1]);
  *reinterpret_cast<__nv_bfloat162*>(p + (g + 8) * ld + 2 * t) =
      __floats2bfloat162_rn(c[2], c[3]);
}

// The tile of input rows [r0, r0 + NR) of x (R, V, Cin) (NR * 32 rows
// m = (r, w), joints padded) and columns [d0, d0 + BN); then epi(acc): warp
// (wm, wn) = (warp / WN, warp % WN) holds the 16 x 8 tiles acc[i][j] of rows
// m = wm * (BM / WM) + i * 16 and columns d0 + wn * (BN / WN) + j * 8, laid
// out as mma.cuh says. smem holds MmaSmem<NR, BN>::bytes(P).
template <int NR, int BN, int WM, int WN, typename Epi>
__device__ __forceinline__ void mma_tile(const bf16* __restrict__ x, const bf16* __restrict__ A,
                                         const bf16* __restrict__ W, long long R, long long r0,
                                         int d0, int V, int P, int Cin, int Cout, bool vec_x,
                                         bool vec_w, unsigned char* smem, Epi epi) {
  using Op = mma::Bf16;
  using S = MmaSmem<NR, BN>;
  constexpr int BM = S::BM;
  constexpr int TM = BM / WM, TN = BN / WN, MT = TM / 16, NT = TN / 8;
  static_assert(WM * WN * 32 == kThreads && MT >= 1 && NT >= 1, "warp grid");
  constexpr int AGG = NR * 2 * (kMC / 8);  // 16 x 8 tiles of one step's T

  bf16* At = reinterpret_cast<bf16*>(smem);  // (P, 32, LDA): A_p^T, zero padded
  bf16* Xs = At + P * kVPad * S::LDA;        // 2 x (BM, LDX)
  bf16* Ws = Xs + 2 * S::X_ELEMS;            // 2 x (kMC, LDW)
  bf16* Ts = Ws + 2 * S::W_ELEMS;            // (BM, LDT)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int nck = (Cin + kMC - 1) / kMC, steps = P * nck;

  for (int i = tid; i < P * kVPad * kVPad; i += kThreads) {
    const int p = i / (kVPad * kVPad), w = (i / kVPad) % kVPad, v = i % kVPad;
    At[(p * kVPad + w) * S::LDA + v] =
        (v < V && w < V) ? A[((long long)p * V + v) * V + w] : __float2bfloat16(0.f);
  }

  auto stage = [&](int s) {
    const int p = s / nck, c0 = (s % nck) * kMC, buf = s & 1;
    mma::stage_tile<bf16>(Xs + buf * S::X_ELEMS, S::LDX, BM, kMC, Cin - c0, vec_x, x,
                          [&](int i) -> const bf16* {
                            const long long r = r0 + i / kVPad;
                            const int v = i % kVPad;
                            return (r < R && v < V) ? x + (r * V + v) * Cin + c0 : nullptr;
                          });
    mma::stage_tile<bf16>(Ws + buf * S::W_ELEMS, S::LDW, kMC, BN, Cout - d0, vec_w, W,
                          [&](int k) -> const bf16* {
                            return c0 + k < Cin
                                       ? W + ((long long)p * Cin + c0 + k) * Cout + d0
                                       : nullptr;
                          });
    mma::cp_async_commit();
  };

  const int wm = warp / WN, wn = warp % WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  stage(0);
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait_all();
    __syncthreads();  // step s staged; every warp done with step s - 1
    if (s + 1 < steps) stage(s + 1);
    const bf16* Xb = Xs + (s & 1) * S::X_ELEMS;
    const bf16* Wb = Ws + (s & 1) * S::W_ELEMS;
    const bf16* Ap = At + (s / nck) * kVPad * S::LDA;

    // T[(r, w), c] = sum_v A_p[v, w] x[r, v, c], rounded to bf16
    for (int t = warp; t < AGG; t += kThreads / 32) {
      const int rl = t / (2 * (kMC / 8)), mi = (t / (kMC / 8)) % 2, ni = t % (kMC / 8);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kVPad; kk += Op::kK) {
        const auto a = Op::load_a_mk(Ap + mi * 16 * S::LDA + kk, S::LDA);
        const auto b = Op::load_b_kn(Xb + (rl * kVPad + kk) * S::LDX + ni * 8, S::LDX);
        Op::mma(c, a, b);
      }
      store_tile(Ts + (rl * kVPad + mi * 16) * S::LDT + ni * 8, S::LDT, c);
    }
    __syncthreads();

    // mix: acc += T[rows, :] W_p[:, cols] over this chunk
#pragma unroll
    for (int kk = 0; kk < kMC; kk += Op::kK) {
      Op::A a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a[i] = Op::load_a_mk(Ts + (wm * TM + i * 16) * S::LDT + kk, S::LDT);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const auto b = Op::load_b_kn(Wb + kk * S::LDW + wn * TN + j * 8, S::LDW);
#pragma unroll
        for (int i = 0; i < MT; ++i) Op::mma(acc[i][j], a[i], b);
      }
    }
  }
  epi(acc);
}

}  // namespace gcn
}  // namespace stgx
