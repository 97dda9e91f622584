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
// Design, both routes: the aggregate first. A block owns a tile of output
// rows m = (r, w) and BN output columns, up to 256: all of C_out on the
// main path, so the aggregate is formed once for all of them. It steps
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
//    run in the order of the plain tile (common.cuh): T over v from zero,
//    y over (p, c) in one chain, so it gives the same bits as rt_fused's
//    graph conv. The three-pass TF32 split on the tensor cores was tried
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
#include "mma.cuh"

namespace {

using namespace stgx;
using mma::aligned16;
using mma::allow_smem;
using mma::pad_kn;
using mma::pad_mk;

constexpr int kVPad = 32;  // bf16 route: joints padded to 32

// ------------------------------------------------------------ fp32, FMAs

constexpr int kFC = 16;  // C_in chunk a step

template <int BM, int BN>
struct FmaSmem {
  static constexpr int XROWS = BM + 2 * kMaxV;  // (row, joint) pairs a tile touches
  static constexpr int X_ELEMS = XROWS * kFC, T_ELEMS = kFC * BM, W_ELEMS = kFC * BN;
  static size_t bytes(int P) {
    return sizeof(float) * ((size_t)P * kVPad * kVPad + 2 * X_ELEMS + T_ELEMS + 2 * W_ELEMS);
  }
};

// A thread's TM x TN outputs sit in groups of 4 rows and 4 columns spread
// over the tile (so a warp's float4 loads are contiguous or broadcast):
// group g of rows starts at g * BM / (TM / 4) + ty * 4.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    core_fma_kernel(const float* __restrict__ x, const float* __restrict__ A,
                    const float* __restrict__ W, float* __restrict__ y, long long R,
                    int V, int P, int Cin, int Cout, bool vec_x, bool vec_w) {
  using S = FmaSmem<BM, BN>;
  constexpr int NTX = BN / TN, MG = TM / 4, NG = TN / 4;
  static_assert(NTX * (BM / TM) == kThreads && BM * kFC % (4 * kThreads) == 0, "thread grid");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);  // (P, 32, 32): A[p][v][w], zero padded
  float* Xs = As + P * kVPad * kVPad;              // 2 x (XROWS, kFC)
  float* Ts = Xs + 2 * S::X_ELEMS;                 // (kFC, BM): T[k][m]
  float* Ws = Ts + S::T_ELEMS;                     // 2 x (kFC, BN)

  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const long long M = R * V, m0 = (long long)blockIdx.x * BM;
  const long long pair0 = m0 / V * V;  // first staged (row, joint) pair
  const int d0 = blockIdx.y * BN;
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

  const bool quad = Cout % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + (i / 4) * (BM / MG) + ty * 4 + i % 4;
    if (m >= M) continue;
    float* yr = y + m * Cout;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = d0 + g * (BN / NG) + tx * 4;
      if (quad && d + 3 < Cout) {
        *reinterpret_cast<float4*>(yr + d) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (d + j < Cout) yr[d + j] = acc[i][4 * g + j];
      }
    }
  }
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

using bf16 = __nv_bfloat16;
constexpr int kMC = 64;  // C_in chunk a step (128 bytes a row)

template <int NR, int BN>
struct MmaSmem {
  static constexpr int BM = NR * kVPad;
  static constexpr int LDA = pad_mk<bf16>(kVPad);  // A^T[p][w][v], A operand
  static constexpr int LDX = pad_kn(kMC);    // X[(r, v)][c], B operand
  static constexpr int LDT = pad_mk<bf16>(kMC);    // T[(r, w)][c], A operand
  static constexpr int LDW = pad_kn(BN);     // W[c][d], B operand
  static constexpr int X_ELEMS = BM * LDX, W_ELEMS = kMC * LDW, T_ELEMS = BM * LDT;
  static size_t bytes(int P) {
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

template <int NR, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    core_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ A,
                    const bf16* __restrict__ W, bf16* __restrict__ y, long long R, int V,
                    int P, int Cin, int Cout, bool vec_x, bool vec_w) {
  using Op = mma::Bf16;
  using S = MmaSmem<NR, BN>;
  constexpr int BM = S::BM;
  constexpr int TM = BM / WM, TN = BN / WN, MT = TM / 16, NT = TN / 8;
  static_assert(WM * WN * 32 == kThreads && MT >= 1 && NT >= 1, "warp grid");
  constexpr int AGG = NR * 2 * (kMC / 8);  // 16 x 8 tiles of one step's T

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* At = reinterpret_cast<bf16*>(smem_raw);  // (P, 32, LDA): A_p^T, zero padded
  bf16* Xs = At + P * kVPad * S::LDA;            // 2 x (BM, LDX)
  bf16* Ws = Xs + 2 * S::X_ELEMS;                // 2 x (kMC, LDW)
  bf16* Ts = Ws + 2 * S::W_ELEMS;                // (BM, LDT)

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * NR;
  const int d0 = blockIdx.y * BN;
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
