// Parameter gradients of the graph-conv core against an upstream gradient g:
//   gA[p,v,w] = sum_{r,c,d} x[r,v,c] * g[r,w,d] * W[p,c,d]       (P, V, V)
//   gW[p,c,d] = sum_{r,v,w} x[r,v,c] * A[p,v,w] * g[r,w,d]       (P, Cin, Cout)
// both in fp32, summed over all R rows.
//
// Replaces stgx/ops/pallas_gcn.py:_grads_kernel (launched by _grads_impl).
//
// Bound on the H100: operations. A row r costs 4*P*V*C_in*(V + C_out)
// flops (twice the forward's) against (C_in + C_out)*V values read; the
// outputs are a few hundred KB. At the main path's widths that is 130-420
// flops a byte in fp32, above the card's 20 for fp32 FMAs and its ~150 for
// TF32 tensor cores (495 TFLOP/s over 3.35 TB/s); in bf16 near its ~300.
// Almost all of it is two products of size R*V x C_in x C_out a partition:
//   gW_p = T_p^T g, T_p[(r,w), c] = sum_v x[r,v,c] A[p,v,w]     (the aggregate)
//   gA_p[v,w] = sum_{r,c} x[r,v,c] U_p[(r,w), c], U_p = g W_p^T
//
// Design: all four products on the tensor cores (mma.sync, mma.cuh), each
// row's V <= 32 joints padded to 32. The TPU kernel carried gA and gW in
// VMEM across a sequential row grid; here the rows are cut into splits, each
// block sums one split into an fp32 partial in a workspace, and a last pass
// adds the partials in split order: no atomics, the same bits run to run.
//  * gw_kernel: a block owns a 64-wide C_in tile, a 64- or 128-wide C_out
//    tile and up to three partitions, and walks its split two input rows
//    (64 rows m) a step, x and g staged by cp.async, double buffered. Each
//    step forms T_p for its partitions once on the tensor cores into
//    shared memory and adds T_p^T g into register tiles of all of them.
//  * ga_kernel: a block owns a 32-wide C_in tile and up to three
//    partitions, and stages W_p[c tile, :] once (up to 256 columns of
//    C_out; wider C_out in windows of 256, each walking the rows again). It
//    walks its split four input rows (128 rows m) a step: U_p = g W_p^T
//    over 64-byte chunks of g (cp.async, double buffered) into registers,
//    then through shared memory into x^T U_p, summed into gA in registers.
//  * reduce_kernel adds the partials in split order.
//
// Routes: fp32 runs the three-pass TF32 split (hi*hi + hi*lo + lo*hi) on
// every product, the intermediates T_p and U_p kept in fp32. bf16 runs one
// pass on the products of the inputs; T_p and U_p, sums in fp32, are split
// into bf16 hi + lo (~16 mantissa bits) for the second products, so the
// fp32 gradients stay within the fp32 tolerance of the plain version.
#include "mma.cuh"

namespace {

using namespace stgx;
using mma::aligned16;
using mma::allow_smem;
using mma::pad_kn;
using mma::pad_mk;

constexpr int kVPad = 32;  // joints padded to 32: two 16-row tiles
constexpr int kPB = 3;     // partitions a block takes (P = 4: two groups)

// ------------------------------------------------------------------ gW

constexpr int kWC = 64;    // C_in tile of gw_kernel
constexpr int kWRows = 2;  // input rows a gw step takes

template <typename T, int BD>
struct GwSmem {
  static constexpr int KM = kWRows * kVPad;     // rows m a step
  static constexpr int NTT = sizeof(T) == 4 ? 1 : 2;  // T_p in fp32, or bf16 hi + lo
  static constexpr int LDA = pad_mk<T>(kVPad);  // At[p][w][v], A operand
  static constexpr int LDX = pad_kn(kWC);    // X[(r, v)][c], B operand
  static constexpr int LDG = pad_kn(BD);     // G[(r, w)][d], B operand
  static constexpr int LDT = pad_kn(kWC);    // T_p[(r, w)][c], read as A = T_p^T
  static constexpr int X_ELEMS = KM * LDX, G_ELEMS = KM * LDG, T_ELEMS = KM * LDT;
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kPB * kVPad * LDA + 2 * X_ELEMS + 2 * G_ELEMS + NTT * kPB * T_ELEMS);
};

// Stage A_p^T (zero padded to 32 x 32) for partitions p0 .. p0 + np - 1.
template <typename T>
__device__ void stage_adjacency_t(T* At, int ld, const T* __restrict__ A, int p0, int np,
                                  int V) {
  for (int i = threadIdx.x; i < np * kVPad * kVPad; i += blockDim.x) {
    const int pp = i / (kVPad * kVPad), w = (i / kVPad) % kVPad, v = i % kVPad;
    At[(pp * kVPad + w) * ld + v] =
        (v < V && w < V) ? A[((long long)(p0 + pp) * V + v) * V + w] : from_f<T>(0.f);
  }
}

template <typename T, int BD>
__global__ void __launch_bounds__(kThreads)
    gw_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ A,
              float* __restrict__ ws, long long R, long long rows_per_split, int V,
              int P, int Cin, int Cout, bool vec_x, bool vec_g) {
  using Op = typename mma::RouteOf<T>::Op;
  using S = GwSmem<T, BD>;
  constexpr int KM = S::KM, WM = 2, WN = 4;
  constexpr int TM = kWC / WM, TN = BD / WN, MT = TM / 16, NT = TN / 8;
  constexpr int AGG = kWRows * 2 * (kWC / 8);  // 16 x 8 tiles of one T_p

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* At = reinterpret_cast<T*>(smem_raw);  // (kPB, 32, LDA)
  T* Xs = At + kPB * kVPad * S::LDA;       // 2 x (KM, LDX)
  T* Gs = Xs + 2 * S::X_ELEMS;             // 2 x (KM, LDG)
  T* Ts = Gs + 2 * S::G_ELEMS;             // (kPB, KM, LDT) fp32, or hi then lo
  float* Tf = reinterpret_cast<float*>(Ts);

  const int pg_n = (P + kPB - 1) / kPB, ct_n = (Cin + kWC - 1) / kWC;
  const int pg = blockIdx.x % pg_n, ct = (blockIdx.x / pg_n) % ct_n,
            dt = blockIdx.x / (pg_n * ct_n);
  const int c0 = ct * kWC, d0 = dt * BD, p0 = pg * kPB, np = imin(kPB, P - p0);
  const long long split = blockIdx.y;
  const long long r_begin = split * rows_per_split;
  const long long r_end = lmin(r_begin + rows_per_split, R);
  const int steps = r_end > r_begin ? (int)((r_end - r_begin + kWRows - 1) / kWRows) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp / WN, wn = warp % WN;

  stage_adjacency_t(At, S::LDA, A, p0, np, V);

  auto stage = [&](int s) {
    const long long rs = r_begin + (long long)s * kWRows;
    const int buf = s & 1;
    mma::stage_tile<T>(Xs + buf * S::X_ELEMS, S::LDX, KM, kWC, Cin - c0, vec_x, x,
                       [&](int i) -> const T* {
                         const long long r = rs + i / kVPad;
                         const int v = i % kVPad;
                         return (r < r_end && v < V) ? x + (r * V + v) * Cin + c0 : nullptr;
                       });
    mma::stage_tile<T>(Gs + buf * S::G_ELEMS, S::LDG, KM, BD, Cout - d0, vec_g, g,
                       [&](int i) -> const T* {
                         const long long r = rs + i / kVPad;
                         const int w = i % kVPad;
                         return (r < r_end && w < V) ? g + (r * V + w) * Cout + d0 : nullptr;
                       });
    mma::cp_async_commit();
  };

  float acc[kPB][MT][NT][4];
#pragma unroll
  for (int p = 0; p < kPB; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[p][i][j][k] = 0.f;

  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait_all();
    __syncthreads();  // step s staged; every warp done with step s - 1
    if (s + 1 < steps) stage(s + 1);
    const T* Xb = Xs + (s & 1) * S::X_ELEMS;
    const T* Gb = Gs + (s & 1) * S::G_ELEMS;

    // T_p[(r, w), c] = sum_v A_p[v, w] x[r, v, c], for each partition
    const int g_ = mma::lane_id() >> 2, t_ = mma::lane_id() & 3;
    for (int t = warp; t < np * AGG; t += kThreads / 32) {
      const int pp = t / AGG, u = t % AGG;
      const int rl = u / (2 * (kWC / 8)), mi = (u / (kWC / 8)) % 2, ni = u % (kWC / 8);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kVPad; kk += Op::kK) {
        const auto a = Op::load_a_mk(At + (pp * kVPad + mi * 16) * S::LDA + kk, S::LDA);
        const auto b = Op::load_b_kn(Xb + (rl * kVPad + kk) * S::LDX + ni * 8, S::LDX);
        Op::mma(c, a, b);
      }
      const int off = pp * S::T_ELEMS + (rl * kVPad + mi * 16 + g_) * S::LDT + ni * 8 + 2 * t_;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = off + 8 * h * S::LDT;
        if constexpr (sizeof(T) == 4) {
          Tf[o] = c[2 * h];
          Tf[o + 1] = c[2 * h + 1];
        } else {
          uint32_t hi, lo;
          mma::split_bf16x2(c[2 * h], c[2 * h + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(Ts + o) = hi;
          *reinterpret_cast<uint32_t*>(Ts + kPB * S::T_ELEMS + o) = lo;
        }
      }
    }
    __syncthreads();

    // gW_p[c, d] += sum_m T_p[m, c] G[m, d] over the step's rows m. The
    // step's sum starts from zero and is added to acc in fp32 (see
    // mma.cuh: the tensor cores round a long chain of adds toward zero)
#pragma unroll
    for (int pp = 0; pp < kPB; ++pp) {
      if (pp >= np) break;
      float t[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) t[i][j][k] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KM; kk += Op::kK) {
        const int off = pp * S::T_ELEMS + kk * S::LDT + wm * TM;
        if constexpr (sizeof(T) == 4) {
          typename Op::A a[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i) a[i] = Op::load_a_km(Tf + off + i * 16, S::LDT);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const auto b = Op::load_b_kn(Gb + kk * S::LDG + wn * TN + j * 8, S::LDG);
#pragma unroll
            for (int i = 0; i < MT; ++i) Op::mma(t[i][j], a[i], b);
          }
        } else {
          typename Op::A ah[MT], al[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            ah[i] = Op::load_a_km(Ts + off + i * 16, S::LDT);
            al[i] = Op::load_a_km(Ts + kPB * S::T_ELEMS + off + i * 16, S::LDT);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const auto b = Op::load_b_kn(Gb + kk * S::LDG + wn * TN + j * 8, S::LDG);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              Op::mma(t[i][j], al[i], b);
              Op::mma(t[i][j], ah[i], b);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[pp][i][j][k] += t[i][j][k];
    }
  }

  const int g_ = mma::lane_id() >> 2, t_ = mma::lane_id() & 3;
#pragma unroll
  for (int pp = 0; pp < kPB; ++pp) {
    if (pp >= np) break;
    float* out = ws + (split * P + p0 + pp) * (long long)Cin * Cout;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * TM + i * 16 + g_ + 8 * h;
        if (c >= Cin) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int d = d0 + wn * TN + j * 8 + 2 * t_;
          if (d < Cout) out[(long long)c * Cout + d] = acc[pp][i][j][2 * h];
          if (d + 1 < Cout) out[(long long)c * Cout + d + 1] = acc[pp][i][j][2 * h + 1];
        }
      }
  }
}

// ------------------------------------------------------------------ gA

constexpr int kAC = 32;    // C_in tile of ga_kernel
constexpr int kARows = 4;  // input rows a ga step takes
constexpr int kDW = 256;   // C_out window whose W_p columns stay staged

template <typename T>
struct GaSmem {
  static constexpr int KM = kARows * kVPad;      // rows m a step
  static constexpr int KD = 64 / sizeof(T);      // g chunk: 64 bytes a row
  static constexpr int LDW = pad_mk<T>(kDW);     // W_p[c][d], B operand read [n][k]
  static constexpr int LDG = pad_mk<T>(KD);      // G[(r, w)][d], A operand
  static constexpr int LDX = pad_mk<T>(kAC);     // X[(r, v)][c], A operand
  // U_p[(r, w)][c] fp32, B operand read [n][k]: scalar loads (fp32 route)
  // or float2 loads (bf16 route, split to hi + lo)
  static constexpr int LDU = sizeof(T) == 4 ? pad_mk<float>(kAC) : kAC + 8;
  static constexpr int W_ELEMS = kAC * LDW, G_ELEMS = KM * LDG, X_ELEMS = KM * LDX;
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kPB * W_ELEMS + 2 * G_ELEMS + 2 * X_ELEMS) +
      sizeof(float) * (size_t)kPB * KM * LDU;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ W,
              float* __restrict__ ws, long long R, long long rows_per_split, int V, int P,
              int Cin, int Cout, bool vec_x, bool vec_gw) {
  using Op = typename mma::RouteOf<T>::Op;
  using S = GaSmem<T>;
  constexpr int KM = S::KM, KD = S::KD, WM = 4, WN = 2;
  constexpr int TM = KM / WM, TN = kAC / WN, MT = TM / 16, NT = TN / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Wsm = reinterpret_cast<T*>(smem_raw);  // (kPB, kAC, LDW)
  T* Gs = Wsm + kPB * S::W_ELEMS;           // 2 x (KM, LDG)
  T* Xs = Gs + 2 * S::G_ELEMS;              // 2 x (KM, LDX), by row-group parity
  float* Us = reinterpret_cast<float*>(Xs + 2 * S::X_ELEMS);  // (kPB, KM, LDU)

  const int pg_n = (P + kPB - 1) / kPB, ct_n = (Cin + kAC - 1) / kAC;
  const int pg = blockIdx.x % pg_n, ct = blockIdx.x / pg_n;
  const int c0 = ct * kAC, p0 = pg * kPB, np = imin(kPB, P - p0);
  const long long split = blockIdx.y;
  const long long r_begin = split * rows_per_split;
  const long long r_end = lmin(r_begin + rows_per_split, R);
  const int groups = r_end > r_begin ? (int)((r_end - r_begin + kARows - 1) / kARows) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp / WN, wn = warp % WN;
  const int lg = mma::lane_id() >> 2, lt = mma::lane_id() & 3;

  // gA tiles: warp -> (v tile mi, w tile ni), all partitions
  const int ami = warp >> 2, ani = warp & 3;
  float ga[kPB][4];
#pragma unroll
  for (int p = 0; p < kPB; ++p)
#pragma unroll
    for (int k = 0; k < 4; ++k) ga[p][k] = 0.f;
  float u[kPB][MT][NT][4];

  for (int w0 = 0; w0 < Cout && groups > 0; w0 += kDW) {
    const int nkd = (imin(kDW, Cout - w0) + KD - 1) / KD, steps = groups * nkd;
    auto stage = [&](int s) {
      const int rg = s / nkd, kd = s % nkd;
      const long long rs = r_begin + (long long)rg * kARows;
      const int dk = w0 + kd * KD;
      mma::stage_tile<T>(Gs + (s & 1) * S::G_ELEMS, S::LDG, KM, KD, Cout - dk, vec_gw, g,
                         [&](int i) -> const T* {
                           const long long r = rs + i / kVPad;
                           const int w = i % kVPad;
                           return (r < r_end && w < V) ? g + (r * V + w) * Cout + dk : nullptr;
                         });
      if (kd == 0)
        mma::stage_tile<T>(Xs + (rg & 1) * S::X_ELEMS, S::LDX, KM, kAC, Cin - c0, vec_x, x,
                           [&](int i) -> const T* {
                             const long long r = rs + i / kVPad;
                             const int v = i % kVPad;
                             return (r < r_end && v < V) ? x + (r * V + v) * Cin + c0
                                                         : nullptr;
                           });
      mma::cp_async_commit();
    };

    __syncthreads();  // the last window's readers are done with W and the buffers
    for (int pp = 0; pp < np; ++pp)
      mma::stage_tile<T>(Wsm + pp * S::W_ELEMS, S::LDW, kAC, kDW, Cout - w0, vec_gw, W,
                         [&](int c) -> const T* {
                           return c0 + c < Cin
                                      ? W + ((long long)(p0 + pp) * Cin + c0 + c) * Cout + w0
                                      : nullptr;
                         });
    stage(0);

    for (int s = 0; s < steps; ++s) {
      const int rg = s / nkd, kd = s % nkd;
      mma::cp_async_wait_all();
      __syncthreads();  // step s staged; every warp done with step s - 1
      if (s + 1 < steps) stage(s + 1);
      const T* Gb = Gs + (s & 1) * S::G_ELEMS;

      if (kd == 0) {
#pragma unroll
        for (int p = 0; p < kPB; ++p)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int k = 0; k < 4; ++k) u[p][i][j][k] = 0.f;
      }
      // U_p[m, c] += sum_d G[m, d] W_p[c, d] over this chunk of d
#pragma unroll
      for (int kk = 0; kk < KD; kk += Op::kK) {
        typename Op::A a[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          a[i] = Op::load_a_mk(Gb + (wm * TM + i * 16) * S::LDG + kk, S::LDG);
#pragma unroll
        for (int pp = 0; pp < kPB; ++pp) {
          if (pp >= np) break;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const auto b = Op::load_b_nk(
                Wsm + pp * S::W_ELEMS + (wn * TN + j * 8) * S::LDW + kd * KD + kk, S::LDW);
#pragma unroll
            for (int i = 0; i < MT; ++i) Op::mma(u[pp][i][j], a[i], b);
          }
        }
      }
      if (kd + 1 < nkd) continue;

      // the row group's U_p through shared memory, then
      // gA_p[v, w] += sum_{r, c} x[r, v, c] U_p[(r, w), c]
#pragma unroll
      for (int pp = 0; pp < kPB; ++pp) {
        if (pp >= np) break;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float* o = Us + (pp * KM + wm * TM + i * 16 + lg) * S::LDU + wn * TN + j * 8 + 2 * lt;
            *reinterpret_cast<float2*>(o) = make_float2(u[pp][i][j][0], u[pp][i][j][1]);
            *reinterpret_cast<float2*>(o + 8 * S::LDU) =
                make_float2(u[pp][i][j][2], u[pp][i][j][3]);
          }
      }
      __syncthreads();
      // the row group's sum starts from zero and is added to ga in fp32
      const T* Xb = Xs + (rg & 1) * S::X_ELEMS;
      float t[kPB][4];
#pragma unroll
      for (int p = 0; p < kPB; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) t[p][k] = 0.f;
#pragma unroll
      for (int rl = 0; rl < kARows; ++rl)
#pragma unroll
        for (int kk = 0; kk < kAC; kk += Op::kK) {
          const auto a = Op::load_a_mk(Xb + (rl * kVPad + ami * 16) * S::LDX + kk, S::LDX);
#pragma unroll
          for (int pp = 0; pp < kPB; ++pp) {
            if (pp >= np) break;
            const float* ub = Us + (pp * KM + rl * kVPad + ani * 8) * S::LDU + kk;
            if constexpr (sizeof(T) == 4) {
              Op::mma(t[pp], a, Op::load_b_nk(ub, S::LDU));
            } else {
              typename Op::B bh, bl;
              Op::load_b_nk_split(ub, S::LDU, bh, bl);
              Op::mma(t[pp], a, bl);
              Op::mma(t[pp], a, bh);
            }
          }
        }
#pragma unroll
      for (int p = 0; p < kPB; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) ga[p][k] += t[p][k];
    }
  }

#pragma unroll
  for (int pp = 0; pp < kPB; ++pp) {
    if (pp >= np) break;
    float* out = ws + ((split * ct_n + ct) * P + p0 + pp) * (long long)V * V;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = ami * 16 + lg + 8 * h, w = ani * 8 + 2 * lt;
      if (v >= V) continue;
      if (w < V) out[v * V + w] = ga[pp][2 * h];
      if (w + 1 < V) out[v * V + w + 1] = ga[pp][2 * h + 1];
    }
  }
}

// out[i] = sum_{s < S} ws[s, i], in split order.
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int S, long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

cudaError_t reduce(const float* ws, float* out, int S, long long n, cudaStream_t stream) {
  const long long blocks = lmin((n + kThreads - 1) / kThreads, 1024);
  reduce_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(ws, out, S, n);
  return cudaGetLastError();
}

template <typename T, int BD>
cudaError_t launch_gw(const T* x, const T* g, const T* A, float* ws_w, long long R, int V,
                      int P, int Cin, int Cout, int splits, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem = GwSmem<T, BD>::kBytes;
  cudaError_t e = allow_smem(gw_kernel<T, BD>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = ((P + kPB - 1) / kPB) * ((Cin + kWC - 1) / kWC) * ((Cout + BD - 1) / BD);
  gw_kernel<T, BD><<<dim3(blocks, splits), kThreads, smem, stream>>>(
      x, g, A, ws_w, R, (R + splits - 1) / splits, V, P, Cin, Cout,
      Cin % kVec == 0 && aligned16(x), Cout % kVec == 0 && aligned16(g));
  return cudaGetLastError();
}

template <typename T>
int grads(const void* xv, const void* gv, const void* Av, const void* Wv, float* gA,
          float* gW, float* ws_w, float* ws_a, long long R, int V, int P, int Cin,
          int Cout, int splits_w, int splits_a, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gv);
  const T* A = static_cast<const T*>(Av);
  const T* W = static_cast<const T*>(Wv);
  const int pg_n = (P + kPB - 1) / kPB, cta_n = (Cin + kAC - 1) / kAC;

  cudaError_t e = Cout <= 64 ? launch_gw<T, 64>(x, g, A, ws_w, R, V, P, Cin, Cout, splits_w, stream)
                             : launch_gw<T, 128>(x, g, A, ws_w, R, V, P, Cin, Cout, splits_w, stream);
  if (e != cudaSuccess) return (int)e;

  const size_t smem_a = GaSmem<T>::kBytes;
  if ((e = allow_smem(ga_kernel<T>, smem_a)) != cudaSuccess) return (int)e;
  ga_kernel<T><<<dim3(pg_n * cta_n, splits_a), kThreads, smem_a, stream>>>(
      x, g, W, ws_a, R, (R + splits_a - 1) / splits_a, V, P, Cin, Cout,
      Cin % kVec == 0 && aligned16(x),
      Cout % kVec == 0 && aligned16(g) && aligned16(W));
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((e = reduce(ws_w, gW, splits_w, (long long)P * Cin * Cout, stream)) != cudaSuccess)
    return (int)e;
  return (int)reduce(ws_a, gA, splits_a * cta_n, (long long)P * V * V, stream);
}

}  // namespace

// x (R, V, Cin), g (R, V, Cout), A (P, V, V), W (P, Cin, Cout): contiguous,
// one type (dtype 0 = float32, 1 = bfloat16). gA, gW and the workspaces are
// fp32: ws_w holds splits_w * P * Cin * Cout floats, ws_a splits_a *
// ceil(Cin / 32) * P * V * V. Returns the CUDA error of the launches (0 on
// success).
extern "C" int stgx_gcn_grads(const void* x, const void* g, const void* A,
                              const void* W, float* gA, float* gW,
                              float* ws_w, float* ws_a, long long R, int V,
                              int P, int Cin, int Cout, int splits_w,
                              int splits_a, int dtype, void* stream) {
  if (R <= 0 || R > 2147483647LL || V < 1 || V > stgx::kMaxV || P < 1 ||
      P > stgx::kMaxP || Cin < 1 || Cout < 1 || splits_w < 1 ||
      splits_w > 65535 || splits_a < 1 || splits_a > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return grads<float>(x, g, A, W, gA, gW, ws_w, ws_a, R, V, P, Cin, Cout, splits_w,
                        splits_a, s);
  if (dtype == 1)
    return grads<__nv_bfloat16>(x, g, A, W, gA, gW, ws_w, ws_a, R, V, P, Cin, Cout,
                                splits_w, splits_a, s);
  return (int)cudaErrorInvalidValue;
}
