// The tensor-core gradient kernels of the graph-conv core, shared by
// gcn_grads.cu and rt_fused_bwd.cu. Against a row gradient G (R, V, Cout):
//   gW_p = T_p^T G,  T_p[(r,w), c] = sum_v x[r,v,c] A[p,v,w]        (P, Cin, Cout)
//   gA_p[v,w] = sum_{r,c} x[r,v,c] U_p[(r,w), c],  U_p = G W_p^T      (P, V, V)
//   gx[r,v,c] = sum_{p,w} A[p,v,w] U_p[(r,w), c]          (rt_fused_bwd only)
// gA and gW in fp32, summed over all R rows; gx in x's type.
//
// All products on the tensor cores (mma.sync, mma.cuh), each row's V <= 32
// joints padded to 32. The TPU kernels carried gA and gW in VMEM across a
// sequential row grid; here the rows are cut into splits, each block sums
// one split into an fp32 partial in a workspace, and a last pass adds the
// partials in split order: no atomics, the same bits run to run.
//  * gw_kernel: a block owns a 64-wide C_in tile, a 64- or 128-wide C_out
//    tile and up to three partitions, and walks its split two input rows
//    (64 rows m) a step, x and G staged by cp.async, double buffered. Each
//    step forms T_p for its partitions once on the tensor cores into
//    shared memory and adds T_p^T G into register tiles of all of them.
//  * ga_kernel: a block owns a 32-wide C_in tile and up to three
//    partitions, and stages W_p[c tile, :] once (up to 256 columns of
//    C_out; wider C_out in windows of 256, each walking the rows again). It
//    walks its split four input rows (128 rows m) a step: U_p = G W_p^T
//    over 64-byte chunks of G (cp.async, double buffered) into registers,
//    then through shared memory into x^T U_p, summed into gA in registers,
//    and, where gx is asked for, into A_p U_p, the row group's gx tile.
//    With one partition group and one window of C_out the tile is written
//    in x's type; else each group's sum goes to an fp32 workspace slice (a
//    block adds its later windows to its own rows), which the caller adds
//    in group order.
//  * reduce_kernel adds the partials in split order.
//
// Routes: fp32 runs the three-pass TF32 split (hi*hi + hi*lo + lo*hi) on
// every product, the intermediates T_p and U_p kept in fp32. bf16 runs one
// pass on the products of the inputs; T_p and U_p, sums in fp32, are split
// into bf16 hi + lo (~16 mantissa bits) for the second products, so the
// fp32 gradients stay within the fp32 tolerance of the plain version. G
// may itself come in GS = 2 bf16 parts, hi + lo (rt_fused_bwd's window sum
// of bf16 values, which one bf16 would round): each product of G then
// takes both parts.
// Each step's chain of mma.sync starts from zero and is added to the
// running sums in fp32 (mma.cuh: the tensor cores round toward zero).
#pragma once

#include "mma.cuh"

namespace stgx {
namespace grads {

using mma::aligned16;
using mma::allow_smem;
using mma::pad_kn;
using mma::pad_mk;

constexpr int kVPad = 32;  // joints padded to 32: two 16-row tiles
constexpr int kPB = 3;     // partitions a block takes (P = 4: two groups)

// ------------------------------------------------------------------ gW

constexpr int kWC = 64;    // C_in tile of gw_kernel
constexpr int kWRows = 2;  // input rows a gw step takes

template <typename T, int BD, int GS>
struct GwSmem {
  static constexpr int KM = kWRows * kVPad;     // rows m a step
  static constexpr int NTT = sizeof(T) == 4 ? 1 : 2;  // T_p in fp32, or bf16 hi + lo
  static constexpr int LDA = pad_mk<T>(kVPad);  // At[p][w][v], A operand
  static constexpr int LDX = pad_kn(kWC);    // X[(r, v)][c], B operand
  static constexpr int LDG = pad_kn(BD);     // G[(r, w)][d], B operand
  static constexpr int LDT = pad_kn(kWC);    // T_p[(r, w)][c], read as A = T_p^T
  static constexpr int X_ELEMS = KM * LDX, G_ELEMS = KM * LDG, T_ELEMS = KM * LDT;
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kPB * kVPad * LDA + 2 * X_ELEMS + 2 * GS * G_ELEMS +
                   NTT * kPB * T_ELEMS);
};

// Stage A_p^T (zero padded to 32 x 32) for partitions p0 .. p0 + np - 1;
// with `transpose` false, A_p itself.
template <typename T>
__device__ void stage_adjacency(T* At, int ld, const T* __restrict__ A, int p0, int np, int V,
                                bool transpose = true) {
  for (int i = threadIdx.x; i < np * kVPad * kVPad; i += blockDim.x) {
    const int pp = i / (kVPad * kVPad), a = (i / kVPad) % kVPad, b = i % kVPad;
    const int v = transpose ? b : a, w = transpose ? a : b;
    At[(pp * kVPad + a) * ld + b] =
        (v < V && w < V) ? A[((long long)(p0 + pp) * V + v) * V + w] : from_f<T>(0.f);
  }
}

// g and g_lo: G's parts (g_lo unread when GS = 1). With BE, the blocks of
// the first partition group and C_in tile also sum the staged G over their
// split's rows into ws_be[split] (V, Cout): rt_fused_bwd's gbe partials.
template <typename T, int BD, int GS, bool BE>
__global__ void __launch_bounds__(kThreads)
    gw_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ g_lo,
              const T* __restrict__ A, float* __restrict__ ws, float* __restrict__ ws_be,
              long long R, long long rows_per_split, int V, int P, int Cin, int Cout, bool vec_x,
              bool vec_g) {
  using Op = typename mma::RouteOf<T>::Op;
  using S = GwSmem<T, BD, GS>;
  constexpr int KM = S::KM, WM = 2, WN = 4;
  constexpr int TM = kWC / WM, TN = BD / WN, MT = TM / 16, NT = TN / 8;
  constexpr int AGG = kWRows * 2 * (kWC / 8);  // 16 x 8 tiles of one T_p
  constexpr int BE_N = BE ? kVPad * BD / kThreads : 1;  // gbe sums a thread holds

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* At = reinterpret_cast<T*>(smem_raw);  // (kPB, 32, LDA)
  T* Xs = At + kPB * kVPad * S::LDA;       // 2 x (KM, LDX)
  T* Gs = Xs + 2 * S::X_ELEMS;             // GS x 2 x (KM, LDG): g, then g_lo
  T* Ts = Gs + 2 * GS * S::G_ELEMS;        // (kPB, KM, LDT) fp32, or hi then lo
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

  stage_adjacency(At, S::LDA, A, p0, np, V);

  auto stage = [&](int s) {
    const long long rs = r_begin + (long long)s * kWRows;
    const int buf = s & 1;
    mma::stage_tile<T>(Xs + buf * S::X_ELEMS, S::LDX, KM, kWC, Cin - c0, vec_x, x,
                       [&](int i) -> const T* {
                         const long long r = rs + i / kVPad;
                         const int v = i % kVPad;
                         return (r < r_end && v < V) ? x + (r * V + v) * Cin + c0 : nullptr;
                       });
#pragma unroll
    for (int part = 0; part < GS; ++part) {
      const T* gp = part == 0 ? g : g_lo;
      mma::stage_tile<T>(Gs + (part * 2 + buf) * S::G_ELEMS, S::LDG, KM, BD, Cout - d0, vec_g,
                         gp, [&](int i) -> const T* {
                           const long long r = rs + i / kVPad;
                           const int w = i % kVPad;
                           return (r < r_end && w < V) ? gp + (r * V + w) * Cout + d0 : nullptr;
                         });
    }
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

  float be[BE_N];
#pragma unroll
  for (int k = 0; k < BE_N; ++k) be[k] = 0.f;

  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    mma::cp_async_wait_all();
    __syncthreads();  // step s staged; every warp done with step s - 1
    if (s + 1 < steps) stage(s + 1);
    const T* Xb = Xs + (s & 1) * S::X_ELEMS;
    const T* Gb = Gs + (s & 1) * S::G_ELEMS;
    const T* Gl = Gs + (2 + (s & 1)) * S::G_ELEMS;  // g_lo (GS = 2)

    // gbe[w, d] += G[(r, w), d] over the step's rows, (w, d) = e / BD, e % BD
    if constexpr (BE) {
      if (pg == 0 && ct == 0) {
#pragma unroll
        for (int k = 0; k < BE_N; ++k) {
          const int e = tid + k * kThreads, o = (e / BD) * S::LDG + e % BD;
#pragma unroll
          for (int rl = 0; rl < kWRows; ++rl) {
            be[k] += to_f(Gb[rl * kVPad * S::LDG + o]);
            if constexpr (GS == 2) be[k] += to_f(Gl[rl * kVPad * S::LDG + o]);
          }
        }
      }
    }

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
    // step's sum starts from zero and is added to acc in fp32
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
            if constexpr (GS == 2) {
              const auto bl = Op::load_b_kn(Gl + kk * S::LDG + wn * TN + j * 8, S::LDG);
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                Op::mma(t[i][j], al[i], b);
                Op::mma(t[i][j], ah[i], bl);
                Op::mma(t[i][j], ah[i], b);
              }
            } else {
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                Op::mma(t[i][j], al[i], b);
                Op::mma(t[i][j], ah[i], b);
              }
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
  if constexpr (BE) {
    if (pg == 0 && ct == 0) {
#pragma unroll
      for (int k = 0; k < BE_N; ++k) {
        const int e = tid + k * kThreads, w = e / BD, d = d0 + e % BD;
        if (w < V && d < Cout) ws_be[(split * V + w) * Cout + d] = be[k];
      }
    }
  }
}

// ------------------------------------------------------------------ gA

constexpr int kAC = 32;    // C_in tile of ga_kernel
constexpr int kARows = 4;  // input rows a ga step takes
constexpr int kDW = 256;   // C_out window whose W_p columns stay staged

template <typename T, int GS, bool GX>
struct GaSmem {
  static constexpr int KM = kARows * kVPad;      // rows m a step
  static constexpr int KD = 64 / sizeof(T);      // G chunk: 64 bytes a row
  static constexpr int LDW = pad_mk<T>(kDW);     // W_p[c][d], B operand read [n][k]
  static constexpr int LDG = pad_mk<T>(KD);      // G[(r, w)][d], A operand
  static constexpr int LDX = pad_mk<T>(kAC);     // X[(r, v)][c], A operand
  static constexpr int LDA = pad_mk<T>(kVPad);   // A_p[v][w], A operand of gx
  // U_p[(r, w)][c], B operand read [n][k] (gA) and [k][n] (gx): fp32 with
  // scalar loads (fp32 route); in bf16 fp32 with float2 loads split to
  // hi + lo at each load, or, with gx (U16), stored once as a bf16 hi and
  // a bf16 lo plane for ldmatrix (the same bytes)
  static constexpr bool U16 = GX && sizeof(T) == 2;
  static constexpr int LDU = sizeof(T) == 4 ? pad_mk<float>(kAC) : kAC + 8;
  static constexpr int W_ELEMS = kAC * LDW, G_ELEMS = KM * LDG, X_ELEMS = KM * LDX;
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kPB * W_ELEMS + 2 * GS * G_ELEMS + 2 * X_ELEMS +
                   (GX ? kPB * kVPad * LDA : 0)) +
      sizeof(float) * (size_t)kPB * KM * LDU;
};

// g and g_lo: G's parts (g_lo unread when GS = 1). With GX: A (P, V, V),
// and gx (R, V, Cin) written directly when gx_ws is null, else gx_ws
// (ceil(P / 3), R, V, Cin) receives each partition group's sum in fp32; gx
// not formed when both are null.
template <typename T, int GS, bool GX>
__global__ void __launch_bounds__(kThreads)
    ga_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ g_lo,
              const T* __restrict__ W, const T* __restrict__ A, float* __restrict__ ws,
              T* __restrict__ gx, float* __restrict__ gx_ws, long long R,
              long long rows_per_split, int V, int P, int Cin, int Cout, bool vec_x,
              bool vec_gw) {
  using Op = typename mma::RouteOf<T>::Op;
  using S = GaSmem<T, GS, GX>;
  constexpr int KM = S::KM, KD = S::KD, WM = 4, WN = 2;
  constexpr int TM = KM / WM, TN = kAC / WN, MT = TM / 16, NT = TN / 8;
  constexpr int GXT = kARows * 2 * (kAC / 8);  // 16 x 8 tiles of a row group's gx

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Wsm = reinterpret_cast<T*>(smem_raw);  // (kPB, kAC, LDW)
  T* Gs = Wsm + kPB * S::W_ELEMS;           // GS x 2 x (KM, LDG): g, then g_lo
  T* Xs = Gs + 2 * GS * S::G_ELEMS;         // 2 x (KM, LDX), by row-group parity
  T* Ax = Xs + 2 * S::X_ELEMS;              // (kPB, 32, LDA): A_p, gx only
  float* Us = reinterpret_cast<float*>(Ax + (GX ? kPB * kVPad * S::LDA : 0));  // (kPB, KM, LDU)
  T* Uh = reinterpret_cast<T*>(Us);     // U16: (kPB, KM, LDU) bf16 hi plane,
  T* Ul = Uh + kPB * KM * S::LDU;       // then the lo plane

  const int pg_n = (P + kPB - 1) / kPB, ct_n = (Cin + kAC - 1) / kAC;
  const int pg = blockIdx.x % pg_n, ct = blockIdx.x / pg_n;
  const int c0 = ct * kAC, p0 = pg * kPB, np = imin(kPB, P - p0);
  const long long split = blockIdx.y;
  const long long r_begin = split * rows_per_split;
  const long long r_end = lmin(r_begin + rows_per_split, R);
  const int groups = r_end > r_begin ? (int)((r_end - r_begin + kARows - 1) / kARows) : 0;
  const int tid = threadIdx.x, warp = tid >> 5, wm = warp / WN, wn = warp % WN;
  const int lg = mma::lane_id() >> 2, lt = mma::lane_id() & 3;
  const bool do_gx = GX && (gx != nullptr || gx_ws != nullptr);
  if (do_gx) stage_adjacency(Ax, S::LDA, A, p0, np, V, false);

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
#pragma unroll
      for (int part = 0; part < GS; ++part) {
        const T* gp = part == 0 ? g : g_lo;
        mma::stage_tile<T>(Gs + (part * 2 + (s & 1)) * S::G_ELEMS, S::LDG, KM, KD, Cout - dk,
                           vec_gw, gp, [&](int i) -> const T* {
                             const long long r = rs + i / kVPad;
                             const int w = i % kVPad;
                             return (r < r_end && w < V) ? gp + (r * V + w) * Cout + dk
                                                         : nullptr;
                           });
      }
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
      const T* Gl = Gs + (2 + (s & 1)) * S::G_ELEMS;  // g_lo (GS = 2)

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
        typename Op::A a[MT], al[GS == 2 ? MT : 1];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          a[i] = Op::load_a_mk(Gb + (wm * TM + i * 16) * S::LDG + kk, S::LDG);
          if constexpr (GS == 2)
            al[i] = Op::load_a_mk(Gl + (wm * TM + i * 16) * S::LDG + kk, S::LDG);
        }
#pragma unroll
        for (int pp = 0; pp < kPB; ++pp) {
          if (pp >= np) break;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const auto b = Op::load_b_nk(
                Wsm + pp * S::W_ELEMS + (wn * TN + j * 8) * S::LDW + kd * KD + kk, S::LDW);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if constexpr (GS == 2) Op::mma(u[pp][i][j], al[i], b);
              Op::mma(u[pp][i][j], a[i], b);
            }
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
            const int o = (pp * KM + wm * TM + i * 16 + lg) * S::LDU + wn * TN + j * 8 + 2 * lt;
            if constexpr (S::U16) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                uint32_t hi, lo;
                mma::split_bf16x2(u[pp][i][j][2 * h], u[pp][i][j][2 * h + 1], hi, lo);
                *reinterpret_cast<uint32_t*>(Uh + o + 8 * h * S::LDU) = hi;
                *reinterpret_cast<uint32_t*>(Ul + o + 8 * h * S::LDU) = lo;
              }
            } else {
              *reinterpret_cast<float2*>(Us + o) = make_float2(u[pp][i][j][0], u[pp][i][j][1]);
              *reinterpret_cast<float2*>(Us + o + 8 * S::LDU) =
                  make_float2(u[pp][i][j][2], u[pp][i][j][3]);
            }
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
            const int ou = (pp * KM + rl * kVPad + ani * 8) * S::LDU + kk;
            if constexpr (sizeof(T) == 4) {
              Op::mma(t[pp], a, Op::load_b_nk(Us + ou, S::LDU));
            } else {
              typename Op::B bh, bl;
              if constexpr (S::U16) {
                bh = Op::load_b_nk(Uh + ou, S::LDU);
                bl = Op::load_b_nk(Ul + ou, S::LDU);
              } else {
                Op::load_b_nk_split(Us + ou, S::LDU, bh, bl);
              }
              Op::mma(t[pp], a, bl);
              Op::mma(t[pp], a, bh);
            }
          }
        }
#pragma unroll
      for (int p = 0; p < kPB; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) ga[p][k] += t[p][k];

      // gx[r, v, c] = sum_{p, w} A_p[v, w] U_p[(r, w), c], a chain from
      // zero for each 16 x 8 tile
      if constexpr (GX) {
        if (do_gx) {
          const long long rs = r_begin + (long long)rg * kARows;
          for (int tile = warp; tile < GXT; tile += kThreads / 32) {
            const int rl = tile / (2 * (kAC / 8)), mi = (tile / (kAC / 8)) % 2,
                      ni = tile % (kAC / 8);
            float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int pp = 0; pp < kPB; ++pp) {
              if (pp >= np) break;
#pragma unroll
              for (int kk = 0; kk < kVPad; kk += Op::kK) {
                const auto a = Op::load_a_mk(Ax + (pp * kVPad + mi * 16) * S::LDA + kk, S::LDA);
                const int ou = (pp * KM + rl * kVPad + kk) * S::LDU + ni * 8;
                if constexpr (sizeof(T) == 4) {
                  Op::mma(c, a, Op::load_b_kn(Us + ou, S::LDU));
                } else {
                  // gx is stored in bf16: U_p's hi part is enough
                  Op::mma(c, a, Op::load_b_kn(Uh + ou, S::LDU));
                }
              }
            }
            const long long r = rs + rl;
            if (r >= r_end) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int v = mi * 16 + lg + 8 * h;
              if (v >= V) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int cc = c0 + ni * 8 + 2 * lt + e;
                if (cc >= Cin) continue;
                if (gx_ws == nullptr) {
                  gx[(r * V + v) * Cin + cc] = from_f<T>(c[2 * h + e]);
                } else {
                  float* dst = gx_ws + (pg * R * V + r * V + v) * Cin + cc;
                  *dst = w0 == 0 ? c[2 * h + e] : *dst + c[2 * h + e];
                }
              }
            }
          }
        }
      }
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

// out[i] = sum_{s < S} ws[s, i], in split order. (A template, as every
// kernel in this header: each source that includes it instantiates its own.)
template <typename F>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const F* __restrict__ ws, F* __restrict__ out, int S, long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    F s = 0;
    for (int k = 0; k < S; ++k) s += ws[k * n + i];
    out[i] = s;
  }
}

inline cudaError_t reduce(const float* ws, float* out, int S, long long n, cudaStream_t stream) {
  const long long blocks = lmin((n + kThreads - 1) / kThreads, 1024);
  reduce_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(ws, out, S, n);
  return cudaGetLastError();
}

// The gW partials (and with BE the gbe partials, ws_be): gw_kernel with a
// 64- or 128-wide C_out tile.
template <typename T, int GS, bool BE>
cudaError_t launch_gw(const T* x, const T* g, const T* g_lo, const T* A, float* ws_w,
                      float* ws_be, long long R, int V, int P, int Cin, int Cout, int splits,
                      cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_x = Cin % kVec == 0 && aligned16(x);
  const bool vec_g = Cout % kVec == 0 && aligned16(g) && (GS == 1 || aligned16(g_lo));
  const long long rows = (R + splits - 1) / splits;
  const int pc = ((P + kPB - 1) / kPB) * ((Cin + kWC - 1) / kWC);
  cudaError_t e;
  if (Cout <= 64) {
    auto kernel = gw_kernel<T, 64, GS, BE>;
    if ((e = allow_smem(kernel, GwSmem<T, 64, GS>::kBytes)) != cudaSuccess) return e;
    kernel<<<dim3(pc * ((Cout + 63) / 64), splits), kThreads, GwSmem<T, 64, GS>::kBytes,
             stream>>>(x, g, g_lo, A, ws_w, ws_be, R, rows, V, P, Cin, Cout, vec_x, vec_g);
  } else {
    auto kernel = gw_kernel<T, 128, GS, BE>;
    if ((e = allow_smem(kernel, GwSmem<T, 128, GS>::kBytes)) != cudaSuccess) return e;
    kernel<<<dim3(pc * ((Cout + 127) / 128), splits), kThreads, GwSmem<T, 128, GS>::kBytes,
             stream>>>(x, g, g_lo, A, ws_w, ws_be, R, rows, V, P, Cin, Cout, vec_x, vec_g);
  }
  return cudaGetLastError();
}

// The gA partials (and gx, or its group slices, where asked): ga_kernel.
template <typename T, int GS, bool GX>
cudaError_t launch_ga(const T* x, const T* g, const T* g_lo, const T* W, const T* A,
                      float* ws_a, T* gx, float* gx_ws, long long R, int V, int P, int Cin,
                      int Cout, int splits, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t smem = GaSmem<T, GS, GX>::kBytes;
  cudaError_t e = allow_smem(ga_kernel<T, GS, GX>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = ((P + kPB - 1) / kPB) * ((Cin + kAC - 1) / kAC);
  ga_kernel<T, GS, GX><<<dim3(blocks, splits), kThreads, smem, stream>>>(
      x, g, g_lo, W, A, ws_a, gx, gx_ws, R, (R + splits - 1) / splits, V, P, Cin, Cout,
      Cin % kVec == 0 && aligned16(x),
      Cout % kVec == 0 && aligned16(g) && aligned16(W) && (GS == 1 || aligned16(g_lo)));
  return cudaGetLastError();
}

}  // namespace grads
}  // namespace stgx
