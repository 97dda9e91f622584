// Backward of the fused RT-ST-GCN layer core y = window_sum(gcn(x, A, W) + beff):
//   gy[n,t]   = sum_{j<K} g[n, t + j*s]       (frames past L are zero)
//   gx[n,t]   = gcn(gy, A^T, W^T)[n,t]         (N, L, V, Cin), x's type
//   gA, gW    = the graph conv's parameter gradients against gy, fp32
//   gbe[w,d]  = sum_{n,t} gy[n,t,w,d]           (V, Cout), fp32
//
// Replaces stgx/ops/rt_fused.py:_bwd_kernel (launched by _bwd_call).
//
// Bound on the H100: operations. The least work for (gx, gA, gW) is
// 2*P*V*(2*C_in*C_out + 3*V*C_in) flops a frame: U_p = gy W_p^T (which
// both gx and gA need), x^T U_p, T_p = x^T A_p, T_p^T gy and A_p U_p; plus
// the window's adds. Device memory sees x and g read and gx written, some
// 130-420 flops a byte in fp32 at the main path's widths.
//
// Design: gcn_grads' tensor-core kernels (gcn_grads.cuh) on gy, with gy
// formed once and gx taken from U_p.
//  * window_row_kernel (window.cuh) forms gy once per (frame, joint,
//    column), its K taps summed in fp32 in the order j = 0, 1, ... (taps past
//    a sequence's end are zero): in fp32, or as bf16 hi + lo, since gy sums
//    K bf16 values and is not one bf16 (rounding it would leave errors near
//    2^-9 of the gradients, over their fp32 tolerance; the products of gy
//    then take both parts). The TPU kernel carried the next tile's head of
//    g in VMEM across a time-reversed grid; a ring of the next H frames of g
//    beside gw_kernel's buffers does not fit in shared memory ((H + 2)
//    frames x 32 joints x 128 columns x 4 bytes at Gamma = 9 beside
//    GwSmem's 175 KB), so gy takes one pass through a workspace.
//  * gw_kernel and ga_kernel run on (x, gy) with gcn_grads' row splits, so
//    gA and gW get the unfused chain's bits in fp32; gw_kernel's blocks of
//    the first C_in tile also sum the gy they stage into gbe's partials. ga_kernel also forms
//    gx = sum_p A_p U_p from the U_p tile it forms for gA (in bf16 from U_p's
//    hi part: gx is stored in bf16), written once per row group in x's
//    type: this replaces the second graph conv the unfused
//    backward runs for gx (gcn_core on gy, A^T, W^T) with 2*P*V*V*C_in
//    flops a row. With P = 4 (two partition groups) or C_out > 256 (two
//    windows of U_p) the tiles are summed in fp32 workspace slices and
//    added in group order by window_row_kernel with one tap.
//  * The fp32 partials of gA, gW and gbe are added in split order by a
//    last pass: the same result run to run, no atomics.
#include "gcn_grads.cuh"
#include "window.cuh"

namespace {

using namespace stgx;
using namespace stgx::grads;
using bf16 = __nv_bfloat16;

template <typename T>
int backward(const void* xv, const void* gv, const void* Av, const void* Wv, void* gxv,
             float* gA, float* gW, float* gbe, float* ws_g, float* ws_w, float* ws_a,
             float* ws_be, float* ws_gx, long long R, int V, int P, int Cin, int Cout, int L,
             int K, int stride, int splits_w, int splits_a, cudaStream_t stream) {
  constexpr int GS = sizeof(T) == 4 ? 1 : 2;
  const T* x = static_cast<const T*>(xv);
  const T* A = static_cast<const T*>(Av);
  const T* W = static_cast<const T*>(Wv);
  T* gx = static_cast<T*>(gxv);
  const long long Qg = (long long)V * Cout;
  // gy in the workspace: fp32, or bf16 hi then lo
  T* G = reinterpret_cast<T*>(ws_g);
  T* G_lo = GS == 2 ? G + lo_offset(R * Qg) : nullptr;

  cudaError_t e = window_rows<T, T, true>(static_cast<const T*>(gv), 1, G, G_lo, R, L, Qg, K,
                                          stride, stream);
  if (e != cudaSuccess) return (int)e;
  if ((e = launch_gw<T, GS, true>(x, G, G_lo, A, ws_w, ws_be, R, V, P, Cin, Cout, splits_w,
                                  stream)) != cudaSuccess)
    return (int)e;
  const int pg_n = (P + kPB - 1) / kPB;
  float* gx_ws = gx != nullptr && (pg_n > 1 || Cout > kDW) ? ws_gx : nullptr;
  if ((e = launch_ga<T, GS, true>(x, G, G_lo, W, A, ws_a, gx, gx_ws, R, V, P, Cin, Cout,
                                  splits_a, stream)) != cudaSuccess)
    return (int)e;
  if (gx_ws != nullptr &&
      (e = window_rows<float, T, true>(gx_ws, pg_n, gx, nullptr, R, L, (long long)V * Cin, 1, 1,
                                       stream)) != cudaSuccess)
    return (int)e;
  if ((e = reduce(ws_w, gW, splits_w, (long long)P * Cin * Cout, stream)) != cudaSuccess)
    return (int)e;
  const int cta_n = (Cin + kAC - 1) / kAC;
  if ((e = reduce(ws_a, gA, splits_a * cta_n, (long long)P * V * V, stream)) != cudaSuccess)
    return (int)e;
  return (int)reduce(ws_be, gbe, splits_w, Qg, stream);
}

}  // namespace

// x (N, L, V, Cin), g (N, L, V, Cout), A (P, V, V), W (P, Cin, Cout), gx
// like x (or null: not formed): contiguous, one type (dtype 0 = float32,
// 1 = bfloat16). gA, gW, gbe and the workspaces are fp32: ws_g holds
// lo_offset(R * V * Cout) floats (R = N * L; window.cuh), ws_w splits_w * P
// * Cin * Cout, ws_a splits_a * ceil(Cin / 32) * P * V * V, ws_be splits_w
// * V * Cout, ws_gx ceil(P / 3) * R * V * Cin when gx is formed with P > 3
// or Cout > 256 (else it is not read). K taps spaced stride frames apart.
// Returns the CUDA error of the launches (0 on success).
extern "C" int stgx_rt_fused_bwd(const void* x, const void* g, const void* A,
                                 const void* W, void* gx, float* gA,
                                 float* gW, float* gbe, float* ws_g, float* ws_w,
                                 float* ws_a, float* ws_be, float* ws_gx, int N, int L,
                                 int V, int P, int Cin, int Cout, int K,
                                 int stride, int splits_w, int splits_a, int dtype,
                                 void* stream) {
  const long long R = (long long)N * L;
  if (N <= 0 || L <= 0 || R > 2147483647LL || V < 1 || V > stgx::kMaxV ||
      P < 1 || P > stgx::kMaxP || Cin < 1 || Cout < 1 || K < 1 ||
      stride < 1 || splits_w < 1 || splits_w > 65535 || splits_a < 1 ||
      splits_a > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(x, g, A, W, gx, gA, gW, gbe, ws_g, ws_w, ws_a, ws_be, ws_gx, R, V,
                           P, Cin, Cout, L, K, stride, splits_w, splits_a, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(x, g, A, W, gx, gA, gW, gbe, ws_g, ws_w, ws_a, ws_be,
                                   ws_gx, R, V, P, Cin, Cout, L, K, stride, splits_w,
                                   splits_a, s);
  return (int)cudaErrorInvalidValue;
}
