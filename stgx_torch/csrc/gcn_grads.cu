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
// Design (gcn_grads.cuh, which rt_fused_bwd.cu shares): all four products
// on the tensor cores (mma.sync, mma.cuh), each row's V <= 32 joints padded
// to 32. The TPU kernel carried gA and gW in VMEM across a sequential row
// grid; here the rows are cut into splits, each block sums one split into
// an fp32 partial in a workspace, and a last pass adds the partials in
// split order: no atomics, the same bits run to run.
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
#include "gcn_grads.cuh"

namespace {

using namespace stgx;
using namespace stgx::grads;

template <typename T>
int param_grads(const void* xv, const void* gv, const void* Av, const void* Wv, float* gA,
                float* gW, float* ws_w, float* ws_a, long long R, int V, int P, int Cin,
                int Cout, int splits_w, int splits_a, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gv);
  const T* A = static_cast<const T*>(Av);
  const T* W = static_cast<const T*>(Wv);
  cudaError_t e =
      launch_gw<T, 1, false>(x, g, nullptr, A, ws_w, nullptr, R, V, P, Cin, Cout, splits_w, stream);
  if (e != cudaSuccess) return (int)e;
  e = launch_ga<T, 1, false>(x, g, nullptr, W, nullptr, ws_a, nullptr, nullptr, R, V, P, Cin,
                             Cout, splits_a, stream);
  if (e != cudaSuccess) return (int)e;
  if ((e = reduce(ws_w, gW, splits_w, (long long)P * Cin * Cout, stream)) != cudaSuccess)
    return (int)e;
  const int cta_n = (Cin + kAC - 1) / kAC;
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
    return param_grads<float>(x, g, A, W, gA, gW, ws_w, ws_a, R, V, P, Cin, Cout, splits_w,
                              splits_a, s);
  if (dtype == 1)
    return param_grads<__nv_bfloat16>(x, g, A, W, gA, gW, ws_w, ws_a, R, V, P, Cin, Cout,
                                      splits_w, splits_a, s);
  return (int)cudaErrorInvalidValue;
}
