// Parameter gradients of the graph-conv core against an upstream gradient g:
//   gA[p,v,w] = sum_{r,c,d} x[r,v,c] * g[r,w,d] * W[p,c,d]       (P, V, V)
//   gW[p,c,d] = sum_{r,v,w} x[r,v,c] * A[p,v,w] * g[r,w,d]       (P, Cin, Cout)
// both in fp32, summed over all R rows.
//
// Replaces stgx/ops/pallas_gcn.py:_grads_kernel (launched by _grads_impl).
//
// Bound on the H100: operations. A row r costs 4*P*V*C_in*(V + C_out)
// flops (twice the forward's: T_p and T_p^T g for gW, U_p = g W_p^T and
// x^T U_p for gA) against (C_in + C_out)*V values read; the outputs are a
// few hundred KB. At the main path's widths that is 130-420 flops a byte in
// fp32, far above the card's 20 (67 TFLOP/s over 3.35 TB/s).
//
// Design (grads.cuh): the TPU kernel carried gA and gW in VMEM across a
// sequential row grid. Here the rows are cut into splits; one kernel sums
// gW over each split in a 64 x 64 (c, d) register tile per block with the
// aggregate T_p = x^T A_p formed in shared memory, another sums gA over
// each split from the tile U_p = g W_p^T, and a third pass adds the fp32
// partials in split order, so the result does not change from run to run.
// The host picks the split counts so that each kernel fills the card with
// about two waves of blocks. Plain fp32 FMAs, no tensor cores.
#include "grads.cuh"

// x (R, V, Cin), g (R, V, Cout), A (P, V, V), W (P, Cin, Cout): contiguous,
// one type (dtype 0 = float32, 1 = bfloat16). gA, gW and the workspaces are
// fp32 (sizes in grads.cuh). Returns the CUDA error of the launches (0 on
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
  // taps = 1: the row gradient is g itself (L = R keeps every row in range)
  if (dtype == 0)
    return stgx::grads<float>(x, g, A, W, nullptr, gA, gW, nullptr, ws_w,
                              ws_a, nullptr, R, V, P, Cin, Cout, (int)R, 1, 1,
                              splits_w, splits_a, s);
  if (dtype == 1)
    return stgx::grads<__nv_bfloat16>(x, g, A, W, nullptr, gA, gW, nullptr,
                                      ws_w, ws_a, nullptr, R, V, P, Cin, Cout,
                                      (int)R, 1, 1, splits_w, splits_a, s);
  return (int)cudaErrorInvalidValue;
}
