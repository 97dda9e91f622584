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
// Design (grads.cuh): the TPU grid ran time-reversed and carried the next
// tile's head of g in scratch. Here gy is formed as g is staged into
// shared memory: each G value sums its K taps of g (the halo is a re-read
// of up to (K-1)*s frames past the block's rows, served from cache), and
// gy never reaches device memory. One kernel sums gW (and gbe) over row
// splits; the other forms U_p per 64-wide c tile and takes gx = A_p U_p
// and gA = x^T U_p from it, so gx costs V*C_in flops a joint on top of the
// U_p that gA needs anyway, not a second graph conv. The fp32 partials of
// gA, gW and gbe are added in split order by a last pass: no atomics, the
// same result run to run. Rows are (n, t) flattened; a window never leaves
// its sequence, so the ragged last tile and stride 2 (4 taps, a 6-frame
// halo) need no special case.
#include "grads.cuh"

// x (N, L, V, Cin), g (N, L, V, Cout), A (P, V, V), W (P, Cin, Cout), gx
// like x: contiguous, one type (dtype 0 = float32, 1 = bfloat16). gA, gW,
// gbe and the workspaces are fp32 (sizes in grads.cuh). K taps spaced
// stride frames apart. Returns the CUDA error of the launches (0 on
// success).
extern "C" int stgx_rt_fused_bwd(const void* x, const void* g, const void* A,
                                 const void* W, void* gx, float* gA,
                                 float* gW, float* gbe, float* ws_w,
                                 float* ws_a, float* ws_be, int N, int L,
                                 int V, int P, int Cin, int Cout, int K,
                                 int stride, int splits_w, int splits_a,
                                 int dtype, void* stream) {
  const long long R = (long long)N * L;
  if (N <= 0 || L <= 0 || R > 2147483647LL || V < 1 || V > stgx::kMaxV ||
      P < 1 || P > stgx::kMaxP || Cin < 1 || Cout < 1 || K < 1 ||
      stride < 1 || splits_w < 1 || splits_w > 65535 || splits_a < 1 ||
      splits_a > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return stgx::grads<float>(x, g, A, W, gx, gA, gW, gbe, ws_w, ws_a, ws_be,
                              R, V, P, Cin, Cout, L, K, stride, splits_w,
                              splits_a, s);
  if (dtype == 1)
    return stgx::grads<__nv_bfloat16>(x, g, A, W, gx, gA, gW, gbe, ws_w, ws_a,
                                      ws_be, R, V, P, Cin, Cout, L, K, stride,
                                      splits_w, splits_a, s);
  return (int)cudaErrorInvalidValue;
}
