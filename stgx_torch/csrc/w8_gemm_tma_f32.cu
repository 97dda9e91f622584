// The tma route of w8_gemm with a left operand in fp32 in two TF32 halves (forms a and c over fp32 state).
// Replaces stgx/bench/quant.py:194 (the w8 (int8 weight widened) dot_general of the
// quantized cells, XLA on the TPU). Bound on the H100, design and layouts:
// int8_gemm_tma.cuh; this file instantiates the kernel for its form, so
// that the forms compile in parallel.
#include "int8_gemm_tma.cuh"

extern "C" int stgx_w8_gemm_tma_f32(const void* a, long long lda, long long slot_stride, int depth,
                         int top, int ctap, int dil, const void* b, long long ldb,
                         const void* s_a, const void* s_b, const void* bias, void* c,
                         void* ws, void* counters, int M, int N, int K, int bn, int nc,
                         int splits, int kper, void* stream) {
  return stgx::tma_gemm_entry<stgx::kOpW8, stgx::kA32>(a, lda, slot_stride, depth, top, ctap, dil,
                                                     b, ldb, s_a, s_b, bias, c, ws, counters,
                                                     M, N, K, bn, nc, splits, kper, stream);
}
