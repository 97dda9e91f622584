// The tma route of int8_gemm with a left operand in bf16, quantized inside the product (form b; form c over bf16 state).
// Replaces stgx/bench/quant.py:199 (the int8 x int8 -> int32 dot_general of the
// quantized cells, XLA on the TPU). Bound on the H100, design and layouts:
// int8_gemm_tma.cuh; this file instantiates the kernel for its form, so
// that the forms compile in parallel.
#include "int8_gemm_tma.cuh"

extern "C" int stgx_int8_gemm_tma_bf16(const void* a, long long lda, long long slot_stride, int depth,
                         int top, int ctap, int dil, const void* b, long long ldb,
                         const void* s_a, const void* s_b, const void* bias, void* c,
                         void* ws, void* counters, int M, int N, int K, int bn, int nc,
                         int splits, int kper, void* stream) {
  return stgx::tma_gemm_entry<stgx::kOpInt8, stgx::kA16>(a, lda, slot_stride, depth, top, ctap, dil,
                                                     b, ldb, s_a, s_b, bias, c, ws, counters,
                                                     M, N, K, bn, nc, splits, kper, stream);
}
