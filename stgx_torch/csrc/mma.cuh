// Tensor-core and async-copy helpers of the graph-conv kernels
// (gcn_core.cuh, gcn_grads.cuh) and of int8_gemm.cu: cp.async staging with
// zero fill, the warp matrix products mma.sync m16n8k8 (TF32), m16n8k16
// (bf16) and m16n8k32 (int8), and the fragment loaders for tiles in shared
// memory.
//
// Two routes, one interface (Op::kK is the depth of one step, Op::A / Op::B
// the fragments, Op::mma adds a 16 x 8 product into an fp32 accumulator):
//  * Tf32x3, fp32 operands (gcn_grads.cuh): each value is split as v = hi + lo, hi = v
//    rounded to TF32 (10 mantissa bits, as cvt.rna.tf32.f32 rounds) and
//    lo = the rest rounded again, and a product is hi*hi + hi*lo + lo*hi on the
//    TF32 tensor cores: close to fp32 accuracy (the dropped lo*lo and the
//    rounding of lo are ~2^-22 of the product) at three tensor-core passes.
//    Plain one-pass TF32 would keep only ~2^-11 and is not used.
//  * Bf16, bf16 operands: one pass, products exact, sums in fp32.
// The tensor cores add a product into the fp32 accumulator with a rounding
// toward zero, so a long chain of mma.sync on one accumulator drifts by up
// to an ulp a step, all of one sign: the kernels start each step's chain
// (a few mma deep) from zero and add it to their running sums in fp32.
// Shared-memory tiles are stored with padded rows (pad_mk, pad_kn) so that
// the fragment loads of a warp hit 32 different banks.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace stgx {
namespace mma {

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Row length (elements) of a tile read as A with rows m and contiguous k
// ([m][k]), or as B with rows n and contiguous k ([n][k]): fp32 rows of
// 4 mod 8 words (scalar fragment loads), bf16 rows of 8 mod 16 values
// (ldmatrix: eight rows on eight different 16-byte bank groups).
template <typename T>
__host__ __device__ constexpr int pad_mk(int n) {
  return sizeof(T) == 4 ? round_up(n, 8) + 4 : round_up(n, 16) + 8;
}
// Row length of a tile whose rows are k ([k][m] read as A, [k][n] read as
// B): 8 mod 16 elements for both types.
__host__ __device__ constexpr int pad_kn(int n) { return round_up(n, 16) + 8; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Let `kernel` take `bytes` of dynamic shared memory (refused past the
// card's 227 KB).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ------------------------------------------------------------ async copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok (the
// source, still a valid address, is then not read). Both 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage a rows x cols tile of T into shared memory (row length ld): row i
// of the tile is src(i), a pointer to its first element, or nullptr for a
// row of zeros; columns at or past `valid` read as zero. With vec (every
// row pointer 16-byte aligned, valid a multiple of 16 bytes) it issues
// cp.async copies that the caller commits and waits for; else plain loads.
// `any` is some valid global address of the source tensor.
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_tile(T* dst, int ld, int rows, int cols,
                                           int valid, bool vec, const T* any,
                                           RowFn src) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = cols / kVec;  // cols is a multiple of kVec
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * kVec;
    const T* s = src(r);
    T* d = dst + r * ld + c;
    if (vec) {
      const bool ok = s != nullptr && c < valid;
      cp_async16(d, ok ? s + c : any, ok);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float v = 0.f;
        if (s != nullptr && c + j < valid) v = to_f(s[c + j]);
        d[j] = from_f<T>(v);
      }
    }
  }
}

// ------------------------------------------------------------ fragments

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// v = hi + lo as TF32 values, each rounded to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds: adding half a TF32 ulp to the bits and
// dropping the low 13 does it on the integer pipe (the conversion runs on a
// quarter-rate pipe and held the products back), and the tensor cores
// ignore the low 13 bits of a TF32 operand, so lo is passed with the half
// ulp added and its low bits left.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

// Two fp32 values as a bf16 pair hi and the bf16 pair of what hi misses:
// hi + lo keeps ~16 mantissa bits of each value.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 operands, int32 sums (int8_gemm.cu): exact, so the order of the adds
// does not matter. Fragments of lane (g = lane / 4, t = lane % 4), four
// int8 values a register, lowest k in the lowest byte: a[0] row g, k 4t..4t+3;
// a[1] row g + 8, the same k; a[2], a[3] the same rows, k 16 + 4t..;
// b[0] column g, k 4t..4t+3; b[1] column g, k 16 + 4t.. .
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The accumulator's layout: lane (g = lane / 4, t = lane % 4) holds rows g
// and g + 8, columns 2t and 2t + 1: c[0] (g, 2t), c[1] (g, 2t+1),
// c[2] (g+8, 2t), c[3] (g+8, 2t+1).

// fp32 operands on TF32 tensor cores, three passes (see the head note).
struct Tf32x3 {
  using Elem = float;
  static constexpr int kK = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // 16 x 8 A tile, element (m, k) at p[m * sm + k * sk]
  static __device__ __forceinline__ A load_a(const float* p, int sm, int sk) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    A a;
    split_tf32(p[g * sm + t * sk], a.hi[0], a.lo[0]);
    split_tf32(p[(g + 8) * sm + t * sk], a.hi[1], a.lo[1]);
    split_tf32(p[g * sm + (t + 4) * sk], a.hi[2], a.lo[2]);
    split_tf32(p[(g + 8) * sm + (t + 4) * sk], a.hi[3], a.lo[3]);
    return a;
  }
  // 8 x 8 B tile, element (k, n) at p[k * sk + n * sn]
  static __device__ __forceinline__ B load_b(const float* p, int sk, int sn) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    B b;
    split_tf32(p[t * sk + g * sn], b.hi[0], b.lo[0]);
    split_tf32(p[(t + 4) * sk + g * sn], b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ A load_a_mk(const float* p, int ld) { return load_a(p, ld, 1); }
  static __device__ __forceinline__ A load_a_km(const float* p, int ld) { return load_a(p, 1, ld); }
  static __device__ __forceinline__ B load_b_kn(const float* p, int ld) { return load_b(p, ld, 1); }
  static __device__ __forceinline__ B load_b_nk(const float* p, int ld) { return load_b(p, 1, ld); }

  // the small terms first, then hi * hi
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
};

// bf16 operands, one pass.
struct Bf16 {
  using Elem = __nv_bfloat16;
  static constexpr int kK = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  // 16 x 16 A tile stored [m][k] (k contiguous, row length ld)
  static __device__ __forceinline__ A load_a_mk(const Elem* p, int ld) {
    const int l = lane_id();
    A a;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
                 : "r"(smem_addr(p + (l & 15) * ld + (l >> 4) * 8)));
    return a;
  }
  // 16 x 16 A tile stored [k][m] (m contiguous)
  static __device__ __forceinline__ A load_a_km(const Elem* p, int ld) {
    const int l = lane_id(), i = l >> 3, j = l & 7;
    A a;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
                 : "r"(smem_addr(p + (j + 8 * (i >> 1)) * ld + 8 * (i & 1))));
    return a;
  }
  // 16 x 8 B tile stored [k][n] (n contiguous)
  static __device__ __forceinline__ B load_b_kn(const Elem* p, int ld) {
    const int l = lane_id() & 15;
    B b;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b.r[0]), "=r"(b.r[1])
                 : "r"(smem_addr(p + l * ld)));
    return b;
  }
  // 16 x 8 B tile stored [n][k] (k contiguous)
  static __device__ __forceinline__ B load_b_nk(const Elem* p, int ld) {
    const int l = lane_id() & 15;
    B b;
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(b.r[0]), "=r"(b.r[1])
                 : "r"(smem_addr(p + (l & 7) * ld + (l >> 3) * 8)));
    return b;
  }
  // 16 x 8 B tile of fp32 values stored [n][k], as bf16 hi and lo parts
  static __device__ __forceinline__ void load_b_nk_split(const float* p, int ld, B& hi,
                                                         B& lo) {
    const int g = lane_id() >> 2, t = lane_id() & 3;
    const float2 v0 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
    const float2 v1 = *reinterpret_cast<const float2*>(p + g * ld + 2 * t + 8);
    split_bf16x2(v0.x, v0.y, hi.r[0], lo.r[0]);
    split_bf16x2(v1.x, v1.y, hi.r[1], lo.r[1]);
  }

  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

// The route of an element type: Tf32x3 for float, Bf16 for bf16.
template <typename T>
struct RouteOf;
template <>
struct RouteOf<float> { using Op = Tf32x3; };
template <>
struct RouteOf<__nv_bfloat16> { using Op = Bf16; };

}  // namespace mma
}  // namespace stgx
