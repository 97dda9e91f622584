// The int8 products of the quantized streaming cells on Hopper's tensor
// cores, fed by TMA (the "tma" route of ops/int8_gemm.py). One kernel
// family, instantiated by form in int8_gemm_tma_*.cu and w8_gemm_tma_*.cu
// (one nvcc each, compiled in parallel):
//
//   int8: C[m,n] = float(sum_k q(A)[m,k] * B[k,n]) * (s_a * s_b[n]) (+ bias[n]),
//         wgmma m64nNk32 s8 -> s32, the int32 sum exact;
//   w8:   C[m,n] = (sum_k A[m,k] * float(B[k,n])) * s_b[n] (+ bias[n]),
//         wgmma m64nNk8 tf32 -> f32 on A split as hi + lo (two passes).
//
// Replaces stgx/bench/quant.py:199 (the int8 x int8 -> int32 dot_general
// of int8_matmul, XLA on the TPU's MXU; :189 for an input already in int8)
// and :194 (the w8 dot_general, the weight widened inside it). Neither is a
// Pallas kernel. B is the int8 weight in the kernels' layout (column n's K
// codes contiguous: K-major, as int8 wgmma wants both operands).
//
// The left operand A is read once, in the form the cell holds it:
//  (a) int8 codes (int8 FIFO state, an input stored quantized);
//  (b) fp32 or bf16, quantized on the way from its staged tile to the
//      wgmma operand: clamp(rint(x / s_a), -127, 127) with an IEEE division
//      and half-to-even rounding, the codes of the cells' plain quantize;
//  (c) CoST-GCN's FIFO taps: a (depth, rows, C) FIFO whose column
//      k = tap * C + c of row m is slot top - tap * dil. A is always a 3-D
//      tensor map (c, row, slot); the plain forms are one slot of C = K.
//
// Bound on the H100: the bytes (A, B, the fp32 output once each) over
// 3.35 TB/s against 2*M*N*K operations over 1,979 TOP/s (int8) or, for w8
// on TF32 tensor cores, two passes at 495 TFLOP/s. At the cells' shapes
// (K <= 17,664, N <= 256) int8 is bytes-bound everywhere; w8 is bytes-bound
// up to K in the hundreds at large M and near its two-pass TF32 line at
// CoST at Gamma = 69's tcn (K = 17,664).
//
// Design, for that bound:
//  * one block per SM, persistent over its work items (an output tile of
//    64 * nc rows x BN columns, BN in {64, 128, 256} the site's whole width
//    up to 256, and a split of K); one thread of a producer warpgroup keeps a
//    ring of stages (A and B tiles, 64 k a stage for int8, 32 for w8) in
//    flight with TMA and mbarriers while nc consumer warpgroups (1 or 2)
//    multiply, with the registers moved to them (setmaxnreg 40 / 232); each
//    keeps one group of products in flight, writing the next stage's operand
//    tiles (codes, widened weight, split A) while the last stage's run; w8's
//    consumers share the widened weight tile, each widening half its rows;
//  * int8: the int8 A tile and the weight tile arrive in the 64-byte
//    swizzled layout wgmma reads; an fp32 or bf16 A tile arrives unswizzled
//    and each consumer writes its codes into a swizzled operand tile;
//  * w8: the weight's codes are integers |q| <= 127, exact in TF32, widened
//    once a stage into a 128-byte swizzled fp32 tile; fp32 A is split in
//    place into hi = its top 19 bits (exact in TF32) and lo = x - hi (exact
//    in fp32), and the two passes carry ~21 bits of x; bf16 A is exact in
//    TF32 and takes one pass (lo = 0);
//  * few output tiles and a deep K (small M): K split over the blocks (at
//    most 16 ways), in the same launch: each split writes its partial (int32
//    or fp32) to a workspace, the last block to finish a tile (a counter in
//    device memory, reset by that block for the next call) adds the
//    partials in split order (fp32: a fixed order, so a run repeats bit for
//    bit) and applies the epilogue;
//  * the epilogue rounds as the plain version does (__fmul_rn(sa, s_b[n]),
//    its product with float(acc), __fadd_rn with the bias), stages 64
//    columns at a time in shared memory and stores rows with 16-byte stores.
// The tensor maps are encoded on the host (cuTensorMapEncodeTiled, found
// through the CUDA runtime) and passed as __grid_constant__
// parameters: no copy to the device, so a step captures in a CUDA graph.
// s_a is read from device memory.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace stgx {
namespace {

enum { kOpInt8 = 0, kOpW8 = 1 };
enum { kA8 = 0, kA32 = 1, kA16 = 2 };  // A as int8 codes, fp32, bf16
constexpr int kMaxNc = 2;              // consumer warpgroups
constexpr int kEpiLd = 72;             // floats a staged output row: 64 + 8
constexpr int kMaxStages = 8;

__host__ __device__ constexpr int kstage(int op) { return op == kOpInt8 ? 64 : 32; }
__host__ __device__ constexpr int asize(int at) { return at == kA8 ? 1 : at == kA32 ? 4 : 2; }
__host__ __device__ inline int align1k(int x) { return (x + 1023) & ~1023; }

// Byte offsets into the block's shared memory (its base aligned to 1024).
struct Layout {
  int a_stage, stage, opa, opa_bytes, opb, epi, bars, total;
};

__host__ __device__ inline Layout layout(int op, int at, int bn, int nc, int stages) {
  Layout L;
  const int ks = kstage(op);
  L.a_stage = align1k(64 * nc * ks * asize(at));
  L.stage = L.a_stage + align1k(bn * ks);  // + the weight tile, ks bytes a row
  int off = stages * L.stage;
  // a consumer's two operand tiles (one written while the products of the
  // other run): int8 codes (64 rows x 64 B) for an fp32 or bf16 A; w8: A's
  // low half, or bf16 A widened (64 rows x 128 B)
  L.opa_bytes = op == kOpInt8 ? (at == kA8 ? 0 : 64 * 64) : 64 * 128;
  L.opa = off;
  off += nc * 2 * L.opa_bytes;
  L.opb = off;  // w8: the weight widened, two tiles of bn rows x 128 B
  off += op == kOpW8 ? 2 * bn * 128 : 0;
  L.epi = off;
  off += nc * 64 * kEpiLd * 4;
  L.bars = off;
  off += 2 * stages * 8 + 8;
  L.total = off;
  return L;
}

struct Params {
  const float* s_a;
  const float* s_b;
  const float* bias;
  float* c;
  void* ws;       // (splits, M, N) partials when splits > 1
  int* counters;  // one a tile, zero between calls
  int M, N, ctap, dil, top;
  int splits, kper, ktiles, m_tiles, items, nc, stages;
};

__device__ __forceinline__ void decode(const Params& p, int bn, int w, int& z, int& m0, int& n0) {
  z = w % p.splits;
  const int t = w / p.splits;
  m0 = (t % p.m_tiles) * 64 * p.nc;
  n0 = (t / p.m_tiles) * bn;
}

template <int BN>
__device__ __forceinline__ void mma_s8(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) hop::wgmma_s8_n64(d, a, b);
  if constexpr (BN == 128) hop::wgmma_s8_n128(d, a, b);
  if constexpr (BN == 256) hop::wgmma_s8_n256(d, a, b);
}

template <int BN>
__device__ __forceinline__ void mma_tf32(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) hop::wgmma_tf32_n64(d, a, b);
  if constexpr (BN == 128) hop::wgmma_tf32_n128(d, a, b);
  if constexpr (BN == 256) hop::wgmma_tf32_n256(d, a, b);
}

// x / s rounded to nearest (IEEE division), given rs = RN(1/s): q0 = x rs is
// within 2 ulp, one fma-based correction makes it faithful, and a second is
// then the correctly rounded quotient (Markstein); its residual is exact.
// The operands of a quantize stay far from underflow where the code is not
// 0 (|x / s| >= 1/2 with s >= 1e-12 / 127). An infinite q0 (x infinite, or
// x rs past fp32's range, where x / s is past the clamp too) is returned as
// it is: the corrections would make it NaN, whose code is 0, not +-127.
__device__ __forceinline__ float div_rn(float x, float s, float rs) {
  float q = __fmul_rn(x, rs);
  if (isinf(q)) return q;
  q = __fmaf_rn(__fmaf_rn(-q, s, x), rs, q);
  return __fmaf_rn(__fmaf_rn(-q, s, x), rs, q);
}

__device__ __forceinline__ uint32_t code4(const float (&v)[4], float sa, float rsa) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int q = __float2int_rn(div_rn(v[j], sa, rsa));
    q = max(-127, min(127, q));
    w |= (uint32_t)(q & 0xff) << (8 * j);
  }
  return w;
}

__device__ __forceinline__ void bf16x4(uint2 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// int8, an fp32 or bf16 A: a consumer's staged rows of 64 k (unswizzled) to
// codes in the 64-byte swizzled operand tile, a word of 4 codes a thread;
// rows at or past `rows` (past M) are left as they are: their products
// reach no stored output.
template <int AT>
__device__ __forceinline__ void quantize_tile(uint8_t* opa, const uint8_t* raw, float sa,
                                              float rsa, int rows, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = i >> 4, w = i & 15;
    if (r >= rows) break;
    float v[4];
    if constexpr (AT == kA32) {
      const float4 f = reinterpret_cast<const float4*>(raw + r * 256)[w];
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      bf16x4(reinterpret_cast<const uint2*>(raw + r * 128)[w], v);
    }
    const int chunk = (w >> 2) ^ ((r >> 1) & 3);
    *reinterpret_cast<uint32_t*>(opa + r * 64 + chunk * 16 + (w & 3) * 4) = code4(v, sa, rsa);
  }
}

// w8: the weight's staged rows [row0, row0 + ROWS) of 32 codes to fp32 in
// the 128-byte swizzled operand tile.
template <int ROWS>
__device__ __forceinline__ void widen_weight(uint8_t* opb, const uint8_t* raw, int row0,
                                             int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * 8; i += 128) {
    const int n = row0 + (i >> 3), j = i & 7;
    const uint32_t u = reinterpret_cast<const uint32_t*>(raw + n * 32)[j];
    const float4 f = make_float4((float)(int8_t)(u & 0xff), (float)(int8_t)((u >> 8) & 0xff),
                                 (float)(int8_t)((u >> 16) & 0xff), (float)(int8_t)(u >> 24));
    *reinterpret_cast<float4*>(opb + n * 128 + ((j ^ (n & 7)) << 4)) = f;
  }
}

// w8, fp32 A: split the 128-byte swizzled tile in place into hi (x with its
// low 13 mantissa bits cleared: exact in TF32) and write lo = x - hi (exact)
// at the same offsets of `lo`; rows at or past `rows` as quantize_tile's.
__device__ __forceinline__ void split_tile(uint8_t* a, uint8_t* lo, int rows, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 8; i += 128) {
    if ((i >> 3) >= rows) break;
    float4 x = reinterpret_cast<float4*>(a)[i];
    float4 h;
    h.x = __uint_as_float(__float_as_uint(x.x) & 0xffffe000u);
    h.y = __uint_as_float(__float_as_uint(x.y) & 0xffffe000u);
    h.z = __uint_as_float(__float_as_uint(x.z) & 0xffffe000u);
    h.w = __uint_as_float(__float_as_uint(x.w) & 0xffffe000u);
    reinterpret_cast<float4*>(a)[i] = h;
    reinterpret_cast<float4*>(lo)[i] =
        make_float4(__fsub_rn(x.x, h.x), __fsub_rn(x.y, h.y), __fsub_rn(x.z, h.z),
                    __fsub_rn(x.w, h.w));
  }
}

// w8, bf16 A: staged rows of 32 values (unswizzled) widened into the
// 128-byte swizzled operand tile; rows at or past `rows` as quantize_tile's.
__device__ __forceinline__ void widen_bf16(uint8_t* op, const uint8_t* raw, int rows, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i >> 3, j = i & 7;
    if (r >= rows) break;
    float v[4];
    bf16x4(reinterpret_cast<const uint2*>(raw + r * 64)[j], v);
    *reinterpret_cast<float4*>(op + r * 128 + ((j ^ (r & 7)) << 4)) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int OP>
__device__ __forceinline__ float epilogue(
    typename std::conditional<OP == kOpInt8, int, float>::type acc, float sa,
    const float* s_b, const float* bias, int n) {
  float y = OP == kOpInt8 ? __fmul_rn(__int2float_rn((int)acc), __fmul_rn(sa, s_b[n]))
                          : __fmul_rn((float)acc, s_b[n]);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  return y;
}

template <int OP, int AT, int BN>
__global__ void __launch_bounds__(128 * (kMaxNc + 1), 1)
    tma_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, const Params p) {
  using Acc = typename std::conditional<OP == kOpInt8, int, float>::type;
  constexpr int KS = kstage(OP);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(OP, AT, BN, p.nc, p.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  volatile int* last_flag = reinterpret_cast<volatile int*>(empty + p.stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * p.nc);  // one arrival a consumer warp
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * p.nc) {  // the producer warpgroup: one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * p.nc) {
      hop::tma_prefetch(&tmA);
      hop::tma_prefetch(&tmB);
      const uint32_t tx = (uint32_t)(64 * p.nc * KS * asize(AT) + BN * KS);
      int s = 0;
      uint32_t ph = 0;
      for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
        int z, m0, n0;
        decode(p, BN, w, z, m0, n0);
        const int kt1 = imin(p.ktiles, (z + 1) * p.kper);
        for (int kt = z * p.kper; kt < kt1; ++kt) {
          hop::mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = smem + s * L.stage;
          hop::mbar_expect_tx(&full[s], tx);
          const int k0 = kt * KS, tap = k0 / p.ctap;
          hop::tma_load_3d(st, &tmA, &full[s], k0 - tap * p.ctap, m0, p.top - tap * p.dil);
          hop::tma_load_2d(st + L.a_stage, &tmB, &full[s], k0, n0);
          if (++s == p.stages) s = 0, ph ^= 1;
        }
      }
    }
  } else {  // a consumer warpgroup: rows [64 cg, 64 cg + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cg = warp >> 2, tid = threadIdx.x & 127, wq = warp & 3;
    const int nthreads = 128 * p.nc;
    const float sa = OP == kOpInt8 ? *p.s_a : 1.f, rsa = __frcp_rn(sa);
    float* epi = reinterpret_cast<float*>(smem + L.epi) + cg * 64 * kEpiLd;
    uint8_t* opa = smem + L.opa + cg * 2 * L.opa_bytes;
    const long long mn = (long long)p.M * p.N;
    Acc acc[BN / 2];
    int s = 0;
    uint32_t ph = 0;
    for (int w = blockIdx.x; w < p.items; w += gridDim.x) {
      int z, m0, n0;
      decode(p, BN, w, z, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      // one group of products in flight: stage kt's are issued before stage
      // kt - 1's are waited for, and the ring slot and operand tile of a
      // stage are released only once its products are done
      const int kt0 = z * p.kper, kt1 = imin(p.ktiles, kt0 + p.kper);
      int held = -1;  // the ring slot of the products in flight
      for (int kt = kt0; kt < kt1; ++kt) {
        hop::mbar_wait(&full[s], ph);
        const int buf = (kt - kt0) & 1;
        uint8_t* st = smem + s * L.stage;
        uint8_t* a_raw = st + cg * 64 * KS * asize(AT);
        uint8_t* b_raw = st + L.a_stage;
        uint8_t* oa = opa + buf * L.opa_bytes;
        if constexpr (OP == kOpInt8) {
          const uint8_t* a_op = a_raw;
          if constexpr (AT != kA8) {
            hop::bar_sync(2 + cg, 128);  // every warp is past the products that read oa
            quantize_tile<AT>(oa, a_raw, sa, rsa, p.M - m0 - 64 * cg, tid);
            hop::fence_proxy_async();
            hop::bar_sync(2 + cg, 128);
            a_op = oa;
          }
          hop::fence_regs(acc);
          hop::wg_fence();
          const uint64_t da = hop::smem_desc(a_op, 2, 512), db = hop::smem_desc(b_raw, 2, 512);
          mma_s8<BN>(acc, da, db);
          mma_s8<BN>(acc, da + 2, db + 2);  // the second 32 bytes of k
        } else {
          // the weight tile is shared: each consumer widens its share of the rows
          uint8_t* ob = smem + L.opb + buf * BN * 128;
          hop::bar_sync(1, nthreads);  // every warp is past the products that read oa, ob
          if (p.nc == 1)
            widen_weight<BN>(ob, b_raw, 0, tid);
          else
            widen_weight<BN / 2>(ob, b_raw, cg * (BN / 2), tid);
          if constexpr (AT == kA32)
            split_tile(a_raw, oa, p.M - m0 - 64 * cg, tid);
          else
            widen_bf16(oa, a_raw, p.M - m0 - 64 * cg, tid);
          hop::fence_proxy_async();
          hop::bar_sync(1, nthreads);
          hop::fence_regs(acc);
          hop::wg_fence();
          const uint64_t dh = hop::smem_desc(AT == kA32 ? a_raw : oa, 1, 1024);
          const uint64_t db = hop::smem_desc(ob, 1, 1024);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_tf32<BN>(acc, dh + 2 * j, db + 2 * j);
          if constexpr (AT == kA32) {
            const uint64_t dl = hop::smem_desc(oa, 1, 1024);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_tf32<BN>(acc, dl + 2 * j, db + 2 * j);
          }
        }
        hop::wg_commit();
        hop::wg_wait_one();  // the previous stage's products are done
        hop::fence_regs(acc);
        if (held >= 0) {
          __syncwarp();
          if (lane == 0) hop::mbar_arrive(&empty[held]);
        }
        held = s;
        if (++s == p.stages) s = 0, ph ^= 1;
      }
      hop::wg_wait_all();
      hop::fence_regs(acc);
      if (held >= 0) {
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(&empty[held]);
      }

      const int r0 = 16 * wq + (lane >> 2), cq = 2 * (lane & 3);
      const int mrow = m0 + 64 * cg;
      if (p.splits > 1) {  // this split's partial; the last split of the tile finishes it
        Acc* part = static_cast<Acc*>(p.ws) + z * mn;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mrow + r0 + 8 * h, n = n0 + 8 * j + cq;
            if (m < p.M && n < p.N) {
              Acc* q = part + (long long)m * p.N + n;
              if constexpr (OP == kOpInt8)
                *reinterpret_cast<int2*>(q) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
              else
                *reinterpret_cast<float2*>(q) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
          }
        __threadfence();
        hop::bar_sync(1, nthreads);
        if (threadIdx.x == 0) {
          const int tile = w / p.splits;
          const int last = atomicAdd(&p.counters[tile], 1) == p.splits - 1;
          if (last) p.counters[tile] = 0;  // every split has counted: ready for the next call
          *last_flag = last;
        }
        hop::bar_sync(1, nthreads);
        if (!*last_flag) continue;
        __threadfence();
        // the last split of the tile: every split's partial (this one's too,
        // read back) added in split order, 4 columns a thread, coalesced,
        // then the epilogue, stored
        for (int cb = 0; cb < BN && n0 + cb < p.N; cb += 64) {
#pragma unroll 4
          for (int i = tid; i < 64 * 16; i += 128) {
            const int r = i >> 4, q = i & 15;
            const int m = mrow + r, n = n0 + cb + 4 * q;
            if (m >= p.M || n >= p.N) continue;
            const long long at = (long long)m * p.N + n;
            float t[4];
            if constexpr (OP == kOpInt8) {
              int4 u = make_int4(0, 0, 0, 0);
              for (int zz = 0; zz < p.splits; ++zz) {
                const int4 v = __ldcg(reinterpret_cast<const int4*>(
                    static_cast<const int*>(p.ws) + zz * mn + at));
                u.x += v.x, u.y += v.y, u.z += v.z, u.w += v.w;
              }
              t[0] = epilogue<OP>(u.x, sa, p.s_b, p.bias, n);
              t[1] = epilogue<OP>(u.y, sa, p.s_b, p.bias, n + 1);
              t[2] = epilogue<OP>(u.z, sa, p.s_b, p.bias, n + 2);
              t[3] = epilogue<OP>(u.w, sa, p.s_b, p.bias, n + 3);
            } else {
              float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
              for (int zz = 0; zz < p.splits; ++zz) {
                const float4 v = __ldcg(reinterpret_cast<const float4*>(
                    static_cast<const float*>(p.ws) + zz * mn + at));
                u.x = __fadd_rn(u.x, v.x), u.y = __fadd_rn(u.y, v.y);
                u.z = __fadd_rn(u.z, v.z), u.w = __fadd_rn(u.w, v.w);
              }
              t[0] = epilogue<OP>(u.x, sa, p.s_b, p.bias, n);
              t[1] = epilogue<OP>(u.y, sa, p.s_b, p.bias, n + 1);
              t[2] = epilogue<OP>(u.z, sa, p.s_b, p.bias, n + 2);
              t[3] = epilogue<OP>(u.w, sa, p.s_b, p.bias, n + 3);
            }
            *reinterpret_cast<float4*>(p.c + at) = make_float4(t[0], t[1], t[2], t[3]);
          }
        }
        continue;
      }

      // the epilogue, 64 columns at a time, through shared memory
#pragma unroll
      for (int cb = 0; cb < BN; cb += 64) {
        if (n0 + cb < p.N) {
          hop::bar_sync(2 + cg, 128);  // the last chunk's rows are stored
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int j = cb / 8 + jj, n = n0 + cb + 8 * jj + cq;
              float2 y = make_float2(0.f, 0.f);
              if (n < p.N) {
                y.x = epilogue<OP>(acc[4 * j + 2 * h], sa, p.s_b, p.bias, n);
                y.y = epilogue<OP>(acc[4 * j + 2 * h + 1], sa, p.s_b, p.bias, n + 1);
              }
              *reinterpret_cast<float2*>(epi + (r0 + 8 * h) * kEpiLd + 8 * jj + cq) = y;
            }
          hop::bar_sync(2 + cg, 128);
#pragma unroll 4
          for (int i = tid; i < 64 * 16; i += 128) {
            const int r = i >> 4, q = i & 15;
            const int m = mrow + r, n = n0 + cb + 4 * q;
            if (m < p.M && n < p.N)
              *reinterpret_cast<float4*>(p.c + (long long)m * p.N + n) =
                  *reinterpret_cast<const float4*>(epi + r * kEpiLd + 4 * q);
          }
        }
      }
    }
  }
}

int g_sms = 0;

template <int OP, int AT, int BN>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const Params& p,
                   cudaStream_t st) {
  auto kern = tma_gemm_kernel<OP, AT, BN>;
  const size_t bytes = (size_t)layout(OP, AT, BN, p.nc, p.stages).total + 1024;
  cudaError_t err = mma::allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  const int grid = imin(p.items, g_sms);
  kern<<<grid, 128 * (p.nc + 1), bytes, st>>>(ma, mb, p);
  return cudaGetLastError();
}

template <int OP, int AT>
cudaError_t launch_bn(int bn, const CUtensorMap& ma, const CUtensorMap& mb, const Params& p,
                      cudaStream_t st) {
  if (bn == 64) return launch<OP, AT, 64>(ma, mb, p, st);
  if (bn == 128) return launch<OP, AT, 128>(ma, mb, p, st);
  if (bn == 256) return launch<OP, AT, 256>(ma, mb, p, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace stgx

// The host side of one form (op: int8 or w8; a_type: int8 codes, fp32 or
// bf16), which each instance file (int8_gemm_tma_*.cu, w8_gemm_tma_*.cu)
// exposes as a C function. A: `depth` slots `slot_stride` elements apart,
// each M rows `lda` elements apart of `ctap` columns; column k = tap * ctap + c of row m is slot top - tap * dil (the
// plain forms: depth 1, ctap = K, dil 0). B (K, N) int8 column-major, column
// n at b + n * ldb. s_a (int8 only) one fp32 in device memory; s_b, bias
// (nullable) (N,) fp32; C (M, N) fp32 contiguous, N a multiple of 4. bn in
// {64, 128, 256}, nc in {1, 2}; splits > 1 needs ws ((splits, M, N)
// int32 or fp32) and counters (zeroed, one a tile). Split z takes the k
// tiles from z * kper. Returns the launch's CUDA error.
namespace stgx {
namespace {

template <int op, int a_type>
int tma_gemm_entry(const void* a, long long lda, long long slot_stride, int depth, int top,
                   int ctap, int dil, const void* b, long long ldb, const void* s_a,
                   const void* s_b, const void* bias, void* c, void* ws, void* counters, int M,
                   int N, int K, int bn, int nc, int splits, int kper, void* stream) {
  static_assert(!(op == kOpW8 && a_type == kA8), "w8 takes an fp32 or bf16 operand");
  if (M <= 0 || N <= 0) return 0;
  const bool bad = nc < 1 || nc > kMaxNc || splits < 1 ||
                   (splits > 1 && (ws == nullptr || counters == nullptr)) || N % 4 != 0 ||
                   (depth > 1 && ctap % kstage(op) != 0);
  if (bad) return (int)cudaErrorInvalidValue;
  if (g_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int ks = kstage(op), es = asize(a_type);
  const int fixed = layout(op, a_type, bn, nc, 0).total;
  const int per = layout(op, a_type, bn, nc, 1).total - fixed;
  const int stages = imin(kMaxStages, (kMaxSmem - 1024 - fixed) / per);
  if (stages < 2) return (int)cudaErrorInvalidValue;

  static const CUtensorMapDataType types[3] = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                               CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                               CU_TENSOR_MAP_DATA_TYPE_BFLOAT16};
  const CUtensorMapSwizzle swz_a =
      op == kOpInt8 ? (a_type == kA8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE)
                    : (a_type == kA32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  CUtensorMap ma, mb;
  const uint64_t dims_a[3] = {(uint64_t)ctap, (uint64_t)M, (uint64_t)depth};
  const uint64_t strides_a[2] = {(uint64_t)lda * es, (uint64_t)slot_stride * es};
  const uint32_t box_a[3] = {(uint32_t)ks, (uint32_t)(64 * nc), 1};
  const uint64_t dims_b[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t strides_b[1] = {(uint64_t)ldb};
  const uint32_t box_b[2] = {(uint32_t)ks, (uint32_t)bn};
  if (!hop::make_map(&ma, types[a_type], 3, a, dims_a, strides_a, box_a, swz_a) ||
      !hop::make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, dims_b, strides_b, box_b,
                     op == kOpInt8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;

  Params p;
  p.s_a = static_cast<const float*>(s_a);
  p.s_b = static_cast<const float*>(s_b);
  p.bias = static_cast<const float*>(bias);
  p.c = static_cast<float*>(c);
  p.ws = ws;
  p.counters = static_cast<int*>(counters);
  p.M = M, p.N = N, p.ctap = ctap, p.dil = dil, p.top = top;
  p.splits = splits, p.kper = kper, p.ktiles = (K + ks - 1) / ks;
  p.m_tiles = (M + 64 * nc - 1) / (64 * nc);
  p.items = p.m_tiles * ((N + bn - 1) / bn) * splits;
  p.nc = nc, p.stages = stages;
  return (int)launch_bn<op, a_type>(bn, ma, mb, p, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace stgx
