// Building blocks the port's tensor-core kernels share (paged_tiles.cu,
// q4_matmul.cu, ssd_scan.cu): cp.async staging, ldmatrix, the bf16
// mma.sync m16n8k16 product, and f32 values split into bf16 pieces.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// bf16 pieces an operand of type T enters the products as: an f32 x is
// p0 + p1 + p2 to 24 bits; bf16, and int8 (|x| <= 127), are exact in one.
template <typename T> struct Pieces { static constexpr int n = 1; };
template <> struct Pieces<float> { static constexpr int n = 3; };

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !live (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col); registers
// only, so not volatile: the compiler may schedule it around the loads
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the NP bf16 pieces of the pair (a, b), largest first, each as a packed
// bf16x2 (a in the low half); each residual is exact in f32
template <int NP>
__device__ __forceinline__ void pieces2(float a, float b, uint32_t (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    if (i + 1 < NP) {
      const float2 f = __bfloat1622float2(h);
      a -= f.x;
      b -= f.y;
    }
  }
}

// 8 values as NP bf16 rows: piece i of x[0..7] at dst + i * plane
template <int NP>
__device__ __forceinline__ void store8(__nv_bfloat16* dst, int plane,
                                       const float (&x)[8]) {
  uint32_t p[4][NP];
#pragma unroll
  for (int e = 0; e < 4; ++e) pieces2<NP>(x[2 * e], x[2 * e + 1], p[e]);
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint4*>(dst + size_t(i) * plane) =
        make_uint4(p[0][i], p[1][i], p[2][i], p[3][i]);
}

}  // namespace
