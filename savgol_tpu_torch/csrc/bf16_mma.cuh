// The tensor-core and staging primitives of the bf16 kernels
// (corr2d_bf16_mma.cu, sg1d_bf16.cuh): ldmatrix, mma.sync m16n8k16 on bf16
// with f32 sums, bf16 packing, 8 samples staged from 16-byte loads at any
// alignment of the caller's f32 or bf16 storage, and the non-finite test of
// 8 staged values.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sgmma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b on one m16n8k16 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 in one word, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// Samples p[0, 8) as 8 bf16 values in one 16-byte word: 16-byte loads at
// the aligned addresses around them, shifted into place.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 1) & 7);   // samples past alignment
  const uint4* v = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const uint4 v0 = __ldg(v);
  const uint4 v1 = m ? __ldg(v + 1) : v0;
  unsigned u[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  if (m & 4) {
#pragma unroll
    for (int i = 0; i < 6; ++i) u[i] = u[i + 2];
  }
  if (m & 2) {
#pragma unroll
    for (int i = 0; i < 7; ++i) u[i] = u[i + 1];
  }
  if (m & 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __funnelshift_r(u[i], u[i + 1], 16);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ uint4 load8(const float* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const int m = static_cast<int>((a >> 2) & 3);
  const float4* v = reinterpret_cast<const float4*>(a & ~uintptr_t(15));
  const float4 v0 = __ldg(v), v1 = __ldg(v + 1);
  const float4 v2 = m ? __ldg(v + 2) : v1;
  float f[12] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y,
                 v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
  if (m & 2) {
#pragma unroll
    for (int i = 0; i < 10; ++i) f[i] = f[i + 2];
  }
  if (m & 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = f[i + 1];
  }
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Whether any of the 8 bf16 values of v is an inf or a NaN (exponent all
// ones): checked on the rounded values, since a finite f32 sample past
// bf16's range rounds to inf, as the plain version's bf16 operand does.
__device__ __forceinline__ bool nonfinite8(uint4 v) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  unsigned t = 0;   // bit 15 of a half set by the carry iff exponent 0xff
#pragma unroll
  for (int i = 0; i < 4; ++i) t |= (u[i] & 0x7f807f80u) + 0x00800080u;
  return (t & 0x80008000u) != 0;
}

}  // namespace sgmma
