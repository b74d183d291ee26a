// Tensor-core building blocks shared by the flash-attention kernels (forward
// and backward): mma.sync m16n8k16 in bf16 with f32 accumulation, ldmatrix
// loads of its operands from shared memory, and the staging of a 64-row bf16
// tile. Included by the .cu files of this directory; everything is inline.
//
// Fragment layout of one warp (g = lane / 4, tig = lane % 4):
//   A (16 x 16, row-major): a0 = (row g, cols 2 tig, 2 tig + 1), a1 = the same
//     columns of row g + 8, a2 / a3 = the same rows at columns + 8;
//   C (16 x 8, f32): c0, c1 = (row g, cols 2 tig, 2 tig + 1), c2, c3 = row g + 8.
// So two neighbouring C tiles of a warp, rounded to bf16, are the A fragment
// of the next product's k-step over the same 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace omgsr_mma {

constexpr int MMA_NT = 128;  // four warps, 16 rows of a 64-row tile each

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_ptr) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_ptr);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// 64 rows x D bf16 from global (row stride in elements) to shared [64][D+8];
// rows >= rows_valid become 0. The 16 bytes of padding per row make every
// ldmatrix phase hit 8 different 16-byte bank groups.
template <int D>
__device__ __forceinline__ void stage_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long row_stride, int rows_valid) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += MMA_NT) {
    const int r = idx / VPR;
    const int v = idx % VPR;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      raw = *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + v * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + v * 8) = raw;
  }
}

// The A fragments (KS k-steps of 16 columns) of 16 rows of a (rows, D) bf16
// matrix, straight from global memory; rows >= rows_end read as 0.
template <int KS>
__device__ __forceinline__ void load_a_fragments(uint32_t (&f)[KS][4], const __nv_bfloat16* base,
                                                 long long row_stride, int row0, int rows_end,
                                                 int g, int tig) {
  const int r_lo = row0 + g, r_hi = row0 + g + 8;
  const __nv_bfloat16* p_lo = base + (long long)r_lo * row_stride;
  const __nv_bfloat16* p_hi = base + (long long)r_hi * row_stride;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tig * 2;
    f[ks][0] = r_lo < rows_end ? *reinterpret_cast<const uint32_t*>(p_lo + c) : 0u;
    f[ks][1] = r_hi < rows_end ? *reinterpret_cast<const uint32_t*>(p_hi + c) : 0u;
    f[ks][2] = r_lo < rows_end ? *reinterpret_cast<const uint32_t*>(p_lo + c + 8) : 0u;
    f[ks][3] = r_hi < rows_end ? *reinterpret_cast<const uint32_t*>(p_hi + c + 8) : 0u;
  }
}

}  // namespace omgsr_mma
