// bf16 tensor-core helpers shared by the flash attention kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D[16x8] += A[16x16] (row) * B[16x8] (col), bf16 in, f32 accumulate.
// Fragments (g = lane / 4, t = lane % 4):
//   A: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//      a3 = A[g+8][2t+8..];
//   B: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g];
//   C: c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1].
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0 and r1 (= r0 + 8) of a row-major [rows, D] bf16 matrix as this
// lane's A fragments of a 16-row slice; rows at or past `rows` read as 0.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const __nv_bfloat16* base, int r0,
                                            int r1, int rows, int t) {
#pragma unroll
  for (int kt = 0; kt < D / 16; ++kt) {
    const int c = kt * 16 + 2 * t;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(r0) * D + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(r1) * D + c);
    f[kt][0] = r0 < rows ? p0[0] : 0u;
    f[kt][1] = r1 < rows ? p1[0] : 0u;
    f[kt][2] = r0 < rows ? p0[4] : 0u;
    f[kt][3] = r1 < rows ? p1[4] : 0u;
  }
}

}  // namespace
