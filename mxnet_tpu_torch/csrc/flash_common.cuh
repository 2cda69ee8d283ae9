// Pieces the flash-attention kernels share (flash_attention_fwd.cu and
// flash_attention_bwd.cu): the bf16 mma.sync.m16n8k16 product with fp32
// accumulation, its fragment packing, quad reductions, and the staging of a
// row tile into shared memory.
//
// Fragment layout of mma.m16n8k16 (lane = 4*g + t): A holds rows g and g+8,
// columns 2t, 2t+1 and 2t+8, 2t+9; B holds k rows 2t, 2t+1 and 2t+8, 2t+9 of
// column g; C holds rows g and g+8, columns 2t and 2t+1. Two C tiles side by
// side (16 columns) become one A operand without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kWarps = 4;  // 128 threads a block
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragments of rows r0 and r1 (= r0 + 8) of a (n, D) row-major bf16
// matrix, read straight from device memory; rows >= n read as zeros.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16* m, int r0,
                                            int r1, int n, int t) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = c * 16 + 2 * t;
    a[c][0] = r0 < n ? load_pair(m + (size_t)r0 * D + col) : 0u;
    a[c][1] = r1 < n ? load_pair(m + (size_t)r1 * D + col) : 0u;
    a[c][2] = r0 < n ? load_pair(m + (size_t)r0 * D + col + 8) : 0u;
    a[c][3] = r1 < n ? load_pair(m + (size_t)r1 * D + col + 8) : 0u;
  }
}

// Rows [r0, r0 + kRows) of a (n, D) bf16 matrix into shared memory with row
// pitch D + 8 (no bank conflicts on the fragment reads), 16 bytes a thread;
// rows >= n are zero-filled, so a ragged tail needs no divisibility rule.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int n) {
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kWarps * 32) {
    const int row = i / (D / 8);
    const int c8 = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * D + c8);
    *reinterpret_cast<uint4*>(dst + row * (D + 8) + c8) = x;
  }
}

}  // namespace flash
