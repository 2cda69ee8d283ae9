// Pieces the flash-attention kernels share (flash_attention_fwd.cu and
// flash_attention_bwd.cu): cp.async copies into 128-byte-swizzled panel
// tiles, the warpgroup-wide wgmma.m64n64k16 bf16 product with fp32
// accumulation (operands in shared memory, or A in registers), quad
// reductions, and fragment packing.
//
// Fragment layout: a wgmma accumulator holds, in each warp's 16 rows, the
// mma.sync C layout (lane = 4*g + t): n-tile j (8 columns) of rows g and
// g+8, columns 8j + 2t and 8j + 2t + 1. An A operand from registers holds
// the mma.sync A layout in each warp's 16 rows: rows g and g+8, columns 2t,
// 2t+1 and 2t+8, 2t+9. So two accumulator n-tiles side by side (16 columns)
// become one A operand without leaving registers (`pack_a`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 16 bytes from device memory to shared memory by cp.async (bypassing L1);
// with `valid` false nothing is read and the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, the same way
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a bf16 row tile of `rows` rows stored as
// 64-column panels, each row 128 bytes with the 128-byte swizzle (16-byte
// chunk j of row r at chunk j ^ (r % 8)); the panel base is 1024-aligned
__device__ __forceinline__ uint32_t panel_offset(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// Rows [r0, r0 + kRows) of a (n, D) bf16 matrix into a swizzled panel tile
// at shared address `dst`, 16 bytes a cp.async, issued by the block's
// kThreads threads (the same number of copies each, so the loop unrolls);
// rows >= n are zero-filled
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "uneven tile copy");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int row = i / kChunks;
    const int col = (i % kChunks) * 8;
    const bool ok = r0 + row < n;
    cp_async16(dst + panel_offset(kRows, row, col),
               ok ? src + (size_t)(r0 + row) * D + col : src, ok);
  }
}

// wgmma shared-memory descriptor of a swizzled 128-byte-row tile: start
// address, leading and stride byte offsets (the stride between 8-row
// groups, 1024 bytes), 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes of this thread (st.shared, cp.async) become visible
// to the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 64, fp32, the mma.sync C layout in each warp's 16 rows) += A B,
// m64n64k16 with both operands in shared memory; tA / tB: operand stored
// MN-major (transposed) rather than K-major
template <int tA, int tB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate), "n"(tA), "n"(tB));
}

// D += A B, the same with A (64 x 16 bf16) in registers, the mma.sync A
// layout in each warp's 16 rows
template <int tB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(tB));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0.f;
}

// Two n-tiles of C fragments (16 columns) as one bf16 A operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[8][4],
                                       int c) {
  a[0] = pack_f32(x[2 * c][0], x[2 * c][1]);
  a[1] = pack_f32(x[2 * c][2], x[2 * c][3]);
  a[2] = pack_f32(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack_f32(x[2 * c + 1][2], x[2 * c + 1][3]);
}

}  // namespace flash
