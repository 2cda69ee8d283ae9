// Flash-attention backward for Hopper (sm_90a): one kernel computes dq, dk
// and dv, bf16 in and out, fp32 accumulation; a small pass turns the fp32 dq
// sums into bf16.
//
// Replaces the two TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// `_flash_bwd`: `_dq_kernel` (dq = sum over key tiles of ds K * scale) and
// `_dkv_kernel` (dv = sum over query tiles of P^T dO, dk = sum of
// ds^T Q * scale), the flash-attention-2 recompute scheme: P is rebuilt from
// the forward's saved logsumexp, ds = P * (dO V^T - delta) with
// delta = rowsum(dO * O) computed by the caller, and no T x T matrix ever
// reaches device memory. Causal masking and a per-example valid key length
// (`kv_valid_len`) skip whole tiles, as the TPU kernels' `run` predicates do.
//
// What bounds it on the H100: the five products S = Q K^T, dP = dO V^T,
// dV = P^T dO, dK = dS^T Q and dQ = dS K, 10 * pairs operations on the
// tensor cores (pairs = the query-key pairs the data needs times D). At
// BERT-base seq 512 (B 16, H 12, T 512, D 64, every key valid) that is 32.2
// GFLOP: 0.0326 ms at 989 TFLOP/s, against 0.0265 ms to move the 89 MB of
// inputs and outputs at 3.35 TB/s, so the tensor cores bound it. Two
// kernels, one for dq and one for dk/dv, would recompute S and dP:
// 14 * pairs. What the design does about it (the FA2/FA3 backward's
// dataflow, not the TPU grid):
//
// * one CTA, one warpgroup of 4 warps, owns one (batch*head, tile of 64
//   keys), 16 keys a warp, and keeps its K and V tiles in shared memory for
//   its whole life. Query tiles of 64 rows (Q, dO, lse, delta) stream
//   through a ring of kStages shared-memory slots filled by cp.async, each
//   copy issued kStages - 1 tiles ahead, so it overlaps the products of
//   the tiles before it;
// * every product is a warpgroup-wide wgmma.m64n64k16 (the only way to the
//   card's full tensor-core rate): S^T = K Q^T and dP^T = V dO^T with both
//   operands in shared memory; dV += P^T dO and dK += dS^T Q with P^T and
//   dS^T as the A operand straight from the accumulator registers (the
//   wgmma accumulator and A layouts are mma.sync's, 16 rows a warp);
//   dQ += dS K with dS^T written once to shared memory as bf16 and read as a
//   transposed A operand, K as a transposed B operand. Nothing is
//   recomputed: 10 * pairs operations;
// * each query tile's fp32 dQ partial is staged in the tile's own ring slot
//   (free once its products are done) and added into a fp32 workspace (one
//   64 x D block a head and query tile) by the bulk-copy unit
//   (cp.reduce.async.bulk .add.f32: one instruction a tile in place of 2048
//   vector atomics from the registers), which overlaps the next tile's
//   products; the slot takes its next query tile once the unit has read
//   it. At seq 512 the workspace is 25 MB and stays in the 50 MB L2; dq
//   sums in the order the reductions land, so it is not bit-reproducible
//   from run to run;
// * tiles live in shared memory as 64-column panels with the 128-byte
//   swizzle, the layout wgmma's descriptors read without bank conflicts,
//   K-major for one product and MN-major (transposed) for another;
// * the cast points are the TPU kernels': ds is rounded to bf16 once, before
//   its products with K and Q (both read the same bf16 values), p once
//   before its product with dO; the scale multiplies the fp32 sums (dk at
//   its store, dq in the pass that rounds it);
// * a masked score gives p = 0 by selection, not by exp(-1e30 - lse): the
//   row of an example with vl = 0 has lse = -1e30, where the subtraction
//   would give p = 1. A CTA whose keys are all past the valid length loads
//   nothing and writes exact zeros to dk and dv; key rows past the valid
//   length get exact zeros too, and an example with vl = 0 adds nothing to
//   its zeroed dq workspace;
// * a ragged T (not a multiple of the tile) is zero-filled by cp.async and
//   masked;
// * at D = 128 dV and dK are two 64-column accumulators each and dQ is
//   formed one 64-column half at a time, which keeps the registers within
//   the file.
// TMA, warp specialisation and two warpgroups that take turns are later
// work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

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

constexpr int kBN = 64;  // keys a CTA owns: one warpgroup, 16 a warp
constexpr int kBM = 64;  // query rows a ring slot holds
constexpr int kThreads = 128;

// ring slots and the CTAs an SM should hold, by head dim (measured,
// tools/cuda_flash_bwd_tiles.py): at D = 64 three slots (74.5 KB of shared
// memory) and a 168-register budget fit three CTAs on an SM; at D = 128 the
// dK and dV accumulators take 128 registers, and two slots (106 KB) fit
// two CTAs
template <int D>
struct BwdShape {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kMinBlocks = D == 64 ? 3 : 2;
};

template <int D>
struct BwdLayout {
  static constexpr int kPanels = D / 64;  // 64-column panels of a row tile
  static constexpr int kKV = kBN * D * 2;  // bytes of K (or V)
  static constexpr int kQ = kBM * D * 2;   // of a Q (or dO) tile
  static constexpr int kStages = BwdShape<D>::kStages;
  // K, V, the ring of (Q, dO) slots, dS^T (keys x queries, bf16), all
  // 1024-byte aligned for the swizzle, then the ring's (lse, delta) slots
  static constexpr int kDs = 2 * kKV + kStages * 2 * kQ;
  static constexpr int kStats = kDs + kBN * kBM * 2;
  static constexpr int kBytes = kStats + kStages * 2 * kBM * 4;
};

// Byte offset of element (r, c) of a bf16 row tile of `rows` rows stored as
// 64-column panels, each row 128 bytes with the 128-byte swizzle (16-byte
// chunk j of row r at chunk j ^ (r % 8)); the panel base is 1024-aligned
__device__ __forceinline__ uint32_t panel_offset(int rows, int r, int c) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 +
                    ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}

// Rows [r0, r0 + kRows) of a (n, D) bf16 matrix into a swizzled panel tile
// at shared address `dst`, 16 bytes a cp.async; rows >= n are zero-filled
template <int D, int kRows>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
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

// S^T and dP^T fragments (rows: keys c0, c1; columns: queries 2t, 2t + 1 of
// each 8-query n-tile) become p = exp(scale * s - lse) where kept, 0 where
// masked, and ds = p * (dp - delta). kMasked false: every pair of the tile
// is kept (no ragged edge, valid length or causal edge inside it)
template <bool kMasked>
__device__ __forceinline__ void p_and_ds(float (&s)[8][4], float (&dp)[8][4],
                                         const float* lse_s,
                                         const float* delta_s,
                                         float scale_log2, int t, int m0,
                                         int c0, int c1, int tq, int kv_len,
                                         int causal) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int qi = j * 8 + 2 * t;
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qi);
    const float2 dl = *reinterpret_cast<const float2*>(delta_s + qi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float lse_e = ((e & 1) ? l2.y : l2.x) * kLog2e;
      float p = fast_exp2(s[j][e] * scale_log2 - lse_e);
      if (kMasked) {
        const int row = m0 + qi + (e & 1);
        const int col = e < 2 ? c0 : c1;
        if (!(row < tq && col < kv_len && (!causal || col <= row))) p = 0.f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

// Two n-tiles of C fragments (16 columns) as one bf16 A operand
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[8][4],
                                       int c) {
  a[0] = pack_f32(x[2 * c][0], x[2 * c][1]);
  a[1] = pack_f32(x[2 * c][2], x[2 * c][3]);
  a[2] = pack_f32(x[2 * c + 1][0], x[2 * c + 1][1]);
  a[3] = pack_f32(x[2 * c + 1][2], x[2 * c + 1][3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, BwdShape<D>::kMinBlocks)
flash_bwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int32_t* __restrict__ valid_len,
                 float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int heads, int tq, int tk,
                 float scale, int causal) {
  using L = BwdLayout<D>;
  constexpr int kP = L::kPanels;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle needs 1024-byte aligned tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw + pad;
  const uint32_t ks = base;
  const uint32_t vs = base + L::kKV;
  const uint32_t ds_t = base + L::kDs;      // dS^T: keys x queries
  // offset of query tile i's ring slot: its Q and dO, then its dQ partial
  auto slot_offset = [&](int i) {
    return 2 * L::kKV + (i % kStages) * 2 * L::kQ;
  };
  float* stats = reinterpret_cast<float*>(smem + L::kStats);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr = warp * 16 + g;  // this lane's first key row in the tile
  const int c0 = k0 + kr;        // its two keys
  const int c1 = c0 + 8;

  int kv_len = tk;
  if (valid_len != nullptr) kv_len = min(max(valid_len[bh / heads], 0), tk);

  const size_t koff = (size_t)bh * tk * D;
  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
  if (k0 >= kv_len) {
    // every key of this CTA is past the valid length: exact zeros
    const int rows = min(kBN, tk - k0);
    for (int i = threadIdx.x; i < rows * (D / 8); i += kThreads) {
      const size_t off = (size_t)(k0 + i / (D / 8)) * D + (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(dkb + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dvb + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const size_t qoff = (size_t)bh * tq * D;
  const __nv_bfloat16* qb = q + qoff;
  const __nv_bfloat16* dob = dout + qoff;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;
  // causal: query rows before this tile's first key see none of its keys
  const int m_begin = causal ? (k0 / kBM) * kBM : 0;
  const int n_tiles = max(0, (tq - m_begin + kBM - 1) / kBM);
  // this head's dQ workspace: one 64 x D fp32 block a query tile
  float* dqb = dq_acc + (size_t)bh * ((tq + kBM - 1) / kBM) * kBM * D;
  // the bulk-copy unit adds query tile i's staged partial to its block
  auto reduce_tile = [&](int i) {
    float* dst = dqb + (size_t)(m_begin / kBM + i) * kBM * D;
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(dst),
        "r"(base + slot_offset(i)), "n"(kBM * D * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  };

  auto load_stage = [&](int i) {
    const int m0 = m_begin + i * kBM;
    const int slot = i % kStages;
    const uint32_t qs = base + slot_offset(i);
    load_tile_async<D, kBM>(qs, qb, m0, tq);
    load_tile_async<D, kBM>(qs + L::kQ, dob, m0, tq);
    const uint32_t st = smem_addr(stats + slot * 2 * kBM);
    for (int r = threadIdx.x; r < 2 * kBM; r += kThreads) {
      const int row = m0 + (r % kBM);
      const float* src = r < kBM ? lb : db;
      cp_async4(st + r * 4, row < tq ? src + row : src, row < tq);
    }
  };

  // K and V join the first stage's copy group
  load_tile_async<D, kBN>(ks, k + koff, k0, tk);
  load_tile_async<D, kBN>(vs, v + koff, k0, tk);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }

  const float scale_log2 = scale * kLog2e;
  float dva[kP][8][4], dka[kP][8][4];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    zero(dva[p]);
    zero(dka[p]);
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // query tile i (and K, V) have landed
    fence_async_shared();
    __syncthreads();  // ... for every thread; tile i - 1's dQ is staged
    if (threadIdx.x == 0 && i > 0) reduce_tile(i - 1);

    const int m0 = m_begin + i * kBM;
    const int slot = i % kStages;
    const uint32_t qs = base + slot_offset(i);
    const uint32_t dos = qs + L::kQ;
    const float* lse_s = stats + slot * 2 * kBM;
    const float* delta_s = lse_s + kBM;

    // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries): K-major
    // operands, 16 columns (32 bytes) of a panel a step
    float s[8][4], dp[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ko = (kk >> 2) * kBN * 128 + (kk & 3) * 32;
      const uint32_t qo = (kk >> 2) * kBM * 128 + (kk & 3) * 32;
      wgmma_ss<0, 0>(s, smem_desc(ks + ko, 16), smem_desc(qs + qo, 16), kk);
      wgmma_ss<0, 0>(dp, smem_desc(vs + ko, 16), smem_desc(dos + qo, 16), kk);
    }
    wgmma_commit();
    wgmma_wait_all();

    // s becomes p, dp becomes ds; dS^T goes to shared memory as bf16
    const bool whole = m0 + kBM <= tq && k0 + kBN <= kv_len &&
                       (!causal || k0 + kBN - 1 <= m0);
    if (whole)
      p_and_ds<false>(s, dp, lse_s, delta_s, scale_log2, t, m0, c0, c1, tq,
                      kv_len, causal);
    else
      p_and_ds<true>(s, dp, lse_s, delta_s, scale_log2, t, m0, c0, c1, tq,
                     kv_len, causal);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       ds_t + panel_offset(kBN, kr, j * 8 + 2 * t)),
                   "r"(pack_f32(dp[j][0], dp[j][1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       ds_t + panel_offset(kBN, kr + 8, j * 8 + 2 * t)),
                   "r"(pack_f32(dp[j][2], dp[j][3])));
    }

    // dV += P^T dO and dK += dS^T Q: p and ds (rounded to bf16) are the A
    // operands from registers, dO and Q MN-major B operands (queries are
    // the reduction axis), 16 rows (2048 bytes) a step
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pack_a(pa[c], s, c);
      pack_a(sa[c], dp, c);
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const uint32_t o = p * kBM * 128 + c * 2048;
        wgmma_rs<1>(dva[p], pa[c], smem_desc(dos + o, kBM * 128));
        wgmma_rs<1>(dka[p], sa[c], smem_desc(qs + o, kBM * 128));
      }
    }
    wgmma_commit();
    // waiting here frees the A operands' registers before dQ's accumulators
    // are live (at D = 64 the kernel then fits 168 registers), and after the
    // barrier no warp's products read this slot's Q and dO any more
    wgmma_wait_all();
    // the bulk-copy unit has read tile i - 1's staged dQ
    if (threadIdx.x == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    fence_async_shared();
    __syncthreads();  // dS^T is whole; tile i - 1's slot is free
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    cp_async_commit();

    // dQ += dS K (64 queries x 64 columns a panel, 64 keys): dS^T and K
    // both MN-major, 16 keys (2048 bytes) a step. The partial is staged in
    // this tile's slot in the workspace's order (panel, warp, n-tile, lane:
    // a lane's four values as one float4, so a warp's stores fill distinct
    // banks) and added by the bulk-copy unit after the next barrier
    float4* dqs = reinterpret_cast<float4*>(smem + slot_offset(i));
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      float dqa[8][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_ss<1, 1>(dqa, smem_desc(ds_t + kk * 2048, kBN * 128),
                       smem_desc(ks + p * kBN * 128 + kk * 2048, kBN * 128),
                       kk);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dqs[((p * 4 + warp) * 8 + j) * 32 + lane] =
            make_float4(dqa[j][0], dqa[j][1], dqa[j][2], dqa[j][3]);
    }
  }
  fence_async_shared();
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    reduce_tile(n_tiles - 1);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  // key rows past the valid length are written as exact zeros
  const bool keep0 = c0 < kv_len;
  const bool keep1 = c1 < kv_len;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p * 64 + j * 8 + 2 * t;
      if (c0 < tk) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)c0 * D + col) =
            keep0 ? pack_f32(dka[p][j][0] * scale, dka[p][j][1] * scale) : 0u;
        *reinterpret_cast<uint32_t*>(dvb + (size_t)c0 * D + col) =
            keep0 ? pack_f32(dva[p][j][0], dva[p][j][1]) : 0u;
      }
      if (c1 < tk) {
        *reinterpret_cast<uint32_t*>(dkb + (size_t)c1 * D + col) =
            keep1 ? pack_f32(dka[p][j][2] * scale, dka[p][j][3] * scale) : 0u;
        *reinterpret_cast<uint32_t*>(dvb + (size_t)c1 * D + col) =
            keep1 ? pack_f32(dva[p][j][2], dva[p][j][3]) : 0u;
      }
    }
  }
}

// The dq pass: dq = bf16(scale * the fp32 sums). The workspace holds one
// 64 x D block a (head, query tile) in the order the backward kernel stages
// it: 64-column panel, warp, n-tile, lane, then the lane's four values (rows
// r and r + 8, columns c and c + 1 of the mma C layout). A CTA takes one
// block: coalesced float4 reads into a row-major tile in shared memory, then
// 16-byte bf16 stores of whole rows
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float4* __restrict__ acc,
                    __nv_bfloat16* __restrict__ dq, int tq, float scale) {
  constexpr int kPitch = D + 4;  // floats a row of the tile
  __shared__ __align__(16) float tile[kBM * kPitch];
  const int tiles = (tq + kBM - 1) / kBM;
  const int head = blockIdx.x / tiles;
  const int m0 = (blockIdx.x % tiles) * kBM;
  const float4* src = acc + (size_t)blockIdx.x * (kBM * D / 4);
#pragma unroll
  for (int i = threadIdx.x; i < kBM * D / 4; i += 256) {
    const int lane = i & 31;
    const int row = ((i >> 8) & 3) * 16 + (lane >> 2);
    const int col = (i >> 10) * 64 + ((i >> 5) & 7) * 8 + 2 * (lane & 3);
    const float4 a = src[i];
    *reinterpret_cast<float2*>(tile + row * kPitch + col) =
        make_float2(a.x * scale, a.y * scale);
    *reinterpret_cast<float2*>(tile + (row + 8) * kPitch + col) =
        make_float2(a.z * scale, a.w * scale);
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < kBM * D / 8; i += 256) {
    const int row = i / (D / 8);
    const int col = (i % (D / 8)) * 8;
    if (m0 + row >= tq) continue;
    const float* x = tile + row * kPitch + col;
    const float4 a = *reinterpret_cast<const float4*>(x);
    const float4 b = *reinterpret_cast<const float4*>(x + 4);
    *reinterpret_cast<uint4*>(dq + ((size_t)head * tq + m0 + row) * D + col) =
        make_uint4(pack_f32(a.x, a.y), pack_f32(a.z, a.w), pack_f32(b.x, b.y),
                   pack_f32(b.z, b.w));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int32_t* valid_len,
           float* dq_acc, void* dq, void* dk, void* dv, int batch_heads,
           int heads, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  // one more KB than the layout, for the 1024-byte alignment
  constexpr int kSmem = BwdLayout<D>::kBytes + 1024;
  if (tk > 0) {
    const cudaError_t attr = cudaFuncSetAttribute(
        flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (attr != cudaSuccess) return (int)attr;
    const dim3 grid((tk + kBN - 1) / kBN, batch_heads);
    flash_bwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout),
        lse, delta, valid_len, dq_acc, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), heads, tq, tk, scale, causal);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = batch_heads * ((tq + kBM - 1) / kBM);
  if (blocks == 0) return 0;
  flash_bwd_dq_kernel<D><<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dq_acc),
      static_cast<__nv_bfloat16*>(dq), tq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the fp32 dq workspace mxt_flash_bwd takes: one 64 x d block a
// head and query tile, in the order the dq pass reads.
extern "C" int64_t mxt_flash_bwd_workspace(int batch_heads, int tq, int d) {
  return (int64_t)batch_heads * ((tq + kBM - 1) / kBM) * kBM * d;
}

// q, dout, dq: (batch_heads, tq, d); k, v, dk, dv: (batch_heads, tk, d); all
// bf16 and contiguous. lse (the forward's logsumexp) and delta
// (rowsum(dO * O)): (batch_heads, tq) float32. valid_len: (batch_heads /
// heads,) int32 or null. dq_acc: the workspace, zeroed by the caller.
// Launches the backward kernel, then the dq pass; returns the cudaError_t of
// the launches.
extern "C" int mxt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const int32_t* valid_len,
                             float* dq_acc, void* dq, void* dk, void* dv,
                             int batch_heads, int heads, int tq, int tk, int d,
                             float scale, int causal, void* stream) {
  if (batch_heads == 0 || (tq == 0 && tk == 0)) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, valid_len, dq_acc, dq, dk,
                        dv, batch_heads, heads, tq, tk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, valid_len, dq_acc, dq, dk,
                         dv, batch_heads, heads, tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
