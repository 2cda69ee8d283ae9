// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_flash_fwd` (body `_fwd_kernel`, scores `_scores`): blockwise
// online-softmax attention with an optional causal mask, an optional
// per-example valid key length (`kv_valid_len`, BERT's prefix mask) whose
// fully masked key tiles are skipped, exact zeros for a row with no valid key
// (vl = 0), and an optional per-row logsumexp.
//
// What bounds it on the H100: at the bert512 step's shape (B 16, H 12,
// T 512, D 64, every key valid, with the lse) it does 4*B*H*T*T*D = 12.9
// GFLOP of bf16 products, 0.0130 ms at 989 TFLOP/s, and moves 50 MB of
// q, k, v and o, 0.0151 ms at 3.35 TB/s: the two bounds are close. One
// exp2 a score costs the special-function unit about as long as the
// score's share of the two products costs the tensor cores at D = 64, and
// every K/V tile costs a barrier, two waits for the tensor cores and the
// softmax's row reductions, so what holds a simple kernel back is the
// latency of that chain, not either unit. What the design does about it
// (the first steps of the FA3 shape, not the TPU grid):
//
// * at D = 64 one CTA owns one (batch*head, tile of 128 query rows) and
//   has two warpgroups of 4 warps, 64 rows each (16 a warp). Both read
//   every K/V tile from the same shared-memory slot, so a tile is copied
//   once per 128 query rows. The TPU's sequential key axis becomes a loop
//   over K/V tiles of 128 keys (64-key tiles measured slower: twice the
//   barriers and waits for the same work). At D = 128, where O alone takes
//   64 registers a thread, a CTA is one warpgroup of 64 rows with 64-key
//   tiles, two CTAs an SM (measured faster than two warpgroups, one CTA an
//   SM). The running max, denominator and fp32 output accumulator live in
//   registers and nothing carries over between CTAs;
// * Q is copied once into shared memory; K and V tiles stream through a
//   ring of kStages slots filled by cp.async, each copy issued kStages - 1
//   tiles ahead, so it overlaps the products of the tiles before it. A slot
//   is refilled only after the barrier that follows every warpgroup's wait
//   for the products that read it;
// * both products are warpgroup-wide wgmma.m64n64k16 (the only way to the
//   card's full tensor-core rate): S = Q K^T with both operands K-major in
//   shared memory, one 64 x 64 accumulator per 64 keys; O += P V with P as
//   the A operand straight from the score accumulators (rounded to bf16
//   once, the TPU kernel's `p.astype(v.dtype)`) and V as an MN-major B
//   operand, so no operand is gathered element by element. At D = 128 O is
//   two 64-column accumulators;
// * tiles live in shared memory as 64-column panels with the 128-byte
//   swizzle, the layout wgmma's descriptors read without bank conflicts;
//   each thread issues the same number of 16-byte copies a tile, in a loop
//   the compiler unrolls;
// * the online softmax runs on the accumulator registers, two rows a
//   thread, with quad shuffles and ex2.approx on log2-scaled scores; the
//   denominator sums the fp32 p. Interior tiles take an unmasked path; the
//   ragged, valid-length and causal edge a masked one;
// * the loop ends at the last tile that holds a valid key for a row of the
//   CTA, so masked tiles are neither loaded nor computed. Both warpgroups
//   compute every tile of the CTA (at the causal edge the first one's last
//   tile is all masked and adds nothing): a wgmma under a branch the
//   compiler cannot prove uniform is serialized. A CTA whose example has
//   vl = 0 loads nothing and writes zeros and lse -1e30; a ragged T is
//   zero-filled by cp.async and masked, so there is no divisibility rule.
// TMA, a producer warp, and overlapping one tile's softmax with the next
// tile's products inside a warpgroup are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWGRows = 64;  // query rows a warpgroup owns

// warpgroups a CTA, keys a K/V tile, ring slots and the CTAs an SM should
// hold, by head dim (measured, tools/cuda_flash_fwd_tiles.py): at D = 64
// Q (16 KB) and three slots of 128 keys (96 KB) fit two CTAs of 128
// registers a thread on an SM; at D = 128 two one-warpgroup CTAs with Q
// (16 KB) and three slots of 64 keys (96 KB)
template <int D>
struct FwdShape {
  static constexpr int kWarpgroups = D == 64 ? 2 : 1;
  static constexpr int kKeys = D == 64 ? 128 : 64;
  static constexpr int kStages = D == 64 ? 3 : 3;
  static constexpr int kMinBlocks = D == 64 ? 2 : 2;
};

template <int D>
struct FwdLayout {
  static constexpr int kPanels = D / 64;  // 64-column panels of a row tile
  static constexpr int kWarpgroups = FwdShape<D>::kWarpgroups;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kRows = kWGRows * kWarpgroups;  // query rows a CTA
  static constexpr int kBN = FwdShape<D>::kKeys;       // keys a K/V tile
  static constexpr int kStages = FwdShape<D>::kStages;
  static constexpr int kQ = kWGRows * D * 2;  // bytes of a warpgroup's Q
  static constexpr int kKV = kBN * D * 2;     // of a K (or V) tile
  // each warpgroup's Q tile, then the ring of (K, V) slots, all 1024-byte
  // aligned for the swizzle
  static constexpr int kRing = kWarpgroups * kQ;
  static constexpr int kBytes = kRing + kStages * 2 * kKV;
};

// One K/V tile's scores of this thread's two query rows (s[h][j][0..1]: row
// r0, s[h][j][2..3]: row r0 + 8; key c + 64h + 8j and the one after) become
// p = exp2(scale_log2 * s - m), 0 where masked, after the running max m
// (log2 domain) has risen to cover them and the running sums l and the
// output accumulator o have been rescaled to it. kMasked false: every pair
// of the tile is kept (no ragged edge, valid length or causal edge inside)
template <bool kMasked, int kH, int kP>
__device__ __forceinline__ void online_softmax(float (&s)[kH][8][4],
                                               float (&o)[kP][8][4],
                                               float (&m)[2], float (&l)[2],
                                               float scale_log2, int r0, int c,
                                               int kv_len, int causal) {
#pragma unroll
  for (int h = 0; h < kH; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[h][j][e] * scale_log2;
        if (kMasked) {
          const int col = c + 64 * h + 8 * j + (e & 1);
          const int row = r0 + (e & 2) * 4;
          if (!(col < kv_len && (!causal || col <= row))) x = -INFINITY;
        }
        s[h][j][e] = x;
      }
    }
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[h][j][2 * r], s[h][j][2 * r + 1]));
    }
    mx = quad_max(mx);
    // a row with no kept key yet stays at -inf; exponentiate against 0 so
    // its p and correction come out 0 instead of NaN
    base[r] = mx == -INFINITY ? 0.f : mx;
    const float corr = fast_exp2(m[r] - base[r]);
    m[r] = mx;
    l[r] *= corr;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[p][j][2 * r] *= corr;
        o[p][j][2 * r + 1] *= corr;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[h][j][e] = fast_exp2(s[h][j][e] - base[e >> 1]);
        l[e >> 1] += s[h][j][e];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FwdLayout<D>::kThreads,
                                  FwdShape<D>::kMinBlocks)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ valid_len,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int heads, int tq, int tk, float scale_log2, int causal) {
  using L = FwdLayout<D>;
  constexpr int kP = L::kPanels;
  constexpr int kBN = L::kBN;
  constexpr int kH = kBN / 64;  // 64-key halves of a K/V tile
  constexpr int kStages = L::kStages;
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle needs 1024-byte aligned tiles
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = raw + ((1024 - (raw & 1023)) & 1023);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * L::kRows;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;  // within the warpgroup
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int w0 = q0 + wg * kWGRows;             // this warpgroup's first row
  const int r0 = w0 + warp * 16 + (lane >> 2);  // this lane's rows r0, r0 + 8

  int kv_len = tk;
  if (valid_len != nullptr) kv_len = min(max(valid_len[bh / heads], 0), tk);
  // keys at or past kv_end are masked for every row of the CTA
  const int kv_end = causal ? min(kv_len, q0 + L::kRows) : kv_len;
  const int n_tiles = (kv_end + kBN - 1) / kBN;

  const size_t koff = (size_t)bh * tk * D;
  const uint32_t qs = base + wg * L::kQ;
  auto slot = [&](int i) {
    return base + L::kRing + (i % kStages) * 2 * L::kKV;
  };
  auto load_stage = [&](int i) {
    const uint32_t ks = slot(i);
    load_tile_async<D, kBN, kThreads>(ks, k + koff, i * kBN, tk);
    load_tile_async<D, kBN, kThreads>(ks + L::kKV, v + koff, i * kBN, tk);
  };
  // Q joins the first stage's copy group; a CTA without a valid key loads
  // nothing
  if (n_tiles > 0) {
#pragma unroll
    for (int w = 0; w < L::kWarpgroups; ++w)
      load_tile_async<D, kWGRows, kThreads>(base + w * L::kQ,
                                            q + (size_t)bh * tq * D,
                                            q0 + w * kWGRows, tq);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage(s);
    cp_async_commit();
  }

  float acc[kP][8][4];
#pragma unroll
  for (int p = 0; p < kP; ++p) zero(acc[p]);
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the sums
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // tile i (and Q) have landed
    fence_async_shared();
    // ... for every thread; and every warpgroup has waited for the products
    // that read tile i - 1, whose slot takes tile i + kStages - 1
    __syncthreads();
    if (i + kStages - 1 < n_tiles) load_stage(i + kStages - 1);
    cp_async_commit();

    const int n0 = i * kBN;
    const uint32_t ks = slot(i);
    const uint32_t vs = ks + L::kKV;

    // S = Q K^T (64 rows x kBN keys a warpgroup, as 64-key halves):
    // K-major operands, 16 columns (32 bytes) of a panel a step
    float s[kH][8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qo = (kk >> 2) * kWGRows * 128 + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * kBN * 128 + (kk & 3) * 32;
#pragma unroll
      for (int h = 0; h < kH; ++h)
        wgmma_ss<0, 0>(s[h], smem_desc(qs + qo, 16),
                       smem_desc(ks + ko + h * 64 * 128, 16), kk);
    }
    wgmma_commit();
    wgmma_wait_all();

    const bool whole =
        n0 + kBN <= kv_len && (!causal || n0 + kBN - 1 <= w0);
    if (whole)
      online_softmax<false>(s, acc, m, l, scale_log2, r0, n0 + 2 * t, kv_len,
                            causal);
    else
      online_softmax<true>(s, acc, m, l, scale_log2, r0, n0 + 2 * t, kv_len,
                           causal);

    // O += P V: p (rounded to bf16) is the A operand from registers, V an
    // MN-major B operand (keys are the reduction axis), 16 keys (2048
    // bytes) a step
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) pack_a(pa[c], s[c >> 2], c & 3);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
#pragma unroll
      for (int p = 0; p < kP; ++p)
        wgmma_rs<1>(acc[p], pa[c],
                    smem_desc(vs + p * kBN * 128 + c * 2048, kBN * 128));
    }
    wgmma_commit();
    // after the next barrier no warpgroup's products read this slot
    wgmma_wait_all();
  }
  cp_async_wait<0>();

  const float l0 = quad_sum(l[0]);
  const float l1 = quad_sum(l[1]);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (size_t)bh * tq * D;
  const int r1 = r0 + 8;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = p * 64 + j * 8 + 2 * t;
      if (r0 < tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
            pack_f32(acc[p][j][0] * inv0, acc[p][j][1] * inv0);
      if (r1 < tq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
            pack_f32(acc[p][j][2] * inv1, acc[p][j][3] * inv1);
    }
  }
  if (lse != nullptr && t == 0) {
    // the TPU kernel's m + log(max(l, 1e-30)) with m = -1e30 for a row
    // that saw no valid key
    float* lb = lse + (size_t)bh * tq;
    if (r0 < tq) lb[r0] = l0 > 0.f ? m[0] * kLn2 + logf(l0) : -1e30f;
    if (r1 < tq) lb[r1] = l1 > 0.f ? m[1] * kLn2 + logf(l1) : -1e30f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v,
           const int32_t* valid_len, void* o, float* lse, int batch_heads,
           int heads, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  using L = FwdLayout<D>;
  // one more KB than the layout, for the 1024-byte alignment
  constexpr int kSmem = L::kBytes + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((tq + L::kRows - 1) / L::kRows, batch_heads);
  flash_fwd_kernel<D><<<grid, L::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), valid_len,
      static_cast<__nv_bfloat16*>(o), lse, heads, tq, tk, scale * kLog2e,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (batch_heads, tq, d); k, v: (batch_heads, tk, d); all bf16 and
// contiguous. valid_len: (batch_heads / heads,) int32 or null. lse:
// (batch_heads, tq) float32 or null. Returns the cudaError_t of the launch.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             const int32_t* valid_len, void* o, float* lse,
                             int batch_heads, int heads, int tq, int tk, int d,
                             float scale, int causal, void* stream) {
  if (tq == 0 || batch_heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, valid_len, o, lse, batch_heads, heads, tq, tk,
                        scale, causal, s);
    case 128:
      return launch<128>(q, k, v, valid_len, o, lse, batch_heads, heads, tq,
                         tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
