// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_flash_fwd` (body `_fwd_kernel`, scores `_scores`): blockwise
// online-softmax attention with an optional causal mask, an optional
// per-example valid key length (`kv_valid_len`, BERT's prefix mask) whose
// fully masked key tiles are skipped, exact zeros for a row with no valid key
// (vl = 0), and an optional per-row logsumexp.
//
// What bounds it on the H100: for BERT-base serving (B 8, H 12, T 512, D 64,
// all keys valid) it does 4*B*H*T*T*D = 6.4 GFLOP of bf16 products on ~25 MB
// of Q/K/V/O, 256 operations per byte, just under the card's ridge of 295:
// the tensor cores and memory both matter, and a simple kernel is bounded by
// neither but by how well it feeds mma. What the design does about it:
//
// * one thread block owns one (batch*head, 64-row query tile); its 4 warps
//   own 16 query rows each and loop over 64-key K/V tiles. The TPU's
//   sequential third grid axis becomes this loop, and nothing carries over
//   between blocks. The running max, denominator and fp32 output accumulator
//   live in registers;
// * both products are warp-level `mma.sync.m16n8k16` bf16 with fp32
//   accumulation. Q fragments are read once from device memory into
//   registers; K and V tiles are staged in shared memory with 16-byte loads
//   and a padded row pitch; the score fragments turn into the A operand of
//   P*V without leaving registers (the fp32 -> bf16 cast of p is the TPU
//   kernel's `p.astype(v.dtype)`);
// * the loop ends at the last tile holding a valid key (vl and causal), so
//   masked tiles are neither loaded nor computed; a ragged tail (T not a
//   multiple of 64) is zero-filled and masked, so no divisibility rule.
// wgmma, TMA and a pipelined K/V ring are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBM = 64;     // query rows per block
constexpr int kBN = 64;     // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int32_t* __restrict__ valid_len,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int heads, int tq, int tk, float scale_log2, int causal) {
  constexpr int kPitch = D + 8;       // shared row pitch: no bank conflicts on K
  constexpr int kChunks = D / 16;     // k-steps of Q*K^T
  constexpr int kDTiles = D / 8;      // n-tiles of the output row block
  constexpr int kNTiles = kBN / 8;    // n-tiles of one score tile
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * kPitch];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kPitch];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  int kv_len = tk;
  if (valid_len != nullptr) kv_len = min(max(valid_len[bh / heads], 0), tk);
  // keys at or past kv_end are masked for every row of this block
  const int kv_end = causal ? min(kv_len, q0 + kBM) : kv_len;

  const __nv_bfloat16* qb = q + (size_t)bh * tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * D;

  uint32_t qa[kChunks][4];
  load_a_rows<D>(qa, qb, r0, r1, tq, t);

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the denominators

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    load_tile<D, kBN>(ks, kb, n0, tk);
    load_tile<D, kBN>(vs, vb, n0, tk);
    __syncthreads();

    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * kPitch + 2 * t;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        mma_16816(s[j], qa[c], load_pair(kr + c * 16), load_pair(kr + c * 16 + 8));
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool keep = col < kv_len && (!causal || col <= row);
        s[j][e] = keep ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float new0 = fmaxf(m0, quad_max(mx0));
    const float new1 = fmaxf(m1, quad_max(mx1));
    // a row with no valid key yet stays at -inf; exponentiate against 0 so
    // its p (and correction) come out 0 instead of NaN
    const float base0 = new0 == -INFINITY ? 0.f : new0;
    const float base1 = new1 == -INFINITY ? 0.f : new1;
    const float corr0 = exp2f(m0 - base0);
    const float corr1 = exp2f(m1 - base1);
    m0 = new0;
    m1 = new1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][0] *= corr0;
      acc[j][1] *= corr0;
      acc[j][2] *= corr1;
      acc[j][3] *= corr1;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = exp2f(s[j][0] - base0);
      s[j][1] = exp2f(s[j][1] - base0);
      s[j][2] = exp2f(s[j][2] - base1);
      s[j][3] = exp2f(s[j][3] - base1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      const uint32_t pa[4] = {pack_f32(s[2 * c][0], s[2 * c][1]),
                              pack_f32(s[2 * c][2], s[2 * c][3]),
                              pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_f32(s[2 * c + 1][2], s[2 * c + 1][3])};
      const __nv_bfloat16* vr = vs + (c * 16 + 2 * t) * kPitch + g;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const __nv_bfloat16* p = vr + j * 8;
        mma_16816(acc[j], pa, pack_bf16(p[0], p[kPitch]),
                  pack_bf16(p[8 * kPitch], p[9 * kPitch]));
      }
    }
    __syncthreads();
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (size_t)bh * tq * D;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_f32(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_f32(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    // the TPU kernel's m + log(max(l, 1e-30)) with m = -1e30 for a row
    // that saw no valid key
    float* lb = lse + (size_t)bh * tq;
    if (r0 < tq) lb[r0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : -1e30f;
    if (r1 < tq) lb[r1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : -1e30f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int32_t* valid_len,
           void* o, float* lse, int batch_heads, int heads, int tq, int tk,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid((tq + kBM - 1) / kBM, batch_heads);
  flash_fwd_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), valid_len,
      static_cast<__nv_bfloat16*>(o), lse, heads, tq, tk, scale * kLog2e, causal);
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
      return launch<128>(q, k, v, valid_len, o, lse, batch_heads, heads, tq, tk,
                         scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
