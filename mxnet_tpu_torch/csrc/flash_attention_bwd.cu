// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, bf16 in and out, fp32 accumulation.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py
// `_flash_bwd`: `_dq_kernel` (dq = sum over key tiles of ds * K * scale) and
// `_dkv_kernel` (dv = sum over query tiles of P^T dO, dk = sum of
// ds^T Q * scale), the flash-attention-2 recompute scheme: P is rebuilt from
// the forward's saved logsumexp, ds = P * (dO V^T - delta) with
// delta = rowsum(dO * O) computed by the caller, and no T x T matrix ever
// reaches device memory. Causal masking and a per-example valid key length
// (`kv_valid_len`) skip whole tiles, as the TPU kernels' `run` predicates do.
//
// What bounds it on the H100: at BERT-base seq 512 (B 16, H 12, T 512,
// D 64, every key valid) dq does 6*B*H*T*T*D = 19.3 GFLOP and dk/dv
// 8*B*H*T*T*D = 25.8 GFLOP of bf16 products on about 25 MB each: about 800
// and 1000 operations per byte, well above the card's ridge of 295, so the
// tensor cores bound both. What the designs do about it:
//
// * the TPU grid's sequential inner axis becomes a loop inside the block,
//   and nothing carries over between blocks. dq: one block owns one
//   (batch*head, 64-row query tile); its 4 warps hold 16 query rows each,
//   with Q and dO fragments in registers, and loop over 64-key K/V tiles
//   staged in shared memory. dk/dv: one block owns one (batch*head, 64-key
//   tile); its 4 warps hold 16 keys each, with K and V fragments resident in
//   registers, and loop over query tiles of Q and dO staged in shared
//   memory. Their grids are B*H*(T/64) blocks: 1536 at the shape above,
//   about 12 waves of 132 SMs;
// * every product is a warp-level `mma.sync.m16n8k16` with fp32
//   accumulation (the forward kernel's fragments, flash_common.cuh). The
//   dk/dv kernel computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//   come out as accumulator fragments whose rows are its own keys, and turn
//   into the A operand of P^T dO and dS^T Q without leaving registers;
// * the cast points are the TPU kernels': ds is rounded to bf16 once before
//   its product with K (dq) or Q (dk), p once before its product with dO
//   (dv); the scale multiplies the fp32 sums;
// * a masked score gives p = 0 by selection, not by exp(-1e30 - lse): the
//   row of an example with vl = 0 has lse = -1e30, where the subtraction
//   would give p = 1. Tiles past the valid length or the causal edge are
//   never loaded; key rows past the valid length get exact zeros in dk and
//   dv, and so does a whole block past it;
// * a ragged T (not a multiple of the tile) is zero-filled and masked;
// * at D = 128 the dk/dv kernel takes 32-row query tiles, which keeps its
//   resident K/V fragments and fp32 accumulators within the register file.
// ldmatrix, wgmma, TMA and a pipelined tile ring are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBM = 64;  // query rows a dq block owns
constexpr int kBN = 64;  // keys a K/V tile (dq) or a dk/dv block holds

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int32_t* __restrict__ valid_len,
                __nv_bfloat16* __restrict__ dq, int heads, int tq, int tk,
                float scale, int causal) {
  constexpr int kPitch = D + 8;
  constexpr int kChunks = D / 16;   // k-steps of Q K^T and dO V^T
  constexpr int kDTiles = D / 8;    // n-tiles of a dq row block
  constexpr int kNTiles = kBN / 8;  // n-tiles of one score tile
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
  const int kv_end = causal ? min(kv_len, q0 + kBM) : kv_len;

  const size_t qoff = (size_t)bh * tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * tk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * tk * D;

  uint32_t qa[kChunks][4], da[kChunks][4];
  load_a_rows<D>(qa, q + qoff, r0, r1, tq, t);
  load_a_rows<D>(da, dout + qoff, r0, r1, tq, t);
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;
  const float lse0 = r0 < tq ? lb[r0] * kLog2e : 0.f;
  const float lse1 = r1 < tq ? lb[r1] * kLog2e : 0.f;
  const float dl0 = r0 < tq ? db[r0] : 0.f;
  const float dl1 = r1 < tq ? db[r1] : 0.f;
  const float scale_log2 = scale * kLog2e;

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    load_tile<D, kBN>(ks, kb, n0, tk);
    load_tile<D, kBN>(vs, vb, n0, tk);
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * kPitch + 2 * t;
      const __nv_bfloat16* vr = vs + (j * 8 + g) * kPitch + 2 * t;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        mma_16816(s[j], qa[c], load_pair(kr + c * 16), load_pair(kr + c * 16 + 8));
        mma_16816(dp[j], da[c], load_pair(vr + c * 16), load_pair(vr + c * 16 + 8));
      }
    }
    // s becomes ds = p * (dp - delta), p = exp(scale * s - lse) where kept
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool keep = row < tq && col < kv_len && (!causal || col <= row);
        const float p = keep ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
    }
    // dq += ds K: ds (rounded to bf16) is the A operand, K the B operand
    // with keys as the reduction axis
#pragma unroll
    for (int c = 0; c < kBN / 16; ++c) {
      const uint32_t a[4] = {pack_f32(s[2 * c][0], s[2 * c][1]),
                             pack_f32(s[2 * c][2], s[2 * c][3]),
                             pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_f32(s[2 * c + 1][2], s[2 * c + 1][3])};
      const __nv_bfloat16* kc = ks + (c * 16 + 2 * t) * kPitch + g;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const __nv_bfloat16* p = kc + j * 8;
        mma_16816(acc[j], a, pack_bf16(p[0], p[kPitch]),
                  pack_bf16(p[8 * kPitch], p[9 * kPitch]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = dq + qoff;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * D + col) =
          pack_f32(acc[j][0] * scale, acc[j][1] * scale);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * D + col) =
          pack_f32(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int32_t* __restrict__ valid_len,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 int heads, int tq, int tk, float scale, int causal) {
  constexpr int kBQ = D <= 64 ? 64 : 32;  // query rows a loop step stages
  constexpr int kPitch = D + 8;
  constexpr int kChunks = D / 16;   // k-steps of K Q^T and V dO^T
  constexpr int kDTiles = D / 8;    // n-tiles of a dk/dv row block
  constexpr int kQTiles = kBQ / 8;  // n-tiles of one transposed score tile
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ * kPitch];
  __shared__ __align__(16) __nv_bfloat16 dos[kBQ * kPitch];
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = k0 + warp * 16 + g;  // this lane's two key rows
  const int c1 = c0 + 8;

  int kv_len = tk;
  if (valid_len != nullptr) kv_len = min(max(valid_len[bh / heads], 0), tk);

  const size_t koff = (size_t)bh * tk * D;
  __nv_bfloat16* dkb = dk + koff;
  __nv_bfloat16* dvb = dv + koff;
  if (k0 >= kv_len) {
    // every key of this block is past the valid length: exact zeros
    const int rows = min(kBN, tk - k0);
    for (int i = threadIdx.x; i < rows * (D / 8); i += kWarps * 32) {
      const size_t off = (size_t)(k0 + i / (D / 8)) * D + (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(dkb + off) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dvb + off) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  uint32_t ka[kChunks][4], va[kChunks][4];
  load_a_rows<D>(ka, k + koff, c0, c1, tk, t);
  load_a_rows<D>(va, v + koff, c0, c1, tk, t);
  const size_t qoff = (size_t)bh * tq * D;
  const float* lb = lse + (size_t)bh * tq;
  const float* db = delta + (size_t)bh * tq;
  const float scale_log2 = scale * kLog2e;

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  // causal: query rows before k0 see none of these keys
  for (int m0 = causal ? (k0 / kBQ) * kBQ : 0; m0 < tq; m0 += kBQ) {
    load_tile<D, kBQ>(qs, q + qoff, m0, tq);
    load_tile<D, kBQ>(dos, dout + qoff, m0, tq);
    for (int i = threadIdx.x; i < kBQ; i += kWarps * 32) {
      const int r = m0 + i;
      lse_s[i] = r < tq ? lb[r] * kLog2e : 0.f;
      delta_s[i] = r < tq ? db[r] : 0.f;
    }
    __syncthreads();

    float s[kQTiles][4], dp[kQTiles][4];  // S^T and dP^T: rows keys, columns queries
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const __nv_bfloat16* qr = qs + (j * 8 + g) * kPitch + 2 * t;
      const __nv_bfloat16* dr = dos + (j * 8 + g) * kPitch + 2 * t;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        mma_16816(s[j], ka[c], load_pair(qr + c * 16), load_pair(qr + c * 16 + 8));
        mma_16816(dp[j], va[c], load_pair(dr + c * 16), load_pair(dr + c * 16 + 8));
      }
    }
    // s becomes p, dp becomes ds = p * (dp - delta)
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        const int row = m0 + qi;
        const int col = e < 2 ? c0 : c1;
        const bool keep = row < tq && col < kv_len && (!causal || col <= row);
        const float p = keep ? exp2f(s[j][e] * scale_log2 - lse_s[qi]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - delta_s[qi]);
      }
    }
    // dv += P^T dO and dk += dS^T Q: p and ds (rounded to bf16) are the A
    // operands, dO and Q the B operands with queries as the reduction axis
#pragma unroll
    for (int c = 0; c < kBQ / 16; ++c) {
      const uint32_t pa[4] = {pack_f32(s[2 * c][0], s[2 * c][1]),
                              pack_f32(s[2 * c][2], s[2 * c][3]),
                              pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_f32(s[2 * c + 1][2], s[2 * c + 1][3])};
      const uint32_t sa[4] = {pack_f32(dp[2 * c][0], dp[2 * c][1]),
                              pack_f32(dp[2 * c][2], dp[2 * c][3]),
                              pack_f32(dp[2 * c + 1][0], dp[2 * c + 1][1]),
                              pack_f32(dp[2 * c + 1][2], dp[2 * c + 1][3])};
      const __nv_bfloat16* dc = dos + (c * 16 + 2 * t) * kPitch + g;
      const __nv_bfloat16* qc = qs + (c * 16 + 2 * t) * kPitch + g;
#pragma unroll
      for (int j = 0; j < kDTiles; ++j) {
        const __nv_bfloat16* pd = dc + j * 8;
        mma_16816(dva[j], pa, pack_bf16(pd[0], pd[kPitch]),
                  pack_bf16(pd[8 * kPitch], pd[9 * kPitch]));
        const __nv_bfloat16* pq = qc + j * 8;
        mma_16816(dka[j], sa, pack_bf16(pq[0], pq[kPitch]),
                  pack_bf16(pq[8 * kPitch], pq[9 * kPitch]));
      }
    }
    __syncthreads();
  }

  // key rows past the valid length are written as exact zeros
  const bool keep0 = c0 < kv_len;
  const bool keep1 = c1 < kv_len;
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
    const int col = j * 8 + 2 * t;
    if (c0 < tk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)c0 * D + col) =
          keep0 ? pack_f32(dka[j][0] * scale, dka[j][1] * scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + (size_t)c0 * D + col) =
          keep0 ? pack_f32(dva[j][0], dva[j][1]) : 0u;
    }
    if (c1 < tk) {
      *reinterpret_cast<uint32_t*>(dkb + (size_t)c1 * D + col) =
          keep1 ? pack_f32(dka[j][2] * scale, dka[j][3] * scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + (size_t)c1 * D + col) =
          keep1 ? pack_f32(dva[j][2], dva[j][3]) : 0u;
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int32_t* valid_len,
              void* dq, int batch_heads, int heads, int tq, int tk, float scale,
              int causal, cudaStream_t stream) {
  const dim3 grid((tq + kBM - 1) / kBM, batch_heads);
  flash_dq_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, valid_len, static_cast<__nv_bfloat16*>(dq), heads, tq, tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int32_t* valid_len,
               void* dk, void* dv, int batch_heads, int heads, int tq, int tk,
               float scale, int causal, cudaStream_t stream) {
  const dim3 grid((tk + kBN - 1) / kBN, batch_heads);
  flash_dkv_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      lse, delta, valid_len, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, dout, dq: (batch_heads, tq, d); k, v, dk, dv: (batch_heads, tk, d); all
// bf16 and contiguous. lse (the forward's logsumexp) and delta
// (rowsum(dO * O)): (batch_heads, tq) float32. valid_len: (batch_heads /
// heads,) int32 or null. Each returns the cudaError_t of its launch.
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, const int32_t* valid_len,
                                void* dq, int batch_heads, int heads, int tq,
                                int tk, int d, float scale, int causal,
                                void* stream) {
  if (tq == 0 || batch_heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, valid_len, dq, batch_heads,
                           heads, tq, tk, scale, causal, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, valid_len, dq, batch_heads,
                            heads, tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int32_t* valid_len,
                                 void* dk, void* dv, int batch_heads, int heads,
                                 int tq, int tk, int d, float scale, int causal,
                                 void* stream) {
  if (tk == 0 || batch_heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, valid_len, dk, dv,
                            batch_heads, heads, tq, tk, scale, causal, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, valid_len, dk, dv,
                             batch_heads, heads, tq, tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
