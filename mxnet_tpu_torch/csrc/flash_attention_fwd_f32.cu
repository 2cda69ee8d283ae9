// Flash-attention forward for fp32 q, k and v (Hopper, sm_90a), fp32
// throughout.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py
// `_flash_fwd` for fp32 operands. The TPU kernel takes its operands in
// their own dtype (`_scores`' dot_general with an fp32 accumulator), so
// the quantized models, whose Dense layers give fp32 activations, run it
// on fp32 q, k and v; the bf16 kernel (flash_attention_fwd.cu, on wgmma)
// takes bf16 only. This form keeps the fp32 numerics rather than rounding
// the operands to bf16: the same flags (causal, a per-example valid key
// length whose masked tiles are skipped, exact zeros and lse -1e30 for a
// row with no valid key, an optional per-row logsumexp) and the same
// online softmax, with p kept in fp32 for the second product (the TPU
// kernel's `p.astype(v.dtype)` is exact here).
//
// The design is the simple one: fp32 products on the CUDA cores, no tensor
// cores (TF32 would round the operands to 10 mantissa bits).
//
// * a CTA of 128 threads owns one (batch*head, tile of 32 query rows);
//   four threads share a row, each holding a quarter of the row's q and of
//   its output accumulator in registers, as float4 chunks c, c + 4, c + 8,
//   ... so that the four read 64 consecutive bytes of a key row (no bank
//   conflict; the eight rows of a warp read the same key row, a broadcast);
// * K and V tiles (64 keys at D = 64, 32 at D = 128: 32 KB of shared
//   memory either way) are copied in with 16-byte loads, zero-filled past
//   the sequence; a score is the four threads' partial dot products summed
//   by two xor shuffles, so all four hold the same bits;
// * per tile a row takes the tile's scores into registers, its new maximum,
//   one rescale of the accumulator and denominator, then p = exp(s - m)
//   (0 for a masked key) against the V tile;
// * the loop ends at the last key any row of the CTA may see (the valid
//   length, and the causal edge of its last row), so masked tiles are
//   neither loaded nor computed.
//
// What bounds it on the H100: at BERT's served shape (B 8, H 12, T 512,
// D 64) it does 4*B*H*T*T*D = 6.4 GFLOP of fp32 products, 0.096 ms at
// 67 TFLOP/s outside the tensor cores, and moves 50 MB, 0.015 ms: the
// operations bound it. Double-buffered tiles and the tensor cores' 3xTF32
// products are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                  // query rows a CTA
constexpr int kLanes = 4;                  // threads a query row
constexpr int kThreads = kRows * kLanes;   // 128

template <int D>
struct F32Shape {
  static constexpr int kKeys = D == 64 ? 64 : 32;  // keys a K/V tile
  static constexpr int kVecs = D / 4;               // float4 a key row
  static constexpr int kChunks = kVecs / kLanes;    // float4 a thread owns
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 v, float4& acc) {
  acc.x = fmaf(p, v.x, acc.x);
  acc.y = fmaf(p, v.y, acc.y);
  acc.z = fmaf(p, v.z, acc.z);
  acc.w = fmaf(p, v.w, acc.w);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ valid_len,
                         float* __restrict__ o, float* __restrict__ lse,
                         int heads, int tq, int tk, float scale, int causal) {
  using S = F32Shape<D>;
  constexpr int kBN = S::kKeys;
  constexpr int kV = S::kVecs;
  constexpr int kC = S::kChunks;
  __shared__ float4 ks[kBN * kV];
  __shared__ float4 vs[kBN * kV];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int row = q0 + tid / kLanes;
  int kv_len = tk;
  if (valid_len != nullptr) kv_len = min(max(valid_len[bh / heads], 0), tk);
  const int kv_end = causal ? min(kv_len, q0 + kRows) : kv_len;
  // keys [0, row_end) are this row's
  const int row_end = causal ? min(kv_len, row + 1) : kv_len;

  // a row past the end reads row tq - 1 and writes nothing
  const float4* qb = reinterpret_cast<const float4*>(
      q + ((size_t)bh * tq + min(row, tq - 1)) * D);
  float4 qr[kC], acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    qr[c] = qb[lane + kLanes * c];
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = -1e30f, l = 0.f;
  const float4* kb = reinterpret_cast<const float4*>(k + (size_t)bh * tk * D);
  const float4* vb = reinterpret_cast<const float4*>(v + (size_t)bh * tk * D);

  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // every row is done with the last tile
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = tid; i < kBN * kV; i += kThreads) {
      const bool in = n0 + i / kV < tk;
      const size_t g = (size_t)n0 * kV + i;
      ks[i] = in ? kb[g] : zero;
      vs[i] = in ? vb[g] : zero;
    }
    __syncthreads();

    float s[kBN];
    float tmax = -1e30f;
#pragma unroll
    for (int j = 0; j < kBN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        part = dot4(qr[c], ks[j * kV + lane + kLanes * c], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      s[j] = part * scale;
      if (n0 + j < row_end) tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBN; ++j) {
      const float p = n0 + j < row_end ? expf(s[j] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        axpy4(p, vs[j * kV + lane + kLanes * c], acc[c]);
    }
    m = m_new;
  }

  if (row >= tq) return;
  const float den = fmaxf(l, 1e-30f);
  float4* ob = reinterpret_cast<float4*>(o + ((size_t)bh * tq + row) * D);
#pragma unroll
  for (int c = 0; c < kC; ++c)
    ob[lane + kLanes * c] = make_float4(acc[c].x / den, acc[c].y / den,
                                        acc[c].z / den, acc[c].w / den);
  // the TPU kernel's m + log(max(l, 1e-30)), -1e30 for a row that saw no
  // valid key
  if (lse != nullptr && lane == 0)
    lse[(size_t)bh * tq + row] = l > 0.f ? m + logf(l) : -1e30f;
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const int32_t* valid_len, float* o, float* lse, int batch_heads,
           int heads, int tq, int tk, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid((tq + kRows - 1) / kRows, batch_heads);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
      q, k, v, valid_len, o, lse, heads, tq, tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (batch_heads, tq, d); k, v: (batch_heads, tk, d); all float32,
// contiguous and 16-byte aligned. valid_len: (batch_heads / heads,) int32
// or null. lse: (batch_heads, tq) float32 or null. Returns the cudaError_t
// of the launch.
extern "C" int mxt_flash_fwd_f32(const float* q, const float* k,
                                 const float* v, const int32_t* valid_len,
                                 float* o, float* lse, int batch_heads,
                                 int heads, int tq, int tk, int d, float scale,
                                 int causal, void* stream) {
  if (tq == 0 || batch_heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, valid_len, o, lse, batch_heads, heads, tq,
                        tk, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, valid_len, o, lse, batch_heads, heads, tq,
                         tk, scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
