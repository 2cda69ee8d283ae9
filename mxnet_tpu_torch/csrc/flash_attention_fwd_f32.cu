// Flash-attention forward for fp32 q, k and v (Hopper, sm_90a): products on
// the tensor cores in 3xTF32, fp32 softmax and sums.
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
// What bounds it on the H100: at BERT's served shape (B 8, H 12, T 512,
// D 64, all keys) it does 4*B*H*T*T*D = 6.4 GFLOP of fp32-accurate
// products and moves 50 MB (0.015 ms at 3.35 TB/s): the operations bound
// it. On the CUDA cores (67 TFLOP/s) that is 0.096 ms; the tensor cores
// take TF32 at 495 TFLOP/s, and 3xTF32 keeps close to fp32 accuracy at a
// third of that, 165 TFLOP/s (0.039 ms). The design:
//
// * 3xTF32: each fp32 operand x is big, x rounded to tf32 (to nearest,
//   ties away, as cvt.rna.tf32.f32), plus small, the exact remainder
//   x - big cut to tf32; a product is small*big + big*small + big*big with
//   fp32 sums (small*small, under 2^-21 of the product, is dropped). The
//   split takes four integer and fp32 operations, no conversion
//   instruction.
// * each element is split once a CTA: Q when the CTA starts, each K/V tile
//   when its copy has landed, into shared memory; P in registers before
//   the second product. Splitting K and V in every warp's registers
//   instead took 7% more time at BERT's shape on an H100
//   (tools/cuda_flash_f32_bench.py).
// * mma.sync.m16n8k8 (tf32): its fragments are loaded element by element,
//   so any layout will do. A CTA of 8 warps owns 128 query rows, 16 a warp.
//   Within each 8-wide k step, logical column c < 4 is physical column
//   2c and c + 4 is 2c + 1 (the same on both operands, so the sum is the
//   same), and the split operands are stored as 16-byte chunks (big 2c,
//   big 2c + 1, small 2c, small 2c + 1): a thread's Q, K or V fragment,
//   both halves, is one 16-byte read, and the scores' C fragment is P's A
//   fragment as it stands (no shuffle). V is stored transposed (a row a
//   head-dim column, chunks over key pairs) for that. Rows padded by 16
//   floats keep every fragment read free of bank conflicts. Each pass
//   issues the same product for several accumulators in a row, so no mma
//   waits on the one before.
// * the softmax runs in base 2 (ex2.approx, the scale times log2 e folded
//   into the scores), and a tile below every row's end in a warp (not the
//   causal diagonal, not past the valid length) skips the mask.
// * the tensor cores' fp32 accumulation may truncate, so the output is
//   not carried in the mma's accumulator across the key loop: each (tile,
//   output column block) sums into a zeroed fragment, added to the running
//   output in fp32 with the online softmax's rescale.
// * K/V tiles (64 keys at D = 64, 16 at D = 128) come by cp.async into one
//   stage, the next tile's copy in flight under this tile's products: with
//   Q split and the tile split, 178 KB of dynamic shared memory at D = 64,
//   194 KB at D = 128 (one CTA an SM).
// * a split key range when the grid is under a wave (the Python wrapper's
//   `flash_f32_splits` chooses it: a batch-1 causal prefill at T = 1024 has
//   96 CTAs on 132 SMs, and its last query tile runs 16 key tiles while the
//   first runs 2): split z of a query tile takes its key tiles [z * chunk,
//   (z + 1) * chunk), so a long query tile gets more CTAs than a short
//   one. A query tile with one split writes its output; one with more
//   writes each split's unnormalized output, max and sum to a workspace,
//   and a combine kernel merges them in split order: no float atomics, so
//   two calls give the same bits.
// * the key loop ends at the last key any row of the CTA may see (the
//   valid length, and the causal edge of its last row), so masked tiles
//   are neither loaded nor computed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 8;                // warps a CTA, 16 query rows each
constexpr int kRows = 16 * kWarps;       // query rows a CTA
constexpr int kThreads = 32 * kWarps;
template <int D>
struct F32Shape {
  static constexpr int kKeys = D == 64 ? 64 : 16;  // keys a K/V tile
  // A split row of Q or K holds, for each column pair (2c, 2c + 1), the 16
  // bytes (big 2c, big 2c + 1, small 2c, small 2c + 1), a k step's four
  // pairs side by side; a split row of V^T (one head-dim column) the same
  // over key pairs. 16 floats of padding put rows g and g + 1 in opposite
  // halves of the banks, so a quarter warp's 16-byte reads never collide.
  static constexpr int kS2 = 2 * D + 16;
  static constexpr int kVT2 = 2 * kKeys + 16;
  static constexpr int kRaw = D + 4;  // a copied K or V row, fp32
  // Q split, the copy's K and V, K split, V^T split
  static constexpr int kSmemBytes =
      (kRows * kS2 + 2 * kKeys * kRaw + kKeys * kS2 + D * kVT2) * 4;
};

// x = big + small, each a tf32 value (10 mantissa bits): big is x rounded
// to nearest, ties away from zero (what cvt.rna.tf32.f32 gives, in two
// integer operations), small the exact remainder x - big cut to tf32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// the split chunk of the pair (x, y): big x, big y, small x, small y
__device__ __forceinline__ uint4 split_pair(float x, float y) {
  uint4 r;
  split(x, r.x, r.z);
  split(y, r.y, r.w);
  return r;
}

// floats into a split row of the chunk of column pair (d, d + 1), d even
__device__ __forceinline__ int pair_offset(int d) {
  return 16 * (d / 8) + 2 * (d % 8);
}

// d += a b, m16n8k8, tf32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i] += a b[i] for N accumulators in 3xTF32: the two cross terms, then
// big * big, each pass over all N so that no mma waits on the one before
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], as, bb[i][0], bb[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bs[i][0], bs[i][1]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], ab, bb[i][0], bb[i][1]);
}

// key tiles a query tile starting at row q0 runs: up to the valid length,
// and with `causal` up to its last row's edge
template <int D>
__device__ __forceinline__ int key_tiles(int q0, int kv_len, int causal) {
  constexpr int kBN = F32Shape<D>::kKeys;
  const int kv_end = causal ? min(kv_len, q0 + kRows) : kv_len;
  return (kv_end + kBN - 1) / kBN;
}

__device__ __forceinline__ int valid_keys(const int32_t* valid_len, int bh,
                                          int heads, int tk) {
  return valid_len == nullptr ? tk
                              : min(max(valid_len[bh / heads], 0), tk);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int32_t* __restrict__ valid_len,
                         float* __restrict__ o, float* __restrict__ lse,
                         float* __restrict__ work, int heads, int tq, int tk,
                         float scale, int causal, int chunk) {
  using S = F32Shape<D>;
  constexpr int kBN = S::kKeys;
  constexpr int kS2 = S::kS2;
  constexpr int kVT2 = S::kVT2;
  constexpr int kRaw = S::kRaw;
  constexpr int kNT = kBN / 8;  // score n-tiles; k steps of P V
  constexpr int kDT = D / 8;    // k steps of Q K^T; output n-tiles
  constexpr int kC = D / 4;     // float4 a row
  constexpr int kNG = 4;        // output n-tiles a pass of P V
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // kRows split rows
  float* k_raw = q_s + kRows * kS2;     // the copy: K, then V
  float* v_raw = k_raw + kBN * kRaw;
  float* k_s = v_raw + kBN * kRaw;      // kBN split rows
  float* vt_s = k_s + kBN * kS2;        // D split rows of V^T

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int split_id = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int kv_len = valid_keys(valid_len, bh, heads, tk);
  const int tiles = key_tiles<D>(q0, kv_len, causal);
  const int splits_here = (tiles + chunk - 1) / chunk;  // 0 with no key
  if (split_id > 0 && split_id >= splits_here) return;
  const int t0 = split_id * chunk;
  const int t1 = min(t0 + chunk, tiles);

  // Q, split once: rows past tq are zero and write nothing
  const float* qg = q + (size_t)bh * tq * D;
#pragma unroll
  for (int it = 0; it < kRows * kC / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kC, c = (i % kC) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < tq)
      x = *reinterpret_cast<const float4*>(qg + (size_t)(q0 + r) * D + c);
    uint4* dst = reinterpret_cast<uint4*>(q_s + r * kS2 + pair_offset(c));
    dst[0] = split_pair(x.x, x.y);
    dst[1] = split_pair(x.z, x.w);
  }

  const float* kg = k + (size_t)bh * tk * D;
  const float* vg = v + (size_t)bh * tk * D;
  // K/V tile `tile` into the copy by cp.async; keys >= tk are zero-filled
  auto load_tile = [&](int tile) {
    const int n0 = tile * kBN;
#pragma unroll
    for (int it = 0; it < kBN * kC / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kC, c = (i % kC) * 4;
      const bool ok = n0 + r < tk;
      const size_t off = ok ? (size_t)(n0 + r) * D + c : 0;
      flash::cp_async16(flash::smem_addr(k_raw + r * kRaw + c), kg + off, ok);
      flash::cp_async16(flash::smem_addr(v_raw + r * kRaw + c), vg + off, ok);
    }
  };
  // the copied tile split, each element once a CTA: K by rows, V into V^T
  // (a thread takes a key pair and four head-dim columns)
  auto split_tile = [&]() {
#pragma unroll
    for (int it = 0; it < kBN * kC / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kC, c = (i % kC) * 4;
      const float4 x = *reinterpret_cast<const float4*>(k_raw + r * kRaw + c);
      uint4* dst = reinterpret_cast<uint4*>(k_s + r * kS2 + pair_offset(c));
      dst[0] = split_pair(x.x, x.y);
      dst[1] = split_pair(x.z, x.w);
    }
    constexpr int kPairs = kBN / 2;
#pragma unroll
    for (int it = 0; it < kPairs * kC / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int p = i % kPairs, c = (i / kPairs) * 4;
      const float4 a =
          *reinterpret_cast<const float4*>(v_raw + 2 * p * kRaw + c);
      const float4 b =
          *reinterpret_cast<const float4*>(v_raw + (2 * p + 1) * kRaw + c);
      float* dst = vt_s + c * kVT2 + pair_offset(2 * p);
      *reinterpret_cast<uint4*>(dst) = split_pair(a.x, b.x);
      *reinterpret_cast<uint4*>(dst + kVT2) = split_pair(a.y, b.y);
      *reinterpret_cast<uint4*>(dst + 2 * kVT2) = split_pair(a.z, b.z);
      *reinterpret_cast<uint4*>(dst + 3 * kVT2) = split_pair(a.w, b.w);
    }
  };

  // this thread's rows r0 and r0 + 8; keys [0, row_end) are a row's; no
  // row of this warp ends before warp_end
  const int r0 = q0 + warp * 16 + g;
  int row_end[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    row_end[h] = causal ? min(kv_len, r0 + 8 * h + 1) : kv_len;
  const int warp_end = causal ? min(kv_len, q0 + warp * 16 + 1) : kv_len;
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max (base-2 units) and this thread's part of the sum
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  const float scale2 = scale * flash::kLog2e;
  const float* q_row = q_s + (warp * 16 + g) * kS2 + 4 * t;

  if (t0 < t1) load_tile(t0);
  for (int tile = t0; tile < t1; ++tile) {
    flash::cp_async_commit();
    flash::cp_async_wait<0>();
    // the copy is in (and, the first time, Q); every warp is done with the
    // last tile's halves
    __syncthreads();
    split_tile();
    __syncthreads();  // the halves are in; the copy is free
    // the next tile's copy runs under this tile's products
    if (tile + 1 < t1) load_tile(tile + 1);

    // scores, 16 rows x kBN keys a warp
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDT; ++kk) {
      const uint4 x = *reinterpret_cast<const uint4*>(q_row + 16 * kk);
      const uint4 y =
          *reinterpret_cast<const uint4*>(q_row + 8 * kS2 + 16 * kk);
      const uint32_t ab[4] = {x.x, y.x, x.y, y.y};
      const uint32_t as[4] = {x.z, y.z, x.w, y.w};
      uint32_t kb[kNT][2], ksm[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint4 z = *reinterpret_cast<const uint4*>(
            k_s + (8 * j + g) * kS2 + 16 * kk + 4 * t);
        kb[j][0] = z.x;
        kb[j][1] = z.y;
        ksm[j][0] = z.z;
        ksm[j][1] = z.w;
      }
      mma_3xtf32(s, ab, as, kb, ksm);
    }

    // online softmax in base 2: a row's kBN scores lie in its quad, 2 per
    // n-tile; a tile below every row's end of this warp takes no mask
    const int n0 = tile * kBN;
    float alpha[2];
    uint32_t pb[kNT][4], ps[kNT][4];
    auto softmax = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      float tmax[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale2;
          if (!kMasked || n0 + 8 * j + 2 * t + (e & 1) < row_end[e >> 1])
            tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], flash::quad_max(tmax[h]));
        alpha[h] = flash::fast_exp2(m[h] - m_new);
        l[h] *= alpha[h];
        m[h] = m_new;
      }
      // P's A fragments, split: a0 (g, key 2t) = c0, a1 (g + 8, 2t) = c2,
      // a2 (g, 2t + 1) = c1, a3 (g + 8, 2t + 1) = c3
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = !kMasked ||
                         n0 + 8 * j + 2 * t + (e & 1) < row_end[e >> 1]
                     ? flash::fast_exp2(s[j][e] - m[e >> 1])
                     : 0.f;
          l[e >> 1] += p[e];
        }
        split(p[0], pb[j][0], ps[j][0]);
        split(p[2], pb[j][1], ps[j][1]);
        split(p[1], pb[j][2], ps[j][2]);
        split(p[3], pb[j][3], ps[j][3]);
      }
    };
    if (n0 + kBN <= warp_end)
      softmax(std::false_type());
    else
      softmax(std::true_type());

    // output += P V, kNG output n-tiles at a time: each sums the tile's
    // keys into a zeroed fragment, then joins the rescaled running sum in
    // fp32
    const float* vt_row = vt_s + g * kVT2 + 4 * t;
#pragma unroll
    for (int nb = 0; nb < kDT; nb += kNG) {
      float part[kNG][4];
#pragma unroll
      for (int i = 0; i < kNG; ++i)
        part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t vb[kNG][2], vsm[kNG][2];
#pragma unroll
        for (int i = 0; i < kNG; ++i) {
          const uint4 z = *reinterpret_cast<const uint4*>(
              vt_row + 8 * (nb + i) * kVT2 + 16 * j);
          vb[i][0] = z.x;
          vb[i][1] = z.y;
          vsm[i][0] = z.z;
          vsm[i][1] = z.w;
        }
        mma_3xtf32(part, pb[j], ps[j], vb, vsm);
      }
#pragma unroll
      for (int i = 0; i < kNG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[nb + i][e] = fmaf(acc[nb + i][e], alpha[e >> 1], part[i][e]);
    }
  }
  flash::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = flash::quad_sum(l[h]);
  const bool partial = splits_here > 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= tq) continue;
    const size_t rowi = (size_t)bh * tq + row;
    if (!partial) {
      const float den = fmaxf(l[h], 1e-30f);
      float* ob = o + rowi * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        *reinterpret_cast<float2*>(ob + 8 * n) =
            make_float2(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
      // the TPU kernel's m + log(max(l, 1e-30)), -1e30 for a row that saw
      // no valid key
      if (lse != nullptr && t == 0)
        lse[rowi] = l[h] > 0.f ? m[h] * flash::kLn2 + logf(l[h]) : -1e30f;
    } else {
      // split z's unnormalized output (z, bh, row, D), then its (max in
      // base 2, sum)
      const size_t plane = (size_t)gridDim.y * tq;
      const size_t zi = split_id * plane + rowi;
      float* wb = work + zi * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kDT; ++n)
        *reinterpret_cast<float2*>(wb + 8 * n) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(work + gridDim.z * plane * D + zi * 2) =
            make_float2(m[h], l[h]);
    }
  }
}

// Merges the splits of every query tile that has more than one, in split
// order: one thread a float4 of a row
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_combine(const float* __restrict__ work,
                          const int32_t* __restrict__ valid_len,
                          float* __restrict__ o, float* __restrict__ lse,
                          int batch_heads, int heads, int tq, int tk,
                          int causal, int splits, int chunk) {
  constexpr int kC = D / 4;
  const size_t plane = (size_t)batch_heads * tq;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane * kC) return;
  const int c = i % kC;
  const size_t rowi = i / kC;
  const int row = rowi % tq, bh = rowi / tq;
  const int kv_len = valid_keys(valid_len, bh, heads, tk);
  const int tiles = key_tiles<D>(row / kRows * kRows, kv_len, causal);
  const int n = (tiles + chunk - 1) / chunk;
  if (n <= 1) return;  // the main kernel wrote this row
  const float2* ml =
      reinterpret_cast<const float2*>(work + splits * plane * D);
  float mx = -1e30f;
  for (int z = 0; z < n; ++z) mx = fmaxf(mx, ml[z * plane + rowi].x);
  float den = 0.f;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < n; ++z) {
    const float2 st = ml[z * plane + rowi];
    const float w = exp2f(st.x - mx);
    den = fmaf(st.y, w, den);
    const float4 x =
        reinterpret_cast<const float4*>(work + (z * plane + rowi) * D)[c];
    sum.x = fmaf(x.x, w, sum.x);
    sum.y = fmaf(x.y, w, sum.y);
    sum.z = fmaf(x.z, w, sum.z);
    sum.w = fmaf(x.w, w, sum.w);
  }
  const float d = fmaxf(den, 1e-30f);
  reinterpret_cast<float4*>(o + rowi * D)[c] =
      make_float4(sum.x / d, sum.y / d, sum.z / d, sum.w / d);
  if (lse != nullptr && c == 0)
    lse[rowi] = den > 0.f ? mx * flash::kLn2 + logf(den) : -1e30f;
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const int32_t* valid_len, float* o, float* lse, float* work,
           int batch_heads, int heads, int tq, int tk, float scale, int causal,
           int splits, int chunk, cudaStream_t stream) {
  constexpr int kSmem = F32Shape<D>::kSmemBytes;
  constexpr int kBN = F32Shape<D>::kKeys;
  // the splits must cover the longest query tile's key range
  const int nq = (tq + kRows - 1) / kRows;
  const int most = causal ? min(tk, nq * kRows) : tk;
  if ((long long)splits * chunk < (most + kBN - 1) / kBN)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((tq + kRows - 1) / kRows, batch_heads, splits);
  flash_fwd_f32_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      q, k, v, valid_len, o, lse, work, heads, tq, tk, scale, causal, chunk);
  if (splits > 1) {
    const size_t n = (size_t)batch_heads * tq * (D / 4);
    flash_fwd_f32_combine<D><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        work, valid_len, o, lse, batch_heads, heads, tq, tk, causal, splits,
        chunk);
  }
  return (int)cudaGetLastError();
}

template <int D>
int tile_of(int* rows, int* keys, int* per_sm) {
  constexpr int kSmem = F32Shape<D>::kSmemBytes;
  *rows = kRows;
  *keys = F32Shape<D>::kKeys;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return (int)attr;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, flash_fwd_f32_kernel<D>, kThreads, kSmem);
}

}  // namespace

// The tile of head dim d: query rows a CTA, keys a K/V tile, and the CTAs
// an SM holds at once (the occupancy the card reports for the kernel with
// its shared memory). The Python wrapper's split choice needs all three.
// Returns a cudaError_t.
extern "C" int mxt_flash_fwd_f32_tile(int d, int* rows, int* keys,
                                      int* per_sm) {
  switch (d) {
    case 64: return tile_of<64>(rows, keys, per_sm);
    case 128: return tile_of<128>(rows, keys, per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, o: (batch_heads, tq, d); k, v: (batch_heads, tk, d); all float32,
// contiguous and 16-byte aligned. valid_len: (batch_heads / heads,) int32
// or null. lse: (batch_heads, tq) float32 or null. The key range of each
// query tile is cut into runs of `chunk` key tiles, at most `splits` of
// them; with splits > 1, work holds splits * batch_heads * tq * (d + 2)
// floats. Returns the cudaError_t of the launches.
extern "C" int mxt_flash_fwd_f32(const float* q, const float* k,
                                 const float* v, const int32_t* valid_len,
                                 float* o, float* lse, float* work,
                                 int batch_heads, int heads, int tq, int tk,
                                 int d, float scale, int causal, int splits,
                                 int chunk, void* stream) {
  if (tq == 0 || batch_heads == 0) return 0;
  if (splits < 1 || chunk < 1 || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, valid_len, o, lse, work, batch_heads, heads,
                        tq, tk, scale, causal, splits, chunk, s);
    case 128:
      return launch<128>(q, k, v, valid_len, o, lse, work, batch_heads, heads,
                         tq, tk, scale, causal, splits, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
