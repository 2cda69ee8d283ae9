// Row LayerNorm backward for Hopper (sm_90a): dx, dgamma and dbeta.
//
// Computes the JAX package's analytic backward `_ln_bwd`
// (mxnet_tpu/ops/pallas/layernorm.py:40), which XLA fuses there (no Pallas
// kernel): per row, fp32 mean and rstd recomputed from x, xhat =
// (x - mean) * rstd, t = dy * gamma, dx = rstd * (t - mean(t) - xhat *
// mean(t * xhat)) in x's dtype; dgamma = sum over rows of dy * xhat and
// dbeta = sum over rows of dy, in fp32.
//
// What bounds it on the H100: bytes. It reads x and dy and writes dx,
// 3*R*C*sizeof(x) bytes (the bert512 step's 8192 x 768 bf16: 37.7 MB, 0.0113
// ms at 3.35 TB/s), at about 16 operations an element.
//
// What the design does about it:
// * dx row by row in one read, in the forward's warp and loop forms
//   (layernorm_common.cuh): x and dy arrive once, as 16-byte vectors, into
//   registers; the statistics (the forward's, in its order) and the two
//   row means come from the registers; dx is written once. The warp form
//   serves every row count: the one path that runs the backward, BERT
//   training, gives it 1280 rows or more.
// * dgamma and dbeta in two stages, in a fixed order, with no atomics, so
//   two calls on the same inputs give bit-equal results: the grid is
//   `parts` CTAs (two waves, 2 x the SM count, or one a kBwdWarps rows
//   when that is fewer), each walking its rows in a grid-stride loop.
//   Every row of a CTA puts a column on the same lane, so a lane keeps its
//   columns' fp32 partials in registers; the CTA adds its warps' partials
//   in warp order in shared memory and writes one partial row of dgamma
//   and one of dbeta (`part`, parts x 2C). The finishing kernel sums the
//   partial rows column by column, each column's rows in a fixed order.
// * the loop form (any other C) keeps its partial rows in `part` and adds
//   each row into them, every column by the thread that owns it.

#include "layernorm_common.cuh"

namespace {

using namespace mxt_ln;

constexpr int kBwdWarps = 8;       // warp form: warps (rows in flight) a CTA
constexpr int kWaves = 2;          // CTAs a call: kWaves x the SM count
constexpr int kFinishSlices = 32;  // finishing kernel: row slices a column

// the row sums of t = dy * gamma and of t * xhat over one vector
template <typename T>
__device__ __forceinline__ void vec_t_sums(const uint4& xu, const uint4& du,
                                           const float* __restrict__ gamma,
                                           int col, float mean, float rstd,
                                           float& st, float& stx) {
  constexpr int kN = kVecN<T>;
  float xf[kN], df[kN], g[kN];
  unpack<T>(xu, xf);
  unpack<T>(du, df);
  load_f32<kN>(gamma + col, g);
  st = 0.f;
  stx = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float t = df[j] * g[j];
    st += t;
    stx = fmaf(t, (xf[j] - mean) * rstd, stx);
  }
}

// dx of one vector; adds dy * xhat and dy into the column partials
template <typename T>
__device__ __forceinline__ uint4 vec_dx(const uint4& xu, const uint4& du,
                                        const float* __restrict__ gamma, int col,
                                        float mean, float rstd, float mt,
                                        float mtx, float (&pg)[kVecN<T>],
                                        float (&pb)[kVecN<T>]) {
  constexpr int kN = kVecN<T>;
  float xf[kN], df[kN], g[kN];
  unpack<T>(xu, xf);
  unpack<T>(du, df);
  load_f32<kN>(gamma + col, g);
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float xhat = (xf[j] - mean) * rstd;
    pg[j] = fmaf(df[j], xhat, pg[j]);
    pb[j] += df[j];
    xf[j] = rstd * (df[j] * g[j] - mt - xhat * mtx);
  }
  return pack<T>(xf);
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kBwdWarps, NV <= 4 ? 2 : 1)
layernorm_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, int64_t rows, int cols,
                          float eps) {
  constexpr int kN = kVecN<T>;
  // a warp's slice: dgamma, then dbeta, of one vector a lane
  constexpr int kSlice = 2 * 32 * kN;
  __shared__ __align__(16) float acc[kBwdWarps * kSlice];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = cols / kN;
  const float inv_c = 1.f / (float)cols;
  float pg[NV][kN], pb[NV][kN];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) pg[i][j] = pb[i][j] = 0.f;

  for (int64_t row = (int64_t)blockIdx.x * kBwdWarps + warp; row < rows;
       row += (int64_t)gridDim.x * kBwdWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * cols);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + row * cols);
    uint4 xv[NV], dv[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      xv[i] = k < nvec ? __ldg(xr + k) : make_uint4(0, 0, 0, 0);
      dv[i] = k < nvec ? __ldg(dr + k) : make_uint4(0, 0, 0, 0);
    }
    float mean, rstd;
    warp_row_stats<T, NV>(xv, lane, nvec, inv_c, eps, mean, rstd);
    float st = 0.f, stx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      if (k < nvec) {
        float a, b;
        vec_t_sums<T>(xv[i], dv[i], gamma, k * kN, mean, rstd, a, b);
        st += a;
        stx += b;
      }
    }
    const float mt = warp_sum(st) * inv_c;
    const float mtx = warp_sum(stx) * inv_c;
    uint4* outr = reinterpret_cast<uint4*>(dx + row * cols);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int k = lane + 32 * i;
      if (k < nvec)
        outr[k] = vec_dx<T>(xv[i], dv[i], gamma, k * kN, mean, rstd, mt, mtx, pg[i],
                            pb[i]);
    }
  }

  // the CTA's partial rows, one block of 32 vectors of columns (a lane's
  // vector i) at a time: every warp puts its partials in its own slice of
  // acc, then each column's slices are added in warp order
  float* pr = part + (int64_t)blockIdx.x * 2 * cols;
  float4* mine = reinterpret_cast<float4*>(acc + warp * kSlice) + lane * (kN / 4);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {
      mine[q] = make_float4(pg[i][4 * q], pg[i][4 * q + 1], pg[i][4 * q + 2],
                            pg[i][4 * q + 3]);
      mine[kSlice / 8 + q] = make_float4(pb[i][4 * q], pb[i][4 * q + 1],
                                         pb[i][4 * q + 2], pb[i][4 * q + 3]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kSlice; t += blockDim.x) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) sum += acc[w * kSlice + t];
      const int c = i * (kSlice / 2) + t % (kSlice / 2);
      if (c < cols) pr[(t >= kSlice / 2 ? cols : 0) + c] = sum;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
layernorm_bwd_loop_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, int64_t rows, int cols,
                          float eps) {
  constexpr int kN = kVecN<T>;
  __shared__ float red[4][32];
  const float inv_c = 1.f / (float)cols;
  float* pgr = part + (int64_t)blockIdx.x * 2 * cols;
  float* pbr = pgr + cols;
  // column c of the partial rows belongs to thread c % blockDim.x
  for (int c = threadIdx.x; c < cols; c += blockDim.x) pgr[c] = pbr[c] = 0.f;

  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * cols;
    const T* dr = dy + row * cols;
    int head, nvec;
    split_row<T>(xr, dr, cols, head, nvec);
    const float mean =
        block_sum(row_pass<T>(xr, cols, head, nvec,
                              [](float v, int) { return v; },
                              [](const uint4& u, int) { return vec_sum<T>(u); }),
                  red[0]) * inv_c;
    const float rstd = rsqrtf(
        block_sum(row_pass<T>(xr, cols, head, nvec,
                              [mean](float v, int) {
                                const float d = v - mean;
                                return d * d;
                              },
                              [mean](const uint4& u, int) { return vec_sq<T>(u, mean); }),
                  red[1]) * inv_c + eps);
    float st = 0.f, stx = 0.f;
    for (int c = threadIdx.x; c < head; c += blockDim.x) {
      const float t = to_f32(dr[c]) * __ldg(gamma + c);
      st += t;
      stx += t * ((to_f32(xr[c]) - mean) * rstd);
    }
    const uint4* xb = reinterpret_cast<const uint4*>(xr + head);
    const uint4* db = reinterpret_cast<const uint4*>(dr + head);
    for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
      float xf[kN], df[kN];
      unpack<T>(__ldg(xb + k), xf);
      unpack<T>(__ldg(db + k), df);
      const int c0 = head + k * kN;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float t = df[j] * __ldg(gamma + c0 + j);
        st += t;
        stx += t * ((xf[j] - mean) * rstd);
      }
    }
    for (int c = head + nvec * kN + threadIdx.x; c < cols; c += blockDim.x) {
      const float t = to_f32(dr[c]) * __ldg(gamma + c);
      st += t;
      stx += t * ((to_f32(xr[c]) - mean) * rstd);
    }
    const float mt = block_sum(st, red[2]) * inv_c;
    const float mtx = block_sum(stx, red[3]) * inv_c;
    T* outr = dx + row * cols;
    for (int c = threadIdx.x; c < cols; c += blockDim.x) {
      const float d = to_f32(dr[c]);
      const float xhat = (to_f32(xr[c]) - mean) * rstd;
      outr[c] = from_f32<T>(rstd * (d * __ldg(gamma + c) - mt - xhat * mtx));
      pgr[c] = fmaf(d, xhat, pgr[c]);
      pbr[c] += d;
    }
  }
}

// dgamma[c] and dbeta[c]: column c and cols + c of the partial rows summed,
// slice s of a column adding rows s, s + kFinishSlices, ... in turn, then
// the slices in turn
__global__ void __launch_bounds__(32 * kFinishSlices)
layernorm_bwd_finish_kernel(const float* __restrict__ part, int parts, int cols,
                            float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float acc[kFinishSlices][33];
  const int width = 2 * cols;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < width) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += kFinishSlices)
      s += __ldg(part + (int64_t)p * width + c);
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < width) {
    float t = 0.f;
    for (int i = 0; i < kFinishSlices; ++i) t += acc[i][threadIdx.x];
    if (c < cols)
      dgamma[c] = t;
    else
      dbeta[c - cols] = t;
  }
}

template <typename T, int NV>
void launch_warp(const T* x, const float* g, const T* dy, T* dx, float* part,
                 int64_t rows, int cols, int parts, float eps, cudaStream_t s) {
  layernorm_bwd_warp_kernel<T, NV><<<parts, 32 * kBwdWarps, 0, s>>>(
      x, g, dy, dx, part, rows, cols, eps);
}

template <typename T>
void launch(const void* xv, const void* gv, const void* dyv, void* dxv, float* part,
            int64_t rows, int cols, int parts, float eps, cudaStream_t s) {
  constexpr int kN = kVecN<T>;
  const T* x = static_cast<const T*>(xv);
  const float* g = static_cast<const float*>(gv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const bool vec = cols % kN == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(dy) && aligned16(dx) && aligned16(part);
  const int nvec = cols / kN;
  if (vec && nvec <= 32 * kMaxWarpVecs) {
    switch ((nvec + 31) / 32) {
      case 1: launch_warp<T, 1>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 2: launch_warp<T, 2>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 3: launch_warp<T, 3>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 4: launch_warp<T, 4>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 5: launch_warp<T, 5>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 6: launch_warp<T, 6>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      case 7: launch_warp<T, 7>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
      default: launch_warp<T, 8>(x, g, dy, dx, part, rows, cols, parts, eps, s); break;
    }
  } else {
    layernorm_bwd_loop_kernel<T><<<parts, loop_threads<T>(cols), 0, s>>>(x, g, dy, dx, part, rows,
                                                           cols, eps);
  }
}

}  // namespace

// The partial rows (of 2C floats each) a call on `rows` rows writes, on a
// card with `sms` SMs: one a CTA of the grid.
extern "C" int64_t mxt_layernorm_bwd_parts(int64_t rows, int sms) {
  if (rows <= 0) return 0;
  const int64_t groups = (rows + kBwdWarps - 1) / kBwdWarps;
  return groups < (int64_t)kWaves * sms ? groups : (int64_t)kWaves * sms;
}

// dtype: 0 float32, 1 bfloat16 (x, dy and dx). gamma, dgamma and dbeta are
// float32; part holds parts x 2C floats (mxt_layernorm_bwd_parts). Returns
// the cudaError_t of the launches (0 on success).
extern "C" int mxt_layernorm_bwd(const void* x, const void* gamma, const void* dy,
                                 void* dx, float* part, float* dgamma,
                                 float* dbeta, int64_t rows, int cols, int parts,
                                 float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 0 || parts < 0 || (rows > 0 && parts < 1))
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    switch (dtype) {
      case 0: launch<float>(x, gamma, dy, dx, part, rows, cols, parts, eps, s); break;
      case 1:
        launch<__nv_bfloat16>(x, gamma, dy, dx, part, rows, cols, parts, eps, s);
        break;
      default: return (int)cudaErrorInvalidValue;
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const dim3 block(32, kFinishSlices);
  layernorm_bwd_finish_kernel<<<(2 * cols + 31) / 32, block, 0, s>>>(
      part, rows > 0 ? parts : 0, cols, dgamma, dbeta);
  return (int)cudaGetLastError();
}
