// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/layernorm.py `fused_layernorm`
// (body `_ln_kernel`): per row, fp32 mean, then the fp32 mean of the squared
// centred values, rsqrt(var + eps), the fp32 gamma/beta affine, one cast to
// x's dtype (fp32 or bf16).
//
// What bounds it on the H100: bytes at many rows, latency at few. It reads x
// once and writes y once, 2*R*C*sizeof(x) bytes (the bert512 step's
// 8192 x 768 bf16: 25.2 MB, 0.0075 ms at 3.35 TB/s), at about 8 operations
// an element, far below the card's 295 operations a byte. A GPT decode
// step's 8 x 768 rows move 24 KB: there the time is the launch and one
// round trip to memory.
//
// What the design does about it (layouts in layernorm_common.cuh):
// * the row is read once, with 16-byte loads (8 bf16 or 4 fp32 a lane,
//   neighbouring lanes on neighbouring addresses), into registers; both
//   statistics and the output come from the registers. gamma and beta come
//   as 16-byte fp32 vectors, y goes out as 16-byte stores.
// * many rows: one warp a row, 2 rows a CTA, NV vectors a lane; the
//   statistics are two warp butterflies.
// * few rows (a decode step's 8): the CTA's threads share the row, one
//   vector each, so every load of the row is in flight at once; each sum is
//   a butterfly after one shared-memory step.
// * any other C (above 2048 bf16 / 1024 fp32 at many rows, 8192 / 4096 at
//   few; not a multiple of the vector width; x not 16-byte aligned): the
//   loop form, three passes over the row, the second and third from L1.

#include "layernorm_common.cuh"

namespace {

using namespace mxt_ln;

constexpr int kFewRows = 1024;       // the CTA form below this many rows
constexpr int kMaxCtaThreads = 1024;  // CTA form: vectors a row at most
constexpr int kFwdWarps = 2;         // warp form: rows (one a warp) a CTA

// CTA form: the row sum of one value a thread (thread t: vector t), in the
// warp form's order. Every warp forms the same sum from `buf`, so one
// barrier does. `buf` holds a float a thread and is not written again
// before the next barrier.
__device__ __forceinline__ float cta_row_sum(float v, float* buf, int nvec) {
  buf[threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = threadIdx.x & 31; k < nvec; k += 32) s += buf[k];
  return warp_sum(s);
}

// CTA form: the same statistics from one vector a thread
template <typename T>
__device__ __forceinline__ void cta_row_stats(const uint4& v, bool valid,
                                              int nvec, float inv_c, float eps,
                                              float* buf0, float* buf1,
                                              float& mean, float& rstd) {
  mean = cta_row_sum(valid ? vec_sum<T>(v) : 0.f, buf0, nvec) * inv_c;
  rstd = rsqrtf(cta_row_sum(valid ? vec_sq<T>(v, mean) : 0.f, buf1, nvec) *
                    inv_c + eps);
}

// y = (x - mean) * rstd * gamma + beta for one 16-byte vector at column col
template <typename T>
__device__ __forceinline__ uint4 normalize(const uint4& u, float mean, float rstd,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta,
                                           int col) {
  constexpr int kN = kVecN<T>;
  float f[kN], g[kN], b[kN];
  unpack<T>(u, f);
  load_f32<kN>(gamma + col, g);
  load_f32<kN>(beta + col, b);
#pragma unroll
  for (int j = 0; j < kN; ++j) f[j] = fmaf((f[j] - mean) * rstd, g[j], b[j]);
  return pack<T>(f);
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * kFwdWarps)
layernorm_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y,
                          int64_t rows, int cols, float eps) {
  constexpr int kN = kVecN<T>;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together: shuffles stay full
  const int nvec = cols / kN;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * cols);
  uint4* yr = reinterpret_cast<uint4*>(y + row * cols);
  uint4 v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = lane + 32 * i < nvec ? __ldg(xr + lane + 32 * i) : make_uint4(0, 0, 0, 0);
  float mean, rstd;
  warp_row_stats<T, NV>(v, lane, nvec, 1.f / (float)cols, eps, mean, rstd);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int k = lane + 32 * i;
    if (k < nvec) yr[k] = normalize<T>(v[i], mean, rstd, gamma, beta, k * kN);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxCtaThreads)
layernorm_fwd_cta_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         int cols, float eps) {
  __shared__ float buf[2][kMaxCtaThreads];
  constexpr int kN = kVecN<T>;
  const int64_t row = blockIdx.x;
  const int nvec = cols / kN;
  const int k = threadIdx.x;
  const bool valid = k < nvec;
  const uint4 v = valid ? __ldg(reinterpret_cast<const uint4*>(x + row * cols) + k)
                        : make_uint4(0, 0, 0, 0);
  float mean, rstd;
  cta_row_stats<T>(v, valid, nvec, 1.f / (float)cols, eps, buf[0], buf[1], mean,
                   rstd);
  if (valid)
    reinterpret_cast<uint4*>(y + row * cols)[k] =
        normalize<T>(v, mean, rstd, gamma, beta, k * kN);
}

template <typename T>
__global__ void __launch_bounds__(kLoopThreads)
layernorm_fwd_loop_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y,
                          int cols, float eps) {
  __shared__ float red[2][32];
  constexpr int kN = kVecN<T>;
  const T* xr = x + (int64_t)blockIdx.x * cols;
  T* yr = y + (int64_t)blockIdx.x * cols;
  const float inv_c = 1.f / (float)cols;
  int head, nvec;
  split_row<T>(xr, yr, cols, head, nvec);
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
  auto out = [&](float v, int c) {
    return from_f32<T>(fmaf((v - mean) * rstd, __ldg(gamma + c), __ldg(beta + c)));
  };
  for (int c = threadIdx.x; c < head; c += blockDim.x) yr[c] = out(to_f32(xr[c]), c);
  const uint4* xb = reinterpret_cast<const uint4*>(xr + head);
  uint4* yb = reinterpret_cast<uint4*>(yr + head);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x) {
    float f[kN];
    unpack<T>(__ldg(xb + k), f);
    const int c0 = head + k * kN;
#pragma unroll
    for (int j = 0; j < kN; ++j)
      f[j] = fmaf((f[j] - mean) * rstd, __ldg(gamma + c0 + j), __ldg(beta + c0 + j));
    yb[k] = pack<T>(f);
  }
  for (int c = head + nvec * kN + threadIdx.x; c < cols; c += blockDim.x)
    yr[c] = out(to_f32(xr[c]), c);
}

template <typename T, int NV>
void launch_warp(const T* x, const float* g, const float* b, T* y, int64_t rows,
                 int cols, float eps, cudaStream_t s) {
  const int64_t blocks = (rows + kFwdWarps - 1) / kFwdWarps;
  layernorm_fwd_warp_kernel<T, NV><<<(unsigned)blocks, 32 * kFwdWarps, 0, s>>>(
      x, g, b, y, rows, cols, eps);
}

template <typename T>
int launch(const void* xv, const void* gv, const void* bv, void* yv, int64_t rows,
           int cols, float eps, cudaStream_t s) {
  constexpr int kN = kVecN<T>;
  const T* x = static_cast<const T*>(xv);
  const float* g = static_cast<const float*>(gv);
  const float* b = static_cast<const float*>(bv);
  T* y = static_cast<T*>(yv);
  const bool vec = cols % kN == 0 && aligned16(x) && aligned16(g) &&
                   aligned16(b) && aligned16(y);
  const int nvec = cols / kN;
  if (vec && rows >= kFewRows && nvec <= 32 * kMaxWarpVecs) {
    switch ((nvec + 31) / 32) {
      case 1: launch_warp<T, 1>(x, g, b, y, rows, cols, eps, s); break;
      case 2: launch_warp<T, 2>(x, g, b, y, rows, cols, eps, s); break;
      case 3: launch_warp<T, 3>(x, g, b, y, rows, cols, eps, s); break;
      case 4: launch_warp<T, 4>(x, g, b, y, rows, cols, eps, s); break;
      case 5: launch_warp<T, 5>(x, g, b, y, rows, cols, eps, s); break;
      case 6: launch_warp<T, 6>(x, g, b, y, rows, cols, eps, s); break;
      case 7: launch_warp<T, 7>(x, g, b, y, rows, cols, eps, s); break;
      default: launch_warp<T, 8>(x, g, b, y, rows, cols, eps, s); break;
    }
  } else if (vec && rows < kFewRows && nvec <= kMaxCtaThreads) {
    layernorm_fwd_cta_kernel<T><<<(unsigned)rows, (nvec + 31) / 32 * 32, 0, s>>>(
        x, g, b, y, cols, eps);
  } else {
    layernorm_fwd_loop_kernel<T><<<(unsigned)rows, loop_threads<T>(cols), 0, s>>>(x, g, b, y, cols,
                                                                    eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the cudaError_t of the
// launch (0 on success). gamma and beta are float32.
extern "C" int mxt_layernorm_fwd(const void* x, const void* gamma,
                                 const void* beta, void* y, int64_t rows,
                                 int cols, float eps, int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, gamma, beta, y, rows, cols, eps, s);
    case 1: return launch<__nv_bfloat16>(x, gamma, beta, y, rows, cols, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
