// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/layernorm.py `fused_layernorm`
// (body `_ln_kernel`): per row, fp32 mean, fp32 variance of the centred
// values, rsqrt(var + eps), the gamma/beta affine, output in x's dtype.
//
// What bounds it on the H100: bytes. It reads x once and writes y once,
// 2*R*C*sizeof(x) bytes (BERT-base serving, 4096 x 768 bf16: 12.6 MB), and
// does about 8 operations per element, far below the card's 295 operations
// per byte. What the design does about it: one warp per row, lanes striding
// along the row, so every warp-wide load and store is contiguous; the two
// statistics are warp-shuffle sums (mean first, then the centred sum of
// squares, the TPU kernel's order); the second and third reads of the row
// come from L1, so device memory sees the row once. The tail of a row is
// just the end of the loop, so any C works (the TPU's C % 128 rule is gone).
// Loads are 2 or 4 bytes a lane; 16-byte vectors are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row, 128 threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
layernorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     int64_t rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together: shuffles stay full
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  const float inv_c = 1.0f / (float)cols;

  float s = 0.f;
  for (int c = lane; c < cols; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) * inv_c;

  float ss = 0.f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) * inv_c + eps);

  for (int c = lane; c < cols; c += 32) {
    const float d = (to_f32(xr[c]) - mean) * rstd;
    yr[c] = from_f32<T>(d * gamma[c] + beta[c]);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y,
           int64_t rows, int cols, float eps, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_fwd_kernel<T><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), rows, cols, eps);
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
