// Softmax cross-entropy forward and backward for Hopper (sm_90a): per-row
// NLL of int labels under softmax(logits), and its gradient.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/softmax_xent.py:
// `_run_fwd` (body `_fwd_kernel`: loss = lse - x[label] and the fp32 lse, one
// pass over the row) and `_run_bwd` (body `_bwd_kernel`:
// dx = (exp(x - lse) - onehot) * dy in the logits' dtype, reusing the saved
// lse). fp32 arithmetic whatever the logits' dtype, as there. A label
// outside [0, V) picks nothing, as the TPU kernel's iota compare does.
//
// What bounds it on the H100: bytes. At the BERT-base MLM head (1280 rows
// of 30522 bf16 logits) the forward reads 78.1 MB and the backward reads
// and writes 156.3 MB, a few operations per byte against the card's 295.
// What the design does about it:
//
// * one 256-thread block per row, streaming the row once with 16-byte
//   loads (8 bf16 or 4 fp32 a thread), neighbouring threads on
//   neighbouring addresses. A row of V = 30522 bf16 starts 16-byte aligned
//   only every eighth row, so each row takes its unaligned head and tail
//   element by element and the rest as vectors: any V works (2, 1000,
//   30522, 50257), with no padding to a lane multiple (the TPU kernel's
//   `_pad_lanes` -1e30 padding is a TPU layout rule). Each row is found by
//   its own stride (`ldx`, `ldd` elements), so a view of wider rows, such
//   as a padded vocabulary sliced to V, is read where it lies;
// * the forward keeps an online (max, sum of exp) pair: each 16-byte vector
//   is reduced against its own max, then merged, so the row is read from
//   device memory once; the pairs meet by warp shuffles and one shared
//   exchange. One thread reads the label's logit;
// * the backward is one elementwise pass with the row's lse, label and dy
//   in registers, stored with 16-byte writes.
// The rows of a 2-wide NSP head leave most of a block idle; they cost
// microseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte load or store
template <typename T>
constexpr int kVecN = 16 / (int)sizeof(T);

// merge the pair (m2, s2) into (m, s): s sums exp(x - m) over its elements
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty (or all -inf)
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

// Split a row into an unaligned head, 16-byte vectors, and a tail. The
// vector part is used only if x and (when given) y share their alignment.
template <typename T>
__device__ __forceinline__ void split_row(const T* x, const T* y, int V,
                                          int& head, int& nvec) {
  constexpr int kN = kVecN<T>;
  const uintptr_t ax = reinterpret_cast<uintptr_t>(x);
  if (y != nullptr && ((ax ^ reinterpret_cast<uintptr_t>(y)) & 15u)) {
    head = V;
    nvec = 0;
    return;
  }
  head = min(V, (int)(((16u - (ax & 15u)) & 15u) / sizeof(T)));
  nvec = (V - head) / kN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse, int V,
                int64_t ldx) {
  constexpr int kN = kVecN<T>;
  __shared__ float ms[kThreads / 32];
  __shared__ float ss[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  int head, nvec;
  split_row<T>(xr, nullptr, V, head, nvec);

  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < head; i += kThreads) merge(m, s, to_f32(xr[i]), 1.f);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  for (int j = threadIdx.x; j < nvec; j += kThreads) {
    const uint4 in = xv[j];
    const T* e = reinterpret_cast<const T*>(&in);
    float f[kN];
    float vm = -INFINITY;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      f[i] = to_f32(e[i]);
      vm = fmaxf(vm, f[i]);
    }
    if (vm == -INFINITY) continue;
    float vs = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) vs += expf(f[i] - vm);
    merge(m, s, vm, vs);
  }
  for (int i = head + nvec * kN + threadIdx.x; i < V; i += kThreads)
    merge(m, s, to_f32(xr[i]), 1.f);

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, s, m2, s2);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ms[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = ms[0];
    s = ss[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(m, s, ms[w], ss[w]);
    const float l = logf(s) + m;
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < V) ? to_f32(xr[lab]) : 0.f;
    loss[row] = l - picked;
    lse[row] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ dy,
                T* __restrict__ dx, int V, int64_t ldx, int64_t ldd) {
  constexpr int kN = kVecN<T>;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * ldx;
  T* dr = dx + row * ldd;
  int head, nvec;
  split_row<T>(xr, dr, V, head, nvec);
  const float l = lse[row];
  const float g = dy[row];
  const int lab = labels[row];

  for (int i = threadIdx.x; i < head; i += kThreads)
    dr[i] = from_f32<T>((expf(to_f32(xr[i]) - l) - (i == lab ? 1.f : 0.f)) * g);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* dv = reinterpret_cast<uint4*>(dr + head);
  for (int j = threadIdx.x; j < nvec; j += kThreads) {
    const uint4 in = xv[j];
    const T* e = reinterpret_cast<const T*>(&in);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
    const int c0 = head + j * kN;
#pragma unroll
    for (int i = 0; i < kN; ++i)
      oe[i] = from_f32<T>((expf(to_f32(e[i]) - l) - (c0 + i == lab ? 1.f : 0.f)) * g);
    dv[j] = out;
  }
  for (int i = head + nvec * kN + threadIdx.x; i < V; i += kThreads)
    dr[i] = from_f32<T>((expf(to_f32(xr[i]) - l) - (i == lab ? 1.f : 0.f)) * g);
}

template <typename T>
int launch_fwd(const void* x, const int32_t* labels, float* loss, float* lse,
               int64_t rows, int V, int64_t ldx, cudaStream_t stream) {
  xent_fwd_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), labels, loss, lse, V, ldx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const int32_t* labels, const float* lse,
               const float* dy, void* dx, int64_t rows, int V, int64_t ldx,
               int64_t ldd, cudaStream_t stream) {
  xent_bwd_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), labels, lse, dy, static_cast<T*>(dx), V, ldx,
      ldd);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (rows, V) with unit column stride and row stride ldx >= V, dtype 0
// float32 or 1 bfloat16; labels: (rows,) int32; loss, lse, dy: (rows,)
// float32; dx: (rows, V) in x's dtype, row stride ldd. Each returns the
// cudaError_t of its launch.
extern "C" int mxt_xent_fwd(const void* x, const int32_t* labels, float* loss,
                            float* lse, int64_t rows, int V, int64_t ldx,
                            int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(x, labels, loss, lse, rows, V, ldx, s);
    case 1:
      return launch_fwd<__nv_bfloat16>(x, labels, loss, lse, rows, V, ldx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxt_xent_bwd(const void* x, const int32_t* labels,
                            const float* lse, const float* dy, void* dx,
                            int64_t rows, int V, int64_t ldx, int64_t ldd,
                            int dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(x, labels, lse, dy, dx, rows, V, ldx, ldd, s);
    case 1:
      return launch_bwd<__nv_bfloat16>(x, labels, lse, dy, dx, rows, V, ldx,
                                       ldd, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
