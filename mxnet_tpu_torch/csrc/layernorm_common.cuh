// Pieces shared by the row LayerNorm forward (layernorm.cu) and backward
// (layernorm_bwd.cu) for Hopper (sm_90a): 16-byte vectors of a row, the
// row layouts the host picks from, and the row sums in one order.
//
// The layouts, for x of (R, C):
// * warp form: one warp a row. Lane l holds the row's 16-byte vectors l,
//   l + 32, ..., NV of them (NV <= kMaxWarpVecs, a template constant, so
//   C up to 2048 bf16 / 1024 fp32): at C = 768 bf16, 3 vectors a lane.
//   The forward takes it at kFewRows rows or more, the backward at every
//   row count.
// * CTA form, the forward below kFewRows rows (layernorm.cu): the threads
//   of a CTA share a row, thread t holding vector t, so the whole row
//   arrives in one round of loads: at C = 768 bf16, 96 threads.
// * loop form: any other row (C above the register forms, C not a
//   multiple of the vector width, or x and y not sharing their 16-byte
//   alignment): a CTA a row, vector loads over the aligned body and
//   element loads over the unaligned head and the tail, several passes
//   over the row (the later ones from L1).
//
// In both register forms a row sum is taken in one order: each vector's
// elements in turn, then lane l adds the sums of vectors l, l + 32, ... in
// turn, then the 32 lanes meet in a butterfly. So where C fits the warp
// form (2048 bf16 / 1024 fp32, a multiple of the vector width), a row's
// statistics and output do not depend on how many rows come with it.
// Above that the forward takes the CTA form at few rows and the loop form
// at many, and the loop form sums in another order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt_ln {

constexpr int kMaxWarpVecs = 8;
constexpr int kLoopThreads = 256;

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVecN = 16 / (int)sizeof(T);

// loop form: threads a CTA, a warp for every 32 vectors of the row, at
// most kLoopThreads
template <typename T>
__host__ __device__ inline int loop_threads(int cols) {
  const int t = ((cols + kVecN<T> - 1) / kVecN<T> + 31) / 32 * 32;
  return t < kLoopThreads ? t : kLoopThreads;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// the vector's values as fp32 (a bf16 is the top half of its fp32)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[kVecN<T>]) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// fp32 values rounded to T, as one 16-byte vector
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[kVecN<T>]) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// n consecutive fp32 values from a 16-byte aligned address, as float4 loads
template <int N>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    f[4 * i] = v.x;
    f[4 * i + 1] = v.y;
    f[4 * i + 2] = v.z;
    f[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum of a vector's values, in turn
template <typename T>
__device__ __forceinline__ float vec_sum(const uint4& u) {
  float f[kVecN<T>];
  unpack<T>(u, f);
  float s = f[0];
#pragma unroll
  for (int j = 1; j < kVecN<T>; ++j) s += f[j];
  return s;
}

// sum of a vector's squared centred values, in turn
template <typename T>
__device__ __forceinline__ float vec_sq(const uint4& u, float mean) {
  float f[kVecN<T>];
  unpack<T>(u, f);
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < kVecN<T>; ++j) {
    const float d = f[j] - mean;
    q = fmaf(d, d, q);
  }
  return q;
}

// warp form: the row's fp32 mean, then rsqrt of the mean squared centred
// value + eps (the TPU kernel's order), from the lane's NV vectors
template <typename T, int NV>
__device__ __forceinline__ void warp_row_stats(const uint4 (&v)[NV], int lane,
                                               int nvec, float inv_c, float eps,
                                               float& mean, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) s += vec_sum<T>(v[i]);
  mean = warp_sum(s) * inv_c;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (lane + 32 * i < nvec) q += vec_sq<T>(v[i], mean);
  rstd = rsqrtf(warp_sum(q) * inv_c + eps);
}

// loop form: a CTA's sum of one value a thread; `red` holds 32 floats and
// is not written again before the next barrier
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int warps = (blockDim.x + 31) >> 5;
  for (int w = 0; w < warps; ++w) s += red[w];
  return s;
}

// loop form: a row of n elements split into an unaligned head of `head`
// elements, `nvec` 16-byte vectors and a tail. Vectors only where `a` and
// `b` (another row walked beside it) share their alignment.
template <typename T>
__device__ __forceinline__ void split_row(const T* a, const void* b, int n,
                                          int& head, int& nvec) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  if ((pa ^ reinterpret_cast<uintptr_t>(b)) & 15u) {
    head = n;
    nvec = 0;
    return;
  }
  head = min(n, (int)(((16u - (pa & 15u)) & 15u) / sizeof(T)));
  nvec = (n - head) / kVecN<T>;
}

// loop form: sum over the row of f(element value, column), element loads
// over the head and the tail and g(vector, first column) over the body
template <typename T, typename F, typename G>
__device__ __forceinline__ float row_pass(const T* __restrict__ r, int n,
                                          int head, int nvec, F f, G g) {
  constexpr int kN = kVecN<T>;
  float s = 0.f;
  for (int c = threadIdx.x; c < head; c += blockDim.x) s += f(to_f32(r[c]), c);
  const uint4* body = reinterpret_cast<const uint4*>(r + head);
  for (int k = threadIdx.x; k < nvec; k += blockDim.x)
    s += g(__ldg(body + k), head + k * kN);
  for (int c = head + nvec * kN + threadIdx.x; c < n; c += blockDim.x)
    s += f(to_f32(r[c]), c);
  return s;
}

}  // namespace mxt_ln
