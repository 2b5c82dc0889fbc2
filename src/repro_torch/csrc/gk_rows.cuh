// Loops of the GEMV-shaped kernels of gk_step.cu (sketch_matvec.cu,
// sparse_matvec.cu and lowrank_update.cu use only the element loads ld()
// and the block shape; proj_tiles.cuh ld() and warp_sum).
//
//  * row_dot: one warp computes the dot product of a row of A with a
//    vector, lanes on adjacent addresses, 16-byte vector loads where the
//    row is aligned (V elements of A per lane per step).
//
// Elements of A may be float, bfloat16 or double; each is converted to
// float before it is multiplied (the reference kernels cast every A tile
// to f32), and every sum accumulates in f32.  Offsets are 64-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const double* p) {
  return __double2float_rn(*p);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// acc += a[0:V] . x[0:V], V elements per lane per step.
template <typename T, int V>
struct Step {
  static __device__ __forceinline__ float apply(const T* a, const float* x,
                                              float acc) {
#pragma unroll
    for (int t = 0; t < V; ++t) acc = fmaf(ld(a + t), x[t], acc);
    return acc;
  }
};

template <>
struct Step<float, 4> {
  static __device__ __forceinline__ float apply(const float* a, const float* x,
                                              float acc) {
    const float4 av = *reinterpret_cast<const float4*>(a);
    const float4 xv = *reinterpret_cast<const float4*>(x);
    acc = fmaf(av.x, xv.x, acc);
    acc = fmaf(av.y, xv.y, acc);
    acc = fmaf(av.z, xv.z, acc);
    acc = fmaf(av.w, xv.w, acc);
    return acc;
  }
};

template <>
struct Step<__nv_bfloat16, 8> {
  static __device__ __forceinline__ float apply(const __nv_bfloat16* a,
                                              const float* x, float acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(a);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float4 x0 = *reinterpret_cast<const float4*>(x);
    const float4 x1 = *reinterpret_cast<const float4*>(x + 4);
    float2 f = __bfloat1622float2(h[0]);
    acc = fmaf(f.x, x0.x, acc);
    acc = fmaf(f.y, x0.y, acc);
    f = __bfloat1622float2(h[1]);
    acc = fmaf(f.x, x0.z, acc);
    acc = fmaf(f.y, x0.w, acc);
    f = __bfloat1622float2(h[2]);
    acc = fmaf(f.x, x1.x, acc);
    acc = fmaf(f.y, x1.y, acc);
    f = __bfloat1622float2(h[3]);
    acc = fmaf(f.x, x1.z, acc);
    acc = fmaf(f.y, x1.w, acc);
    return acc;
  }
};

template <>
struct Step<double, 2> {
  static __device__ __forceinline__ float apply(const double* a,
                                              const float* x, float acc) {
    const double2 av = *reinterpret_cast<const double2*>(a);
    const float2 xv = *reinterpret_cast<const float2*>(x);
    acc = fmaf(__double2float_rn(av.x), xv.x, acc);
    acc = fmaf(__double2float_rn(av.y), xv.y, acc);
    return acc;
  }
};

// Warp-cooperative dot product of a row a[0:n] with x[0:n]; every lane
// returns the same value.  V > 1 needs n % V == 0 and 16-byte aligned rows.
template <typename T, int V>
__device__ __forceinline__ float row_dot(const T* __restrict__ a,
                                         const float* __restrict__ x,
                                         long long n, int lane) {
  constexpr long long S = 32LL * V;  // one warp-wide step
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  long long j = (long long)lane * V;
  for (; j + 3 * S + V <= n; j += 4 * S) {
    acc0 = Step<T, V>::apply(a + j, x + j, acc0);
    acc1 = Step<T, V>::apply(a + j + S, x + j + S, acc1);
    acc2 = Step<T, V>::apply(a + j + 2 * S, x + j + 2 * S, acc2);
    acc3 = Step<T, V>::apply(a + j + 3 * S, x + j + 3 * S, acc3);
  }
  for (; j + V <= n; j += S) acc0 = Step<T, V>::apply(a + j, x + j, acc0);
  return warp_sum((acc0 + acc1) + (acc2 + acc3));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
