// Loops of the GEMV-shaped kernels of gk_step.cu (sketch_matvec.cu,
// sparse_matvec.cu and lowrank_update.cu use only the element loads ld()
// and the block shape).
//
//  * row_dot: one warp computes the dot product of a row of A with a
//    vector, lanes on adjacent addresses, 16-byte vector loads where the
//    row is aligned (V elements of A per lane per step).
//  * rmv_partial_kernel: A^T q from row-major A.  Threads own adjacent
//    columns, so each warp's load of a row segment is coalesced; the rows
//    are cut into chunks and each (column tile, row chunk) block writes a
//    partial column sum, which a finishing launch sums in a fixed order.
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
constexpr int kRmvUnroll = 8;

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

// vpart[s, j] = sum over rows i of chunk s of A[i, j] q_i.  Threads own
// adjacent columns (coalesced row segments); blockIdx.y is the row chunk.
template <typename TA>
__global__ void __launch_bounds__(kThreads)
    rmv_partial_kernel(const TA* __restrict__ A, const float* __restrict__ q,
                       long long m, long long n, long long rows_per_chunk,
                       float* __restrict__ vpart) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long i0 = (long long)blockIdx.y * rows_per_chunk;
  const long long i1 = min(i0 + rows_per_chunk, m);
  const TA* a = A + i0 * n + j;
  float acc[kRmvUnroll];
#pragma unroll
  for (int t = 0; t < kRmvUnroll; ++t) acc[t] = 0.f;
  long long i = i0;
  for (; i + kRmvUnroll <= i1; i += kRmvUnroll) {
#pragma unroll
    for (int t = 0; t < kRmvUnroll; ++t)
      acc[t] = fmaf(ld(a + t * n), q[i + t], acc[t]);
    a += kRmvUnroll * n;
  }
  for (; i < i1; ++i) {
    acc[0] = fmaf(ld(a), q[i], acc[0]);
    a += n;
  }
  vpart[(long long)blockIdx.y * n + j] =
      ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
      ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

template <typename TA>
cudaError_t launch_rmv_partial(const TA* A, const float* q, long long m,
                               long long n, long long rows_per_chunk,
                               int chunks, float* vpart,
                               cudaStream_t stream) {
  const dim3 tiles((unsigned)((n + kThreads - 1) / kThreads),
                   (unsigned)chunks);
  rmv_partial_kernel<TA><<<tiles, kThreads, 0, stream>>>(A, q, m, n,
                                                          rows_per_chunk,
                                                          vpart);
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
