// Low-rank materialization for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/lowrank_update.py:
//
//   lowrank_matmul <- lowrank_matmul (lowrank_update.py:34)
//       W[i, j] = sum_k (U[i, k] * s[k]) * Vt[k, j]      (W = U diag(s) Vt)
//
// U is (m, r) and Vt (r, n), each f32, bf16 or f64 with any strides (the
// rank-k update passes a transposed view for Vt); s is (r,) f32.  W is
// (m, n) f32, row-major.  r is small (the rank of a drift, or of a
// factorization: tens), m * n large (32 GB at 1e5 x 8e4).
//
// Design.  Output-stationary, as the reference: W is written once and
// never read.  A block of 256 threads owns 32 rows of W by 256 columns:
// each thread owns one column j, holds Vt[k, j] for up to 16 values of k
// in registers, and sums its 32 outputs over k in order with fmaf, so
// every element is summed by one thread (no cross-thread sum, the same
// bits on every run).  The block stages the 32 x 32 tile of U*s (each
// product rounded to f32, as the reference forms U*s before its dot) in
// shared memory, where every read is a broadcast; a warp's store of a row
// is 128 contiguous bytes, stored with the evict-first hint so that the
// streamed W does not push U and Vt out of L2.  Larger r runs in chunks
// of 16, and at most 85 registers a thread leave room for three blocks
// on an SM.  Ragged edges
// (m, n, r of any size) are masked: the reference pads U and Vt to its
// tiles, or falls back to a jnp product when a dim does not tile
// (lowrank_update.py:59-73); this kernel runs every shape.  Offsets are
// 64-bit (m * n passes 2^31).
//
// What bounds it.  The write of W: m * n * 4 bytes at 3.35 TB/s (9.55 ms at
// 1e5 x 8e4), against 2 * m * n * r flops of f32 FMA (4.8 ms at r = 20 and
// 67 TFLOP/s).  One shared-memory float4 feeds four FMAs of the thread,
// and the stores of one block overlap the arithmetic of the others.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int.  kinds: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads

namespace {

constexpr int kRows = 32;        // rows of W a block owns
constexpr int kK = 16;           // values of k held in registers at a time
constexpr unsigned kMaxGridY = 65535;

template <typename TU, typename TV>
__global__ void __launch_bounds__(kThreads, 3)
    lowrank_kernel(const TU* __restrict__ U, long long su0, long long su1,
                   const float* __restrict__ s, const TV* __restrict__ Vt,
                   long long sv0, long long sv1, int r, long long m,
                   long long n, float* __restrict__ W) {
  __shared__ __align__(16) float us[kK][kRows];   // (U*s)[i0 + x, k0 + k]
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool col_ok = j < n;
  const long long row_tiles = (m + kRows - 1) / kRows;
  for (long long bi = blockIdx.y; bi < row_tiles; bi += gridDim.y) {
    const long long i0 = bi * kRows;
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
    for (int k0 = 0; k0 < r; k0 += kK) {
      const int kn = min(kK, r - k0);
      __syncthreads();                 // the last chunk's reads are done
      for (int e = threadIdx.x; e < kK * kRows; e += kThreads) {
        const int k = e / kRows, x = e % kRows;
        const long long gi = i0 + x;
        us[k][x] = (k < kn && gi < m)
                       ? ld(U + gi * su0 + (k0 + k) * su1) * s[k0 + k]
                       : 0.f;
      }
      float vt[kK];
#pragma unroll
      for (int k = 0; k < kK; ++k)
        vt[k] = (k < kn && col_ok) ? ld(Vt + (k0 + k) * sv0 + j * sv1) : 0.f;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        if (k >= kn) break;
#pragma unroll
        for (int q = 0; q < kRows; q += 4) {
          const float4 u = *reinterpret_cast<const float4*>(&us[k][q]);
          acc[q] = fmaf(u.x, vt[k], acc[q]);
          acc[q + 1] = fmaf(u.y, vt[k], acc[q + 1]);
          acc[q + 2] = fmaf(u.z, vt[k], acc[q + 2]);
          acc[q + 3] = fmaf(u.w, vt[k], acc[q + 3]);
        }
      }
    }
    if (col_ok) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (i0 + q < m) __stcs(W + (i0 + q) * n + j, acc[q]);
    }
  }
}

template <typename TU, typename TV>
cudaError_t launch(const void* U, long long su0, long long su1,
                   const float* s, const void* Vt, long long sv0,
                   long long sv1, int r, long long m, long long n, float* W,
                   cudaStream_t stream) {
  const long long row_tiles = (m + kRows - 1) / kRows;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads),
                  (unsigned)(row_tiles < kMaxGridY ? row_tiles : kMaxGridY));
  lowrank_kernel<TU, TV><<<grid, kThreads, 0, stream>>>(
      static_cast<const TU*>(U), su0, su1, s, static_cast<const TV*>(Vt), sv0,
      sv1, r, m, n, W);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t by_v(int v_kind, const void* U, long long su0, long long su1,
                 const float* s, const void* Vt, long long sv0, long long sv1,
                 int r, long long m, long long n, float* W,
                 cudaStream_t stream) {
  if (v_kind == 1)
    return launch<TU, __nv_bfloat16>(U, su0, su1, s, Vt, sv0, sv1, r, m, n, W,
                                     stream);
  if (v_kind == 2)
    return launch<TU, double>(U, su0, su1, s, Vt, sv0, sv1, r, m, n, W,
                              stream);
  return launch<TU, float>(U, su0, su1, s, Vt, sv0, sv1, r, m, n, W, stream);
}

}  // namespace

extern "C" {

const char* lowrank_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int lowrank_matmul(const void* U, int u_kind, long long su0, long long su1,
                   const float* s, const void* Vt, int v_kind, long long sv0,
                   long long sv1, int r, long long m, long long n, float* W,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (u_kind == 1)
    e = by_v<__nv_bfloat16>(v_kind, U, su0, su1, s, Vt, sv0, sv1, r, m, n, W,
                            st);
  else if (u_kind == 2)
    e = by_v<double>(v_kind, U, su0, su1, s, Vt, sv0, sv1, r, m, n, W, st);
  else
    e = by_v<float>(v_kind, U, su0, su1, s, Vt, sv0, sv1, r, m, n, W, st);
  return (int)e;
}

}  // extern "C"
