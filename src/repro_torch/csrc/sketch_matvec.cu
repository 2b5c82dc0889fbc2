// Sparse-sign sketch apply for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/sketch_matvec.py:
//
//   sketch_matmat <- sketch_matmat (sketch_matvec.py:65)
//       Y[i, c] = sum_s signs[i, s] * X[idx[i, s], c]      (Y = T^T X)
//
// signs/idx are the (d, zeta) ELL pack of the test matrix T (N, d): sketch
// row i lists its zeta source rows of X and their signed weights.  X is
// (N, b) and arrives in two layouts, neither of which may be copied:
//  * row-major (X = A, or the panel Y of gnystrom's core): element (r, c)
//    at r*sx0 + c with sx1 == 1;
//  * a transposed view of the row-major operand (X = A^T in the range
//    sketch A Omega = (Omega^T A^T)^T): element (r, c) at r + c*sx1.
// The kernel takes both strides, so one loop serves both.
//
// Design.  One thread owns one output element Y[i, c] and sums its zeta
// slots in slot order: no atomics, no cross-thread sum, the same bits on
// every run.  Threads of a block run along c, so for a row-major X every
// slot's load is a coalesced row segment and the store of Y is coalesced;
// the zeta (sign, index) pairs of row i are the same for the whole block
// (broadcast loads).  For the transposed view the threads run along A's
// rows and each reads A[c, idx[i, s]]: a stride of n between threads, so
// every element costs its own 32-byte sector (d * zeta * m sectors for
// the range sketch).  The reference pads sketch rows with zero-sign slots
// and b to 128 lanes; here d and zeta are exact and the columns past b are
// masked.  Every index must lie in [0, N): make_sketch draws them so, and
// bridge.sketch checks a reference draw once on the host.
//
// What bounds it.  Two flops per gathered element: bound by the bytes
// gathered from X (d * zeta * b elements, fewer where slots repeat a row)
// and written to Y (d * b floats).  X is f32, bf16 or f64, signs f32, bf16
// or f64; each is converted to f32 and every sum accumulates in f32.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int.  kinds: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads

namespace {

constexpr unsigned kMaxGridY = 65535;

template <typename TS, typename TX>
__global__ void __launch_bounds__(kThreads)
    sketch_kernel(const TS* __restrict__ signs, const int* __restrict__ idx,
                  int zeta, long long d, const TX* __restrict__ X,
                  long long N, long long b, long long sx0, long long sx1,
                  float* __restrict__ Y) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= b) return;
  const TX* xc = X + c * sx1;
  for (long long i = blockIdx.y; i < d; i += gridDim.y) {
    const TS* s_row = signs + i * zeta;
    const int* i_row = idx + i * zeta;
    float acc = 0.f;
    for (int s = 0; s < zeta; ++s) {
      const long long r = i_row[s];
      acc = fmaf(ld(s_row + s), ld(xc + r * sx0), acc);
    }
    Y[i * b + c] = acc;
  }
}

template <typename TS, typename TX>
cudaError_t launch(const void* signs, const int* idx, int zeta, long long d,
                   const void* X, long long N, long long b, long long sx0,
                   long long sx1, float* Y, cudaStream_t stream) {
  const dim3 grid((unsigned)((b + kThreads - 1) / kThreads),
                  (unsigned)(d < kMaxGridY ? d : kMaxGridY));
  sketch_kernel<TS, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TS*>(signs), idx, zeta, d,
      static_cast<const TX*>(X), N, b, sx0, sx1, Y);
  return cudaGetLastError();
}

template <typename TS>
cudaError_t by_x(int x_kind, const void* signs, const int* idx, int zeta,
                 long long d, const void* X, long long N, long long b,
                 long long sx0, long long sx1, float* Y,
                 cudaStream_t stream) {
  if (x_kind == 1)
    return launch<TS, __nv_bfloat16>(signs, idx, zeta, d, X, N, b, sx0, sx1,
                                     Y, stream);
  if (x_kind == 2)
    return launch<TS, double>(signs, idx, zeta, d, X, N, b, sx0, sx1, Y,
                              stream);
  return launch<TS, float>(signs, idx, zeta, d, X, N, b, sx0, sx1, Y, stream);
}

}  // namespace

extern "C" {

const char* sketch_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int sketch_matmat(const void* signs, int s_kind, const int* idx, int zeta,
                  long long d, const void* X, int x_kind, long long N,
                  long long b, long long sx0, long long sx1, float* Y,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (s_kind == 1)
    e = by_x<__nv_bfloat16>(x_kind, signs, idx, zeta, d, X, N, b, sx0, sx1,
                            Y, st);
  else if (s_kind == 2)
    e = by_x<double>(x_kind, signs, idx, zeta, d, X, N, b, sx0, sx1, Y, st);
  else
    e = by_x<float>(x_kind, signs, idx, zeta, d, X, N, b, sx0, sx1, Y, st);
  return (int)e;
}

}  // extern "C"
