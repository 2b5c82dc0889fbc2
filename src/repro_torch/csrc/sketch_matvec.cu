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
//  * row-major (X = A in the co-range sketch Psi^T A): element (r, c) at
//    r*sx0 + c with sx1 == 1;
//  * a transposed view of a row-major matrix (X = A^T in the range sketch
//    A Omega = (Omega^T A^T)^T, or the panel Y of gnystrom's core): element
//    (r, c) at r + c*sx1, so column c of X is row c of the matrix below.
//
// Every Y[i, c] is the same chain in both kernels: acc = 0, then
// acc = fmaf(signs[i, s], X[idx[i, s], c], acc) for s = 0 .. zeta - 1 in
// slot order.  No atomics, no cross-thread sum: the same bits on every run
// and on either path.  X is f32, bf16 or f64, signs f32, bf16 or f64; each
// is converted to f32.  d and zeta are exact (the reference pads them) and
// ragged edges are masked.  Every index must lie in [0, N): make_sketch
// draws them so, and bridge.sketch checks a reference draw once on the host.
//
// What bounds it.  Two flops per gathered element, so bytes:
//  * Row-major X (rows_kernel): each slot reads a whole row of X, so the
//    rows are streamed.  A block owns a tile of 256 * V columns (V elements
//    in 16 bytes: 4 f32, 8 bf16, 2 f64) and kRowsPerBlock sketch rows; each
//    thread loads its V columns of up to 8 slots' rows in 16-byte loads
//    before it sums them, and stores its V outputs in one or two 16-byte
//    stores.  Where the strides or the alignment forbid 16-byte loads,
//    element loads of the same V columns give the same sums.
//  * A transposed view (range_kernel): the gathered elements X[idx, c] of
//    one c are scattered along one row of the matrix below, one 32-byte
//    sector each; a thread per Y[i, c] running along c (the previous
//    design) sends the 32 loads of a warp to 32 rows 4 * sx1 bytes apart,
//    one sector and one DRAM page each.  Here a block owns R rows c of
//    that matrix (16 for the range sketch; fewer where b is small, so the
//    grid still fills the card) and one chunk of up to kMaxChunkSlots
//    slots of sketch rows: the chunk's slots sorted by source row (the
//    permutation `order`, made once per sketch by
//    kernels/sketch_matvec.py gather_order) are walked by each warp in
//    ascending column order along its rows c, so a warp's loads fall in a
//    few KB of one row and adjacent sources share sectors.  Each gathered
//    value goes to shared memory at its (i, s) place; then a thread per
//    Y[i, c] sums its slots in slot order as above, threads along c, and
//    Y is written in runs of R floats.  The floor is one sector per
//    distinct (c, idx / 8) pair: ~31x the element bytes of the range
//    sketch.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int (cudaErrorInvalidValue for a chunk
// plan outside this file's limits).  kinds: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads

namespace {

constexpr unsigned kMaxGridY = 65535;
constexpr int kRowsPerBlock = 4;      // sketch rows a rows_kernel block owns
constexpr int kSlotBatch = 8;         // slots whose loads a thread issues
                                      // before it sums them
constexpr int kRangeRows = 16;        // most rows of the matrix below X^T
                                      // a range_kernel block owns
constexpr int kRangeUnroll = 8;       // 32-slot pieces a lane has in flight
constexpr int kMaxChunkSlots = 1024;  // slots of a chunk of sketch rows
static_assert(kRangeRows % kWarps == 0, "whole rows a warp");

// --- row-major X: 16-byte loads of V adjacent columns --------------------

template <typename TX>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};
template <>
struct Vec<double> {
  static constexpr int V = 2;
  static __device__ __forceinline__ void load(const double* p,
                                              float (&o)[2]) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = __double2float_rn(t.x);
    o[1] = __double2float_rn(t.y);
  }
};

// Y[i, c .. c + V) for the block's sketch rows; thread t of block (x, y)
// owns columns c = (x * kThreads + t) * V.  With `vec` (sx1 == 1, sx0 % V
// == 0, X 16-byte aligned) a full group of V columns is one 16-byte load
// a slot; otherwise, and for the ragged last group, V element loads.
template <typename TS, typename TX>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const TS* __restrict__ signs, const int* __restrict__ idx,
                int zeta, long long d, const TX* __restrict__ X, long long b,
                long long sx0, long long sx1, bool vec,
                float* __restrict__ Y) {
  constexpr int V = Vec<TX>::V;
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= b) return;
  const int nc = (int)min((long long)V, b - c);
  const bool wide = vec && nc == V;
  const bool store4 = nc == V && V >= 4 && (b & 3) == 0;
  for (long long i0 = (long long)blockIdx.y * kRowsPerBlock; i0 < d;
       i0 += (long long)gridDim.y * kRowsPerBlock) {
    const long long i1 = min(d, i0 + kRowsPerBlock);
    for (long long i = i0; i < i1; ++i) {
      const TS* s_row = signs + i * zeta;
      const int* i_row = idx + i * zeta;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int s0 = 0; s0 < zeta; s0 += kSlotBatch) {
        float xv[kSlotBatch][V];
        float sg[kSlotBatch];
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u) {
          if (s0 + u < zeta) {
            const TX* p = X + (long long)__ldg(i_row + s0 + u) * sx0;
            sg[u] = ld(s_row + s0 + u);
            if (wide) {
              Vec<TX>::load(p + c, xv[u]);
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e)
                xv[u][e] = e < nc ? ld(p + (c + e) * sx1) : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kSlotBatch; ++u)
          if (s0 + u < zeta) {
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] = fmaf(sg[u], xv[u][e], acc[e]);
          }
      }
      float* y = Y + i * b + c;
      if (store4) {
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(y + e) =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (e < nc) y[e] = acc[e];
      }
    }
  }
}

// --- a transposed view: a block per (chunk of sketch rows, R rows of the
// matrix below) ------------------------------------------------------------

// order (2, d * zeta) int32: within each chunk of rows_per_chunk sketch
// rows (slots [q * rows_per_chunk * zeta, ...)), order[0, j] is the source
// row of the chunk's j-th slot in ascending order and order[1, j] its
// slot i * zeta + s.  Shared memory holds g[r][(i - i0) * zeta + s] for the
// block's rows c0 + r (r < R, R a power of two <= kRangeRows), a row of
// `pitch` = chunk slots + 1 floats.  The chunk's sorted slots are cut in
// pieces of 32 (a lane each); each warp walks its rows' pieces in order,
// kRangeUnroll pieces in flight: with R >= kWarps a warp owns R / kWarps
// rows and every piece, with fewer rows kWarps / R warps share a row, each
// a contiguous run of its pieces.
template <typename TS, typename TX>
__global__ void __launch_bounds__(kThreads)
    range_kernel(const TS* __restrict__ signs, const int* __restrict__ order,
                 int zeta, long long d, int rows_per_chunk,
                 const TX* __restrict__ X, long long b, long long sx1, int R,
                 float* __restrict__ Y) {
  extern __shared__ float g[];
  constexpr int kRowsPerWarp = kRangeRows / kWarps;
  const int pitch = rows_per_chunk * zeta + 1;
  const long long total = d * zeta;
  const long long i0 = (long long)blockIdx.x * rows_per_chunk;
  const int rows = (int)min((long long)rows_per_chunk, d - i0);
  const int S = rows * zeta;
  const long long slot0 = i0 * zeta;
  const int* src = order + slot0;
  const int* dst = order + total + slot0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pieces = (S + 31) >> 5;
  const int wpr = R < kWarps ? kWarps / R : 1;     // warps on a row
  const int r_first = R < kWarps ? warp / wpr : warp;
  const int span = (pieces + wpr - 1) / wpr;
  const int p0 = (warp % wpr) * span, p1 = min(pieces, p0 + span);
  for (long long c0 = (long long)blockIdx.y * R; c0 < b;
       c0 += (long long)gridDim.y * R) {
    const int nr = (int)min((long long)R, b - c0);
    const TX* base = X + c0 * sx1;
    for (int p = p0; p < p1; p += kRangeUnroll) {
      int at[kRangeUnroll];
      float v[kRangeUnroll][kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kRangeUnroll; ++u) {
        const int j = 32 * (p + u) + lane;
        at[u] = -1;
        if (p + u < p1 && j < S) {
          const TX* x = base + __ldg(src + j);
          at[u] = __ldg(dst + j) - (int)slot0;
#pragma unroll
          for (int t = 0; t < kRowsPerWarp; ++t) {
            const int r = r_first + kWarps * t;
            if (r < nr) v[u][t] = ld(x + r * sx1);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRangeUnroll; ++u)
        if (at[u] >= 0) {
#pragma unroll
          for (int t = 0; t < kRowsPerWarp; ++t) {
            const int r = r_first + kWarps * t;
            if (r < nr) g[r * pitch + at[u]] = v[u][t];
          }
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * R; e += kThreads) {
      const int r = e % R, ii = e / R;
      if (r < nr) {
        const long long i = i0 + ii;
        const TS* s_row = signs + i * zeta;
        const float* gr = g + r * pitch + ii * zeta;
        float acc = 0.f;
        for (int s = 0; s < zeta; ++s) acc = fmaf(ld(s_row + s), gr[s], acc);
        Y[i * b + c0 + r] = acc;
      }
    }
    __syncthreads();
  }
}

template <typename TS, typename TX>
cudaError_t launch(const void* signs, const int* idx, const int* order,
                   int zeta, long long d, int rows_per_chunk,
                   int rows_per_block, const void* X, long long b,
                   long long sx0, long long sx1, float* Y,
                   cudaStream_t stream) {
  const TS* sg = static_cast<const TS*>(signs);
  const TX* x = static_cast<const TX*>(X);
  if (order != nullptr) {
    const int R = rows_per_block;
    const long long chunks = (d + rows_per_chunk - 1) / rows_per_chunk;
    const long long groups = (b + R - 1) / R;
    const size_t smem =
        (size_t)R * (rows_per_chunk * zeta + 1) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        range_kernel<TS, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)chunks,
                    (unsigned)(groups < kMaxGridY ? groups : kMaxGridY));
    range_kernel<TS, TX><<<grid, kThreads, smem, stream>>>(
        sg, order, zeta, d, rows_per_chunk, x, b, sx1, R, Y);
    return cudaGetLastError();
  }
  constexpr int V = Vec<TX>::V;
  const bool vec = sx1 == 1 && sx0 % V == 0 && aligned16(X);
  const long long tiles = (b + (long long)kThreads * V - 1) /
                          ((long long)kThreads * V);
  const long long groups = (d + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid((unsigned)tiles,
                  (unsigned)(groups < kMaxGridY ? groups : kMaxGridY));
  rows_kernel<TS, TX><<<grid, kThreads, 0, stream>>>(sg, idx, zeta, d, x, b,
                                                     sx0, sx1, vec, Y);
  return cudaGetLastError();
}

template <typename TS>
cudaError_t by_x(int x_kind, const void* signs, const int* idx,
                 const int* order, int zeta, long long d, int rows_per_chunk,
                 int rows_per_block, const void* X, long long b,
                 long long sx0, long long sx1, float* Y,
                 cudaStream_t stream) {
  if (x_kind == 1)
    return launch<TS, __nv_bfloat16>(signs, idx, order, zeta, d,
                                     rows_per_chunk, rows_per_block, X, b,
                                     sx0, sx1, Y, stream);
  if (x_kind == 2)
    return launch<TS, double>(signs, idx, order, zeta, d, rows_per_chunk,
                              rows_per_block, X, b, sx0, sx1, Y, stream);
  return launch<TS, float>(signs, idx, order, zeta, d, rows_per_chunk,
                           rows_per_block, X, b, sx0, sx1, Y, stream);
}

}  // namespace

extern "C" {

const char* sketch_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Y = T^T X.  With `order` (a transposed view, sx0 == 1; the permutation
// of gather_order for chunks of rows_per_chunk sketch rows) the range
// kernel, rows_per_block rows of the matrix below a block (a power of
// two up to kRangeRows); otherwise the row-major kernel, which takes any
// strides.
int sketch_matmat(const void* signs, int s_kind, const int* idx,
                  const int* order, int zeta, long long d,
                  int rows_per_chunk, int rows_per_block, const void* X,
                  int x_kind, long long N, long long b, long long sx0,
                  long long sx1, float* Y, void* stream) {
  if (zeta < 1 || d < 1 || N < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const int R = rows_per_block;
  if (order != nullptr &&
      (sx0 != 1 || rows_per_chunk < 1 ||
       (long long)rows_per_chunk * zeta > kMaxChunkSlots || R < 1 ||
       R > kRangeRows || (R & (R - 1)) != 0 ||
       (d + rows_per_chunk - 1) / rows_per_chunk > 0x7fffffffLL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (s_kind == 1)
    e = by_x<__nv_bfloat16>(x_kind, signs, idx, order, zeta, d,
                            rows_per_chunk, R, X, b, sx0, sx1, Y, st);
  else if (s_kind == 2)
    e = by_x<double>(x_kind, signs, idx, order, zeta, d, rows_per_chunk, R,
                     X, b, sx0, sx1, Y, st);
  else
    e = by_x<float>(x_kind, signs, idx, order, zeta, d, rows_per_chunk, R, X,
                    b, sx0, sx1, Y, st);
  return (int)e;
}

}  // extern "C"
