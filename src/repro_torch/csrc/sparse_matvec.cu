// Sparse ELL matvec for Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/sparse_matvec.py:
//
//   sparse_matvec <- sparse_matvec (sparse_matvec.py:75)
//       Y[i, c] = sum_s vals[i, s] * X[cols[i, s], c]       (Y = A X)
//
// vals/cols are the (m, L) padded-ELL pack of A (ell_pack: L is the largest
// row population, empty slots hold value 0 at column 0).  The transposed
// operand is the same kernel on the pack of A^T.  X is (n, b) row-major
// f32 and Y (m, b) f32: b = 1 is the GK matvec, b > 1 a block of
// fsvd_blocked, which the reference gets by vmapping its kernel over the
// columns.  Here a block is one launch, and the pack is read once for
// every 32 columns.
//
// What bounds it.  Two flops per stored slot and column, so the bytes
// bound it: the pack (vals plus a 4-byte column per slot) is streamed
// once, and each slot gathers X[cols[i, s], :].  A gathered 4-byte value
// costs a 32-byte sector of L2, so where x is gathered from L2 the gather,
// not the pack, sets the time: the transposed pack of a tall matrix (few
// rows of thousands of slots, x of a few MB, gathered at random) moves
// four times the pack's bytes in L2 sectors.  vals may be f32, bf16 or
// f64; each is converted to f32 before it is multiplied, and every sum
// accumulates in f32, as in the reference kernel.
//
// Three paths, each for the shape it serves:
//  * Short rows (L < kLongRow; the forward pack), any b: a warp per row
//    (spmv_kernel).  A warp's lanes are CW column lanes times 32 / CW slot
//    groups (CW = 1 for one vector, 8 for up to 8 columns, 32 above): slot
//    group g takes slots g, g + 32/CW, ..., and column lane c gathers
//    X[cols[i, s], c0 + c], so the CW lanes of a slot read one contiguous
//    segment of an X row.  Columns past 32 go to grid.y.
//  * Long rows (L >= kLongRow) without a window layout, any b: the same
//    kernel with a whole block of 256 threads as the team, a block per row.
//    Blocks of columns of the transposed pack take it.
//  * Long rows, one vector, with a window layout (window_kernel): x is cut
//    into windows of kWindow f32 (192 KB) that fit shared memory, and the
//    layout (kernels/sparse_matvec.py window_layout, built once per
//    operator) is the pack itself with each row's slots stably reordered
//    by window, plus a (rows x (windows + 1)) table of where each window's
//    segment starts.  A block owns one window and a range of rows: it
//    stages its window of x in shared memory, then each warp walks one
//    row's segment in that window and gathers from shared memory, never
//    from L2, and writes one partial per (row, window).  One block of 512
//    threads per SM (grid ~ 132), so the pack is streamed once and x is
//    read from L2 once per row group.  A second launch (sum_windows_kernel)
//    sums a row's partials over the windows in window order.  A warp reads
//    its segment as one flat run: the aligned body in 16-byte loads of 4
//    columns and 4 values, with a streaming (evict-first) hint, and the
//    unaligned head and tail (< 4 slots each) slot by slot.  Each lane
//    loads kUnroll groups, then issues all their 4 * kUnroll gathers
//    before it uses any of them, with one accumulator a group, combined in
//    a fixed order.
//
// Sums are fixed by the pack's shape: a team sums its lanes with a fixed
// xor-shuffle tree and, for a block, the warps' sums in warp order; the
// window path's partials are summed in window order.  No atomics: the
// same bits on every run, whatever the grid.  The reference pads rows to
// a multiple of 128 and slots to 128 lanes; this kernel masks its ragged
// edges and never pads or copies the pack.  Offsets are 64-bit: m * L and
// n * b may pass 2^31.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int (cudaErrorInvalidValue for a window
// plan outside this file's limits).  v_kind: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), warp_sum, kThreads

namespace {

constexpr int kLongRow = 1024;   // slots at which a row gets a whole block
constexpr int kUnroll = 4;       // 4-slot groups a lane has in flight
constexpr int kWindow = 49152;   // f32 of x a window stages: 192 KB
constexpr int kWinThreads = 512;   // 16 warps: up to 128 registers, no
                                   // spills at kUnroll = 4
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kMaxWindowBlocks = 65535;   // gridDim.y limit on windows

template <typename TV, int TEAM, int CW>
__global__ void __launch_bounds__(kThreads)
    spmv_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                long long m, int L, const float* __restrict__ X,
                long long b, float* __restrict__ Y) {
  constexpr int kRows = kThreads / TEAM;        // rows a block owns
  constexpr int kGroups = TEAM / CW;            // slot groups of a team
  const int lane = threadIdx.x % TEAM;          // lane within the team
  const int c = lane % CW, g = lane / CW;
  const long long i = (long long)blockIdx.x * kRows + threadIdx.x / TEAM;
  const long long col = (long long)blockIdx.y * CW + c;
  const bool live = i < m && col < b;   // the rest still join the shuffles
  float acc = 0.f;
  if (live) {
    const TV* vrow = vals + i * L;
    const int* crow = cols + i * L;
    for (int s = g; s < L; s += kGroups)
      acc = fmaf(ld(vrow + s), X[(long long)crow[s] * b + col], acc);
  }
#pragma unroll
  for (int o = 16; o >= CW; o >>= 1)            // over the slot groups
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (TEAM == 32) {
    if (live && g == 0) Y[i * b + col] = acc;
    return;
  }
  __shared__ float part[kWarps][CW];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < CW) part[warp][c] = acc;
  __syncthreads();
  if (threadIdx.x < CW && live) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w][c];
    Y[i * b + col] = t;
  }
}

// --- long rows, one vector, by window: flat runs in 16-byte loads -------

// Four values of a 4-slot group (flat index a multiple of 4), streamed.
__device__ __forceinline__ void ld4(const float* v, float (&o)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(v));
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* v, float (&o)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(v));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}
__device__ __forceinline__ void ld4(const double* v, float (&o)[4]) {
  const double2 t0 = __ldcs(reinterpret_cast<const double2*>(v));
  const double2 t1 = __ldcs(reinterpret_cast<const double2*>(v + 2));
  o[0] = __double2float_rn(t0.x); o[1] = __double2float_rn(t0.y);
  o[2] = __double2float_rn(t1.x); o[3] = __double2float_rn(t1.y);
}

// Lane t of a warp: its share of sum over flat slots [a, b) of
// vals[s] * xs[cols[s] - c0], xs the window of x staged from column c0.
// With `vec` (vals and cols 16-byte aligned), the 4-slot groups of [a, b)
// are loaded 16 bytes at a time, kUnroll groups a lane, and the < 4 slots
// before the first group and after the last go one by one to lanes 0..3;
// otherwise every slot goes one by one.  The order of every sum depends
// on a, b and vec alone.
template <typename TV>
__device__ __forceinline__ float run_dot(const TV* __restrict__ vals,
                                         const int* __restrict__ cols,
                                         long long a, long long b, int t,
                                         bool vec, const float* xs, int c0) {
  long long g0 = (a + 3) >> 2, g1 = b >> 2;   // the body: groups [g0, g1)
  if (!vec || g0 >= g1) g0 = g1 = 0;
  float edge = 0.f;
  if (g0 == g1) {
    for (long long s = a + t; s < b; s += 32)
      edge = fmaf(ld(vals + s), xs[cols[s] - c0], edge);
  } else {
    if (t < 4 * g0 - a)
      edge = fmaf(ld(vals + a + t), xs[cols[a + t] - c0], edge);
    if (t < b - 4 * g1)
      edge = fmaf(ld(vals + 4 * g1 + t), xs[cols[4 * g1 + t] - c0], edge);
  }
  float acc[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
  for (long long g = g0 + t; g < g1; g += (long long)kUnroll * 32) {
    int4 c[kUnroll];
    float v[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long gu = g + (long long)u * 32;
      if (gu < g1) {
        c[u] = __ldcs(reinterpret_cast<const int4*>(cols + 4 * gu));
        ld4(vals + 4 * gu, v[u]);
      }
    }
    float xv[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + (long long)u * 32 < g1) {
        xv[u][0] = xs[c[u].x - c0];
        xv[u][1] = xs[c[u].y - c0];
        xv[u][2] = xs[c[u].z - c0];
        xv[u][3] = xs[c[u].w - c0];
      }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (g + (long long)u * 32 < g1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u] = fmaf(v[u][e], xv[u][e], acc[u]);
      }
  }
  static_assert(kUnroll == 4, "the fixed sum below takes four");
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + edge;
}

__device__ __forceinline__ int2 segment(const int* __restrict__ offsets,
                                        long long i, int windows, int w) {
  const int* off = offsets + i * (windows + 1) + w;
  return make_int2(__ldg(off), __ldg(off + 1));
}

// part[w * m + i] = row i's segment in window w (blockIdx.y) . x, for the
// rows [blockIdx.x * rows_per_group, +rows_per_group): the block stages
// x[w * kWindow, ...) in shared memory, then a warp per row.
template <typename TV>
__global__ void __launch_bounds__(kWinThreads, 1)
    window_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                  const int* __restrict__ offsets, long long m, int L,
                  int windows, const float* __restrict__ x, long long n,
                  long long rows_per_group, bool vec,
                  float* __restrict__ part) {
  extern __shared__ __align__(16) float xs[];
  const int w = blockIdx.y;
  const long long c0 = (long long)w * kWindow;
  const int len = (int)min((long long)kWindow, n - c0);
  int e = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {  // kWindow % 4 == 0
    const float4* src = reinterpret_cast<const float4*>(x + c0);
    float4* dst = reinterpret_cast<float4*>(xs);
    for (int q = threadIdx.x; q < len / 4; q += kWinThreads)
      dst[q] = __ldg(src + q);
    e = len / 4 * 4;
  }
  for (int k = e + threadIdx.x; k < len; k += kWinThreads)
    xs[k] = __ldg(x + c0 + k);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_group;
  const long long r1 = min(r0 + rows_per_group, m);
  // a row's segment [off[w], off[w + 1]); the next row's bounds are loaded
  // while this row is summed
  long long i = r0 + warp;
  int2 seg = make_int2(0, 0);
  if (i < r1) seg = segment(offsets, i, windows, w);
  for (; i < r1; i += kWinWarps) {
    const int2 next = i + kWinWarps < r1
                          ? segment(offsets, i + kWinWarps, windows, w)
                          : make_int2(0, 0);
    const float s = warp_sum(run_dot<TV>(vals, cols, i * L + seg.x,
                                         i * L + seg.y, lane, vec, xs,
                                         (int)c0));
    if (lane == 0) part[(long long)w * m + i] = s;
    seg = next;
  }
}

// Y[i] = sum over w of part[w * m + i], in window order.
__global__ void __launch_bounds__(kThreads)
    sum_windows_kernel(const float* __restrict__ part, long long m,
                       int windows, float* __restrict__ Y) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  float t = 0.f;
  for (int w = 0; w < windows; ++w) t += part[(long long)w * m + i];
  Y[i] = t;
}

template <typename TV, int CW>
cudaError_t launch(const void* vals, const int* cols, long long m, int L,
                   const float* X, long long b, float* Y,
                   cudaStream_t stream) {
  const unsigned col_chunks = (unsigned)((b + CW - 1) / CW);
  const TV* v = static_cast<const TV*>(vals);
  if (L >= kLongRow) {
    spmv_kernel<TV, kThreads, CW><<<dim3((unsigned)m, col_chunks), kThreads,
                                     0, stream>>>(v, cols, m, L, X, b, Y);
  } else {
    const unsigned blocks = (unsigned)((m + kWarps - 1) / kWarps);
    spmv_kernel<TV, 32, CW><<<dim3(blocks, col_chunks), kThreads, 0,
                              stream>>>(v, cols, m, L, X, b, Y);
  }
  return cudaGetLastError();
}

template <typename TV>
cudaError_t by_width(const void* vals, const int* cols, long long m, int L,
                     const float* X, long long b, float* Y,
                     cudaStream_t stream) {
  if (b == 1) return launch<TV, 1>(vals, cols, m, L, X, b, Y, stream);
  if (b <= 8) return launch<TV, 8>(vals, cols, m, L, X, b, Y, stream);
  return launch<TV, 32>(vals, cols, m, L, X, b, Y, stream);
}

template <typename TV>
cudaError_t windowed(const void* vals, const int* cols, const int* offsets,
                     long long m, int L, int windows, const float* x,
                     long long n, long long rows_per_group, int groups,
                     float* part, float* Y, cudaStream_t stream) {
  constexpr size_t smem = kWindow * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      window_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const bool vec = aligned16(vals) && aligned16(cols);
  window_kernel<TV><<<dim3((unsigned)groups, (unsigned)windows), kWinThreads,
                      smem, stream>>>(static_cast<const TV*>(vals), cols,
                                      offsets, m, L, windows, x, n,
                                      rows_per_group, vec, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_windows_kernel<<<(unsigned)((m + kThreads - 1) / kThreads), kThreads,
                       0, stream>>>(part, m, windows, Y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sparse_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int sparse_matvec(const void* vals, int v_kind, const int* cols, long long m,
                  int L, const float* X, long long b, float* Y,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_kind == 1)
    e = by_width<__nv_bfloat16>(vals, cols, m, L, X, b, Y, st);
  else if (v_kind == 2)
    e = by_width<double>(vals, cols, m, L, X, b, Y, st);
  else
    e = by_width<float>(vals, cols, m, L, X, b, Y, st);
  return (int)e;
}

// y = A x through a window layout: vals / cols (m, L) the pack in window
// order, offsets (m, windows + 1), x (n,), part (windows * m) scratch.  The plan
// (groups of rows_per_group rows) comes from the wrapper's window_plan.
int sparse_matvec_windows(const void* vals, int v_kind, const int* cols,
                          const int* offsets, long long m, int L,
                          int windows, const float* x, long long n,
                          long long rows_per_group, int groups, float* part,
                          float* Y, void* stream) {
  if (m < 1 || L < 1 || n < 1 || windows < 1 || windows > kMaxWindowBlocks ||
      (long long)(windows - 1) * kWindow >= n ||
      (long long)windows * kWindow < n || rows_per_group < 1 || groups < 1 ||
      (long long)(groups - 1) * rows_per_group >= m ||
      (long long)groups * rows_per_group < m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_kind == 1)
    e = windowed<__nv_bfloat16>(vals, cols, offsets, m, L, windows, x, n,
                                rows_per_group, groups, part, Y, st);
  else if (v_kind == 2)
    e = windowed<double>(vals, cols, offsets, m, L, windows, x, n,
                         rows_per_group, groups, part, Y, st);
  else
    e = windowed<float>(vals, cols, offsets, m, L, windows, x, n,
                        rows_per_group, groups, part, Y, st);
  return (int)e;
}

}  // extern "C"
