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
// Design.  A team of threads owns one row: a warp when L < kLongRow, a
// whole block of 256 threads for longer rows.  The transposed pack of a
// tall matrix has few rows of a few thousand slots each, the forward pack
// many short rows, so each direction fills the card.  A team's lanes are
// CW column lanes times TEAM / CW slot groups (CW = 1 for one vector, 8
// for up to 8 columns, 32 above): slot group g takes slots g, g + TEAM/CW,
// ..., and column lane c gathers X[cols[i, s], c0 + c], so the CW lanes
// of a slot read one contiguous segment of an X row, and every thread
// keeps a single f32 accumulator.  For one vector (CW = 1) the lanes
// stride over the slots and the loads of vals and cols are coalesced.
// The team sums its slot groups with a fixed xor-shuffle tree and, for a
// block, the warps' sums in warp order through shared memory.  No
// atomics: the same bits on every run.  Columns past 32 go to grid.y.
// The reference pads rows to a multiple of 128 and slots to 128 lanes;
// this kernel masks its ragged edges and never pads or copies the pack.
// Offsets are 64-bit: m * L and n * b may pass 2^31.
//
// What bounds it.  Two flops per stored slot and column, so the bytes
// bound it: the pack (vals plus a 4-byte column per slot) is streamed
// once, and each slot gathers X[cols[i, s], :].  A gathered 4-byte value
// costs a 32-byte sector of L2: the gather, not the pack, sets the time
// of the transposed direction, whose x (a few MB for one vector, 38 MB
// for a 20-column block of the sparse cell) is read at random.  vals may
// be f32, bf16 or f64; each is converted to f32 before it is multiplied,
// and every sum accumulates in f32, as in the reference kernel.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int.  v_kind: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads, kWarps

namespace {

constexpr int kLongRow = 1024;   // slots at which a row gets a whole block

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

}  // extern "C"
