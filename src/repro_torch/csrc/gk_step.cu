// Fused Golub-Kahan half-step kernels for Hopper (sm_90a).
//
// Replaces the four Pallas kernels of src/repro/kernels/gk_step.py and the
// two of src/repro/kernels/gk_matvec.py:
//
//   gk_mv_qtv     <- mv_qtv    (gk_step.py:147)  u = A p - alpha y ; c = Q^T u
//   gk_rmv_qtv    <- rmv_qtv   (gk_step.py:178)  v = A^T q - beta y ; c = P^T v
//   gk_proj_qtv   <- proj_qtv  (gk_step.py:206)  w = u - Q c ; c' = Q^T w
//   gk_proj_norm  <- proj_norm (gk_step.py:232)  v = u - Q c ; ||v||^2
//   gk_matvec_fused  <- matvec_fused  (gk_matvec.py:71)   u = A p - alpha y
//   gk_rmatvec_fused <- rmatvec_fused (gk_matvec.py:92)   v = A^T q - beta y
//
// One GK half-step is stage 1 (mv or rmv), then (passes-1) x proj_qtv, then
// proj_norm; the composition lives in repro_torch/kernels/ops.py.  The two
// fused matvecs compute stage 1's vector with no basis; the operator calls
// them for the half-steps of a float64 DenseOp(backend="pallas").
// rmatvec_fused is stage 1 of rmv with k = 0 (no c = P^T v epilogue and no
// finishing launch); matvec_fused has a row kernel of its own.
//
// What bounds them.  Every kernel does about one multiply-add per element it
// reads, far below the card's ~20 flop/byte f32 ridge, so each is bound by
// bytes of device memory: stage 1 reads A once (m*n elements, 32 GB at the
// 1e5 x 8e4 f32 operand) plus the basis once; each proj kernel reads the
// basis once from device memory.  A half-step therefore moves
// |A| + (passes+1)|Q| bytes, and |A| dominates by ~400x at the main shape.
// The designs below aim at one thing: stream A (and Q) exactly once, with
// coalesced loads, and never write a vector of length m or n to memory
// between the matvec and the first projection product.
//
// Design.
//  * Stage 1's row kernel (rows_kernel) gives each warp one row at a time:
//    the warp computes that row's scalar (a dot product over A's row,
//    lanes on adjacent addresses, 16-byte vector loads where the row is
//    aligned), then the block folds the eight scalars of the group into
//    its share of c = Q^T u while the Q rows are still in L1.  The scalar
//    never makes a round trip through device memory before c sees it.
//  * The fused matvec u = A p - alpha y (matvec_kernel) needs no block
//    fold, so it runs no barrier: a persistent grid of 132 x 4 blocks,
//    each warp on its own rows with stage 1's row_dot.  rows_kernel's two
//    __syncthreads() a group of 8 rows made the warps of a block wait for
//    each other (draining their loads), and its rows_plan grid left a thin
//    second wave (194 of 1,250 blocks at m = 20,000).
//  * The projection pair (proj_kernel) streams only the basis, 80 MB at
//    the main Q (1e5 x 201 f32), so what holds it back is bytes in flight
//    and arithmetic that does not overlap them.  Its rows of odd width are
//    never 16-byte aligned, so it does not load row by row: a tile of
//    rows is one contiguous run of the array, copied into shared memory in
//    aligned 16-byte cp.async chunks (the ends of the array element by
//    element), two stages deep, so the next tile's copy is in flight while
//    this one is projected.  Each staged element is read once from shared
//    memory: up to 256 columns a warp takes a row with lanes along it, c
//    in registers, and the same loaded values give the row's dot product,
//    w_r, and (with w_r) the warp's running column sums of c' = Q^T w.
//    Wider bases keep c in shared memory where it fits beside the stages,
//    else read it through the read-only cache, and add each tile's share
//    of c' in place in the block's partials in device memory.  Block b walks tiles b, b+G, ... of a
//    fixed grid G (264), so the finishing launch sums G partials, not one
//    per row block.
//  * A^T q from row-major A (rmv): threads own adjacent columns, so each
//    warp's load of a row segment is coalesced.  Column tiles alone give
//    only n/256 blocks (8 at n = 2000), so the rows are cut into chunks as
//    well; each (tile, chunk) block writes a partial column sum.
//  * Cross-block sums are deterministic.  The TPU grid runs in sequence and
//    accumulates c and ||v||^2 in place; Hopper runs blocks at once, so
//    every block writes its own partial and a finishing launch sums the
//    partials in a fixed order (a fixed-shape tree in shared memory).  No
//    float atomics: the same inputs give the same bits on every run.
//  * Offsets are 64-bit: m*n is 8e9 at the main shape, above 2^31.
//  * Nothing is padded or copied: the kernels mask ragged edges themselves.
//  * A and the basis are each f32 or bf16; bf16 is widened with
//    __bfloat162float and every product accumulates in f32.  Outputs f32.
//    The fused matvecs also take an f64 A, each element narrowed to f32
//    before it is multiplied, as the reference kernels cast every A tile
//    with .astype(jnp.float32): an f64 operand is read at 8 bytes an
//    element but multiplied in f32.
//
// C interface for ctypes: every entry point launches on the given stream,
// allocates nothing (the caller passes outputs and scratch) and returns
// cudaGetLastError() as an int.  The fused matvecs' a_kind: 0 f32, 1 bf16,
// 2 f64.

#include "gk_rows.cuh"  // row_dot, rmv_partial_kernel, ld

namespace {

// Row scalars: operator()(i, lane) is called by a whole warp for row i.
template <typename TA, int V>
struct MvRow {  // u_i = A[i, :] . p - alpha y_i
  const TA* A;
  const float* p;
  const float* y;
  const float* alpha;
  long long n;
  __device__ float operator()(long long i, int lane) const {
    return row_dot<TA, V>(A + i * n, p, n, lane) - alpha[0] * y[i];
  }
};

struct RmvRow {  // v_j = sum over row chunks of the partial column sums - beta y_j
  const float* vpart;
  int chunks;
  long long n;
  const float* y;
  const float* beta;
  __device__ float operator()(long long j, int lane) const {
    float s = 0.f;
    for (int t = lane; t < chunks; t += 32) s += vpart[(long long)t * n + j];
    return warp_sum(s) - beta[0] * y[j];
  }
};

// Block b owns rows [b*rows_per_block, (b+1)*rows_per_block) of a length-L
// vector.  Each warp computes one row scalar and writes it to out, and the
// block accumulates its share of c = Q^T out (k floats of dynamic shared
// memory, written to part[j * gridDim.x + b]).
template <class Row, typename TQ>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(Row row, const TQ* __restrict__ Q, int k, long long L,
                long long rows_per_block, float* __restrict__ out,
                float* __restrict__ part) {
  extern __shared__ float sc[];
  __shared__ float sw[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, L);
  for (int j = threadIdx.x; j < k; j += kThreads) sc[j] = 0.f;
  for (long long g = r0; g < r1; g += kWarps) {
    const long long i = g + warp;
    float val = 0.f;
    if (i < r1) val = row(i, lane);  // uniform per warp
    if (lane == 0) {
      sw[warp] = val;
      if (i < r1) out[i] = val;
    }
    __syncthreads();
    const int nw = (int)min((long long)kWarps, r1 - g);
    for (int j = threadIdx.x; j < k; j += kThreads) {
      float acc = sc[j];
      for (int w = 0; w < nw; ++w)
        acc = fmaf(ld(Q + (g + w) * k + j), sw[w], acc);
      sc[j] = acc;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += kThreads)
    part[(long long)j * gridDim.x + blockIdx.x] = sc[j];
}

// out[b] = sum of part[b*G : (b+1)*G], summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ part, int G,
                  float* __restrict__ out) {
  __shared__ float s[kThreads];
  const float* row = part + (long long)blockIdx.x * G;
  float acc = 0.f;
  for (int b = threadIdx.x; b < G; b += kThreads) acc += row[b];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

template <class Row, typename TQ>
cudaError_t launch_rows(const Row& row, const TQ* Q, int k, long long L,
                        long long rows_per_block, int grid, float* out,
                        float* part, cudaStream_t stream) {
  const size_t smem = (size_t)k * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<Row, TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  rows_kernel<Row, TQ><<<grid, kThreads, smem, stream>>>(
      row, Q, k, L, rows_per_block, out, part);
  return cudaGetLastError();
}

cudaError_t finish(const float* part, int G, int count, float* out,
                   cudaStream_t stream) {
  if (count == 0) return cudaSuccess;
  finish_kernel<<<count, kThreads, 0, stream>>>(part, G, out);
  return cudaGetLastError();
}

template <typename TA, int V, typename TQ>
cudaError_t mv_qtv(const void* A, const float* p, const float* y,
                   const float* alpha, const void* Q, long long m,
                   long long n, int k, long long rows_per_block, int grid,
                   float* u, float* part, float* c, cudaStream_t stream) {
  const MvRow<TA, V> row{static_cast<const TA*>(A), p, y, alpha, n};
  const cudaError_t e = launch_rows<MvRow<TA, V>, TQ>(
      row, static_cast<const TQ*>(Q), k, m, rows_per_block, grid, u, part,
      stream);
  if (e != cudaSuccess) return e;
  return finish(part, grid, k, c, stream);
}

template <typename TA, typename TQ>
cudaError_t mv_qtv_vec(const void* A, const float* p, const float* y,
                       const float* alpha, const void* Q, long long m,
                       long long n, int k, long long rows_per_block, int grid,
                       float* u, float* part, float* c, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TA);  // elements of A in 16 bytes
  if (n % V == 0 && aligned16(A) && aligned16(p))
    return mv_qtv<TA, V, TQ>(A, p, y, alpha, Q, m, n, k, rows_per_block,
                             grid, u, part, c, stream);
  return mv_qtv<TA, 1, TQ>(A, p, y, alpha, Q, m, n, k, rows_per_block, grid,
                           u, part, c, stream);
}

// --- the fused matvec: a persistent row kernel with no barrier -----------
//
// u = A p - alpha y alone (stage 1 with no basis).  The grid is sized to
// the card, kSms SMs times the blocks an SM holds at ptxas's registers:
// warp w of the grid's W warps takes rows w, w + W, ..., each with
// MvRow's row_dot (the order of mv_qtv's stage 1, so u has its bits), and
// lane 0 writes u_i.  No __syncthreads(): no warp waits for another, so
// each keeps its row's loads in flight, and the last rows leave no thin
// second wave of blocks behind.

constexpr int kSms = 132;            // H100 SXM
constexpr int kMvBlocksPerSm = 4;    // 4 x 256 threads: <= 64 registers
constexpr int kMvMaxBlocks = kSms * kMvBlocksPerSm;

template <typename TA, int V>
__global__ void __launch_bounds__(kThreads, kMvBlocksPerSm)
    matvec_kernel(MvRow<TA, V> row, long long m, float* __restrict__ u) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       i < m; i += warps) {
    const float val = row(i, lane);   // uniform per warp
    if (lane == 0) u[i] = val;
  }
}

// The grid comes from the wrapper's matvec_plan; a grid past kMvMaxBlocks,
// or with a block that owns no row, is refused before a launch.
template <typename TA>
cudaError_t matvec(const void* A, const float* p, const float* y,
                   const float* alpha, long long m, long long n, int grid,
                   float* u, cudaStream_t stream) {
  if (m < 1 || n < 1 || grid < 1 || grid > kMvMaxBlocks ||
      (long long)(grid - 1) * kWarps >= m)
    return cudaErrorInvalidValue;
  constexpr int V = 16 / sizeof(TA);  // elements of A in 16 bytes
  const TA* a = static_cast<const TA*>(A);
  if (n % V == 0 && aligned16(A) && aligned16(p))
    matvec_kernel<TA, V><<<grid, kThreads, 0, stream>>>(
        MvRow<TA, V>{a, p, y, alpha, n}, m, u);
  else
    matvec_kernel<TA, 1><<<grid, kThreads, 0, stream>>>(
        MvRow<TA, 1>{a, p, y, alpha, n}, m, u);
  return cudaGetLastError();
}

template <typename TA, typename TP>
cudaError_t rmv_qtv(const void* A, const float* q, const float* y,
                    const float* beta, const void* P, long long m,
                    long long n, int k, long long rows_per_chunk, int chunks,
                    float* vpart, long long rows_per_block, int grid,
                    float* v, float* part, float* c, cudaStream_t stream) {
  cudaError_t e = launch_rmv_partial(static_cast<const TA*>(A), q, m, n,
                                     rows_per_chunk, chunks, vpart, stream);
  if (e != cudaSuccess) return e;
  const RmvRow row{vpart, chunks, n, y, beta};
  e = launch_rows<RmvRow, TP>(row, static_cast<const TP*>(P), k, n,
                              rows_per_block, grid, v, part, stream);
  if (e != cudaSuccess) return e;
  return finish(part, grid, k, c, stream);
}

// --- the projection pair: flat tiles staged in shared memory --------------
//
// A tile is `rows` consecutive rows of the basis, one contiguous run of
// rows*k elements of the row-major array whatever k's parity.  A stage of
// shared memory holds the tile's slice of u (4-byte cp.async copies), then
// the run, copied in 16-byte cp.async chunks.  The chunks are aligned in
// device memory, so the run starts (g0 & 15) bytes into its buffer; a
// chunk at a tile's edge also carries bytes of the neighbouring tile,
// which this tile ignores.  Only at the two ends of the array does an
// aligned chunk reach outside it: there the elements are copied one by one.

constexpr int kProjBlocks = 264;     // grid cap: two blocks on each of 132 SMs
constexpr int kMaxTileRows = 512;
constexpr int kMaxK = 49152;         // the wrappers' MAX_K
constexpr long long kSmemLimit = 232448 - 256;  // 227 KB a block can have,
                                                // less room for red[]
constexpr int kMaxStages = 2;
constexpr int kCShared = 1;          // plan flag: c in shared memory

__host__ __device__ inline long long round16(long long x) {
  return (x + 15) & ~15LL;
}

// Bytes of one stage: the u slice, the run and room for a 16-byte
// misalignment at either end of it.
__host__ __device__ inline long long stage_bytes(int rows, int k, int esize) {
  return round16(4LL * rows) + round16((long long)rows * k * esize) + 32;
}

inline long long proj_smem(int rows, int k, int esize, int stages,
                           int flags) {
  long long s = stage_bytes(rows, k, esize) * stages;
  if (flags & kCShared) s += round16(4LL * k);
  return s;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where tile t lies: rows [r0, r0 + rows), bytes [g0, g1) of the array.
template <typename TQ>
struct ProjTile {
  long long r0;
  int rows;
  unsigned long long g0, g1;
  __device__ ProjTile(const TQ* Q, long long L, int k, int tile_rows,
                      long long t) {
    r0 = t * tile_rows;
    rows = (int)min((long long)tile_rows, L - r0);
    const unsigned long long row = (unsigned long long)k * sizeof(TQ);
    g0 = reinterpret_cast<unsigned long long>(Q) + r0 * row;
    g1 = g0 + rows * row;
  }
  // the first element of the run in its stage buffer
  __device__ const TQ* run(const char* stage) const {
    return reinterpret_cast<const TQ*>(stage + round16(4LL * rows) +
                                       (g0 & 15));
  }
};

// Start the copies of tile t into `stage` (the peeled ends are plain loads
// and stores, visible after the next __syncthreads).
template <typename TQ>
__device__ void stage_tile(char* stage, const float* __restrict__ u,
                           const TQ* Q, long long L, int k, int tile_rows,
                           long long t) {
  const ProjTile<TQ> tile(Q, L, k, tile_rows, t);
  float* su = reinterpret_cast<float*>(stage);
  for (int r = threadIdx.x; r < tile.rows; r += kThreads)
    cp_async4(su + r, u + tile.r0 + r);
  char* run = stage + round16(4LL * tile.rows);  // 16-byte aligned
  const unsigned long long d0 = tile.g0 & ~15ULL;  // run[0] <-> d0
  const unsigned long long base = reinterpret_cast<unsigned long long>(Q);
  const unsigned long long end = base + L * (unsigned long long)k * sizeof(TQ);
  const unsigned long long body0 = round16(base), body1 = end & ~15ULL;
  const unsigned long long head1 = min(body0, end);
  const unsigned long long tail0 = max(body1, head1);
  const unsigned long long c0 = max(d0, body0);
  const unsigned long long c1 =
      min((unsigned long long)round16(tile.g1), body1);
  for (unsigned long long a = c0 + 16ULL * threadIdx.x; a < c1;
       a += 16ULL * kThreads)
    cp_async16(run + (a - d0), reinterpret_cast<const void*>(a));
  const unsigned long long ends[2][2] = {{tile.g0, min(tile.g1, head1)},
                                         {max(tile.g0, tail0), tile.g1}};
  for (int e = 0; e < 2; ++e)
    for (unsigned long long a = ends[e][0] + sizeof(TQ) * threadIdx.x;
         a < ends[e][1]; a += sizeof(TQ) * kThreads)
      *reinterpret_cast<TQ*>(run + (a - d0)) = *reinterpret_cast<const TQ*>(a);
}

// w = u - Q c over the staged tile (a warp per row, lanes along it), then
// the tile's share of c' = Q^T w into acc[j * gridDim.x] (threads own
// columns and walk the tile's rows) or of ||w||^2 into nrm (lane 0 of
// each warp).  Reads the tile from shared memory only.
template <typename TQ, bool NORM>
__device__ void project_tile(char* stage, const ProjTile<TQ>& tile, int k,
                             const float* cc, float* acc,
                             float* __restrict__ w, float& nrm) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* su = reinterpret_cast<float*>(stage);  // u in, w out
  const TQ* q = tile.run(stage);
  for (int r = warp; r < tile.rows; r += kWarps) {
    const TQ* qr = q + (long long)r * k;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int j = lane;
    for (; j + 96 < k; j += 128) {
      a0 = fmaf(ld(qr + j), cc[j], a0);
      a1 = fmaf(ld(qr + j + 32), cc[j + 32], a1);
      a2 = fmaf(ld(qr + j + 64), cc[j + 64], a2);
      a3 = fmaf(ld(qr + j + 96), cc[j + 96], a3);
    }
    for (; j < k; j += 32) a0 = fmaf(ld(qr + j), cc[j], a0);
    const float dot = warp_sum((a0 + a1) + (a2 + a3));
    if (lane == 0) {
      const float wr = su[r] - dot;
      su[r] = wr;
      w[tile.r0 + r] = wr;
      if (NORM) nrm = fmaf(wr, wr, nrm);
    }
  }
  __syncthreads();
  if (!NORM) {
    for (int j = threadIdx.x; j < k; j += kThreads) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int r = 0;
      for (; r + 3 < tile.rows; r += 4) {
        a0 = fmaf(ld(q + (long long)r * k + j), su[r], a0);
        a1 = fmaf(ld(q + (long long)(r + 1) * k + j), su[r + 1], a1);
        a2 = fmaf(ld(q + (long long)(r + 2) * k + j), su[r + 2], a2);
        a3 = fmaf(ld(q + (long long)(r + 3) * k + j), su[r + 3], a3);
      }
      for (; r < tile.rows; ++r)
        a0 = fmaf(ld(q + (long long)r * k + j), su[r], a0);
      acc[(long long)j * gridDim.x] += (a0 + a1) + (a2 + a3);
    }
  }
}

// The same for k <= 32 * kRegCols, with one read of each staged element:
// lane l holds c[l + 32 t] in cr[t]; a warp loads row r's elements
// (lanes along the row), folds them with cr into the row's dot product,
// and with w_r into its own column sums ar[t] (c' = Q^T w, the warp's
// rows only: the block adds its warps' sums at the end, in warp order).
constexpr int kRegCols = 8;  // k up to 256

template <typename TQ, bool NORM>
__device__ void project_tile_regs(const char* stage, const ProjTile<TQ>& tile,
                                  int k, const float (&cr)[kRegCols],
                                  float (&ar)[kRegCols],
                                  float* __restrict__ w, float& nrm) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* su = reinterpret_cast<const float*>(stage);
  const TQ* q = tile.run(stage);
  for (int r = warp; r < tile.rows; r += kWarps) {
    const TQ* qr = q + (long long)r * k;
    float qv[kRegCols];
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < kRegCols; ++t) {
      const int j = lane + 32 * t;
      qv[t] = j < k ? ld(qr + j) : 0.f;
      dot = fmaf(qv[t], cr[t], dot);
    }
    const float wr = su[r] - warp_sum(dot);
    if (!NORM) {
#pragma unroll
      for (int t = 0; t < kRegCols; ++t) ar[t] = fmaf(qv[t], wr, ar[t]);
    }
    if (lane == 0) {
      w[tile.r0 + r] = wr;
      if (NORM) nrm = fmaf(wr, wr, nrm);
    }
  }
}

// Block b walks tiles b, b + G, b + 2G, ... (G = gridDim.x) through a ring
// of `stages` buffers (2, or 1 where two do not fit): the next tile's copy
// is in flight while this one is projected.  Its partial goes to
// part[j * G + b] (c', k of them) or part[b] (||w||^2); finish_kernel sums
// the G partials in a fixed order.  REGS (k <= 256): c and the column sums
// in registers.  Otherwise c sits in shared memory where the plan's flag
// puts it, and the column sums accumulate in place in part.
template <typename TQ, bool NORM, bool REGS>
__global__ void __launch_bounds__(kThreads)
    proj_kernel(const float* __restrict__ u, const TQ* __restrict__ Q,
                const float* __restrict__ c_in, long long L, int k,
                int tile_rows, long long tiles, int stages, int flags,
                float* __restrict__ w, float* __restrict__ part) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sbytes = stage_bytes(tile_rows, k, sizeof(TQ));
  const float* cc = c_in;
  float* acc = part + blockIdx.x;
  float cr[kRegCols], ar[kRegCols];
  if (REGS) {
#pragma unroll
    for (int t = 0; t < kRegCols; ++t) {
      const int j = lane + 32 * t;
      cr[t] = j < k ? c_in[j] : 0.f;
      ar[t] = 0.f;
    }
  } else {
    if (flags & kCShared) {
      float* sc = reinterpret_cast<float*>(smem + sbytes * stages);
      for (int j = threadIdx.x; j < k; j += kThreads) sc[j] = c_in[j];
      cc = sc;
    }
    if (!NORM)  // each thread zeroes, and later adds to, its own columns
      for (int j = threadIdx.x; j < k; j += kThreads)
        acc[(long long)j * gridDim.x] = 0.f;
  }
  float nrm = 0.f;

  const long long G = gridDim.x;
  for (int s = 0; s + 1 < stages; ++s) {  // one copy group per stage
    if (blockIdx.x + s * G < tiles)
      stage_tile(smem + s * sbytes, u, Q, L, k, tile_rows, blockIdx.x + s * G);
    cp_async_commit();
  }
  int it = 0;
  for (long long t = blockIdx.x; t < tiles; t += G, ++it) {
    const long long ahead = t + (stages - 1) * G;
    if (ahead < tiles)
      stage_tile(smem + ((it + stages - 1) % stages) * sbytes, u, Q, L, k,
                 tile_rows, ahead);
    cp_async_commit();
    if (stages == 2)  // tile t has landed; tile t + G may be in flight
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    char* stage = smem + (it % stages) * sbytes;
    const ProjTile<TQ> tile(Q, L, k, tile_rows, t);
    if (REGS)
      project_tile_regs<TQ, NORM>(stage, tile, k, cr, ar, w, nrm);
    else
      project_tile<TQ, NORM>(stage, tile, k, cc, acc, w, nrm);
    __syncthreads();  // the stage is refilled next
  }
  if (NORM) {
    if (lane == 0) red[warp] = nrm;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red[i];
      part[blockIdx.x] = s;
    }
  } else if (REGS) {  // the warps' column sums, through the idle stages
    float* sums = reinterpret_cast<float*>(smem);  // kWarps x k
#pragma unroll
    for (int t = 0; t < kRegCols; ++t)
      if (lane + 32 * t < k) sums[warp * k + lane + 32 * t] = ar[t];
    __syncthreads();
    for (int j = threadIdx.x; j < k; j += kThreads) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += sums[i * k + j];
      part[(long long)j * gridDim.x + blockIdx.x] = s;
    }
  }
}

template <typename TQ, bool NORM, bool REGS>
cudaError_t launch_proj(const float* u, const void* Q, const float* c_in,
                        long long L, int k, int tile_rows, long long tiles,
                        int grid, int stages, int flags, long long smem,
                        float* w, float* part, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        proj_kernel<TQ, NORM, REGS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  proj_kernel<TQ, NORM, REGS><<<grid, kThreads, smem, stream>>>(
      u, static_cast<const TQ*>(Q), c_in, L, k, tile_rows, tiles, stages,
      flags, w, part);
  return cudaGetLastError();
}

// The plan (tile rows, grid, stages, flags) comes from the wrapper's
// proj_plan; anything outside this file's limits is refused before a
// launch.
template <typename TQ, bool NORM>
cudaError_t proj(const float* u, const void* Q, const float* c_in,
                 long long L, int k, int tile_rows, int grid, int stages,
                 int flags, float* w, float* part, float* out,
                 cudaStream_t stream) {
  if (L < 1 || k < 0 || k > kMaxK || tile_rows < 1 ||
      tile_rows > kMaxTileRows || grid < 1 || grid > kProjBlocks ||
      stages < 1 || stages > kMaxStages || (flags & ~kCShared) != 0)
    return cudaErrorInvalidValue;
  const long long tiles = (L + tile_rows - 1) / tile_rows;
  const long long smem =
      proj_smem(tile_rows, k, sizeof(TQ), stages, flags);
  const bool regs = k <= 32 * kRegCols;
  // the register path sums its warps' columns in the stages at the end
  const long long sums = regs && !NORM ? 4LL * kWarps * k : 0;
  if (grid > tiles || smem > kSmemLimit ||
      stage_bytes(tile_rows, k, sizeof(TQ)) * stages < sums)
    return cudaErrorInvalidValue;
  const cudaError_t e =
      regs ? launch_proj<TQ, NORM, true>(u, Q, c_in, L, k, tile_rows, tiles,
                                         grid, stages, flags, smem, w, part,
                                         stream)
           : launch_proj<TQ, NORM, false>(u, Q, c_in, L, k, tile_rows, tiles,
                                          grid, stages, flags, smem, w, part,
                                          stream);
  if (e != cudaSuccess) return e;
  return finish(part, grid, NORM ? 1 : k, out, stream);
}

}  // namespace

extern "C" {

const char* gk_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int gk_mv_qtv(const void* A, int a_bf16, const float* p, const float* y,
              const float* alpha, const void* Q, int q_bf16, long long m,
              long long n, int k, long long rows_per_block, int grid,
              float* u, float* part, float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (a_bf16)
    e = q_bf16 ? mv_qtv_vec<bf, bf>(A, p, y, alpha, Q, m, n, k,
                                    rows_per_block, grid, u, part, c, s)
               : mv_qtv_vec<bf, float>(A, p, y, alpha, Q, m, n, k,
                                       rows_per_block, grid, u, part, c, s);
  else
    e = q_bf16 ? mv_qtv_vec<float, bf>(A, p, y, alpha, Q, m, n, k,
                                       rows_per_block, grid, u, part, c, s)
               : mv_qtv_vec<float, float>(A, p, y, alpha, Q, m, n, k,
                                          rows_per_block, grid, u, part, c,
                                          s);
  return (int)e;
}

int gk_rmv_qtv(const void* A, int a_bf16, const float* q, const float* y,
               const float* beta, const void* P, int p_bf16, long long m,
               long long n, int k, long long rows_per_chunk, int chunks,
               float* vpart, long long rows_per_block, int grid, float* v,
               float* part, float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (a_bf16)
    e = p_bf16 ? rmv_qtv<bf, bf>(A, q, y, beta, P, m, n, k, rows_per_chunk,
                                 chunks, vpart, rows_per_block, grid, v, part,
                                 c, s)
               : rmv_qtv<bf, float>(A, q, y, beta, P, m, n, k,
                                    rows_per_chunk, chunks, vpart,
                                    rows_per_block, grid, v, part, c, s);
  else
    e = p_bf16 ? rmv_qtv<float, bf>(A, q, y, beta, P, m, n, k,
                                    rows_per_chunk, chunks, vpart,
                                    rows_per_block, grid, v, part, c, s)
               : rmv_qtv<float, float>(A, q, y, beta, P, m, n, k,
                                       rows_per_chunk, chunks, vpart,
                                       rows_per_block, grid, v, part, c, s);
  return (int)e;
}

int gk_proj_qtv(const float* u, const void* Q, int q_bf16, const float* c_in,
                long long L, int k, int tile_rows, int grid, int stages,
                int flags, float* w, float* part, float* c_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, false>(u, Q, c_in, L, k,
                                                   tile_rows, grid, stages,
                                                   flags, w, part, c_out, s)
                      : proj<float, false>(u, Q, c_in, L, k, tile_rows, grid,
                                           stages, flags, w, part, c_out, s));
}

int gk_proj_norm(const float* u, const void* Q, int q_bf16,
                 const float* c_in, long long L, int k, int tile_rows,
                 int grid, int stages, int flags, float* v, float* part,
                 float* nrm2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, true>(u, Q, c_in, L, k,
                                                  tile_rows, grid, stages,
                                                  flags, v, part, nrm2, s)
                      : proj<float, true>(u, Q, c_in, L, k, tile_rows, grid,
                                          stages, flags, v, part, nrm2, s));
}

int gk_matvec_fused(const void* A, int a_kind, const float* p, const float* y,
                    const float* alpha, long long m, long long n, int grid,
                    float* u, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_kind == 1)
    e = matvec<__nv_bfloat16>(A, p, y, alpha, m, n, grid, u, s);
  else if (a_kind == 2)
    e = matvec<double>(A, p, y, alpha, m, n, grid, u, s);
  else
    e = matvec<float>(A, p, y, alpha, m, n, grid, u, s);
  return (int)e;
}

int gk_rmatvec_fused(const void* A, int a_kind, const float* q,
                     const float* y, const float* beta, long long m,
                     long long n, long long rows_per_chunk, int chunks,
                     float* vpart, long long rows_per_block, int grid,
                     float* v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_kind == 1)
    e = rmv_qtv<__nv_bfloat16, float>(A, q, y, beta, nullptr, m, n, 0,
                                      rows_per_chunk, chunks, vpart,
                                      rows_per_block, grid, v, nullptr,
                                      nullptr, s);
  else if (a_kind == 2)
    e = rmv_qtv<double, float>(A, q, y, beta, nullptr, m, n, 0,
                               rows_per_chunk, chunks, vpart, rows_per_block,
                               grid, v, nullptr, nullptr, s);
  else
    e = rmv_qtv<float, float>(A, q, y, beta, nullptr, m, n, 0,
                              rows_per_chunk, chunks, vpart, rows_per_block,
                              grid, v, nullptr, nullptr, s);
  return (int)e;
}

}  // extern "C"
