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
// rmatvec_fused is rmv's A^T q pass alone; rmv_qtv is that pass, then
// c = P^T v over staged tiles of P (proj_tiles.cuh, as reorth_qtv), so
// its v has rmatvec_fused's bits and its c reorth_qtv's.
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
//  * A^T q from row-major A (rmv_partial_kernel), with no stored
//    transpose: threads own columns, so a warp's load of a row segment is
//    coalesced, and each thread keeps its columns' sums in registers down
//    a chunk of rows.  A column tile is 256 threads x the V elements of A
//    in 16 bytes (1,024 f32 columns: a 4 KB segment of each row), each
//    thread with 16-byte loads of 8 rows in flight; where n is narrower,
//    the block splits into row groups as wide as n needs, each on its own
//    rows, so no thread idles.  The grid is one wave: tiles x chunks
//    blocks, as many chunks as fit beside the tiles in the 132 x 4 blocks
//    the card holds at once (a grid of ~4,096 blocks runs 4.15 waves at
//    the main shape, the last one thin), and every tile is cut at the
//    same rows, so the blocks of a chunk stream the same rows of A
//    together.  Each block writes its partial column sums to its
//    own slot; rmv_finish_kernel adds a column's chunks in a fixed order,
//    lanes on adjacent columns (coalesced whatever the chunk count), and
//    subtracts beta y.  Where n % V or A's alignment rules 16-byte loads
//    out, each thread takes V columns a group's width apart with element
//    loads: the same sums in the same order, so the same bits.
//  * The projection pair and rmv_qtv's P^T v: flat tiles of whole rows
//    staged in shared memory (proj_tiles.cuh).
//  * Cross-block sums are deterministic.  The TPU grid runs in sequence and
//    accumulates c and ||v||^2 in place; Hopper runs blocks at once, so
//    every block writes its own partial and a finishing launch sums the
//    partials in a fixed order.  No float atomics: the same inputs give
//    the same bits on every run.
//  * Offsets are 64-bit: m*n is 8e9 at the main shape, above 2^31.
//  * Stacked examples (the batched solve): gk_mv_qtv, gk_rmv_qtv,
//    gk_proj_qtv and gk_proj_norm take `batch` examples of one shape laid
//    out one after another (A (B, m, n), vectors (B, len), alpha / beta
//    (B,), bases (B, L, k)).  The grid's y dimension walks the examples:
//    each block moves its pointers to its example first (64-bit offsets)
//    and then runs the single launch's plan, so every example's blocks,
//    partials and finishing sums, and with them its bits, are those of a
//    single launch on it.  A batch of 1 is the single launch: rows_kernel
//    and the projection pair compile it without the stacked step, the
//    A^T q kernels move by example 0.  One call covers the batch: a
//    stage is one launch (two with its finish) for all B examples.
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

#include "proj_tiles.cuh"  // row_dot, ld, finish, proj (with gk_rows.cuh)

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
  // the same rows of stacked example b (each of m rows)
  __device__ MvRow at(long long b, long long m) const {
    return MvRow{A + b * m * n, p + b * n, y + b * m, alpha + b, n};
  }
};

// Block b owns rows [b*rows_per_block, (b+1)*rows_per_block) of a length-L
// vector.  Each warp computes one row scalar and writes it to out, and the
// block accumulates its share of c = Q^T out (k floats of dynamic shared
// memory, written to part[j * gridDim.x + b]).  STACKED: blockIdx.y is
// the example, and Row, Q, out and part are moved to it first; a single
// launch compiles without that step.
template <class Row, typename TQ, bool STACKED>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(Row row, const TQ* __restrict__ Q, int k, long long L,
                long long rows_per_block, float* __restrict__ out,
                float* __restrict__ part) {
  extern __shared__ float sc[];
  __shared__ float sw[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (STACKED) {
    const long long ex = blockIdx.y;
    row = row.at(ex, L);
    Q += ex * L * k;
    out += ex * L;
    part += ex * k * gridDim.x;
  }
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

template <class Row, typename TQ>
cudaError_t launch_rows(const Row& row, const TQ* Q, int k, long long L,
                        long long rows_per_block, int grid, int batch,
                        float* out, float* part, cudaStream_t stream) {
  auto kernel = batch == 1 ? rows_kernel<Row, TQ, false>
                           : rows_kernel<Row, TQ, true>;
  const size_t smem = (size_t)k * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(grid, batch), kThreads, smem, stream>>>(
      row, Q, k, L, rows_per_block, out, part);
  return cudaGetLastError();
}

template <typename TA, int V, typename TQ>
cudaError_t mv_qtv(const void* A, const float* p, const float* y,
                   const float* alpha, const void* Q, long long m,
                   long long n, int k, long long rows_per_block, int grid,
                   int batch, float* u, float* part, float* c,
                   cudaStream_t stream) {
  if (batch < 1 || batch > kMaxBatch) return cudaErrorInvalidValue;
  const MvRow<TA, V> row{static_cast<const TA*>(A), p, y, alpha, n};
  const cudaError_t e = launch_rows<MvRow<TA, V>, TQ>(
      row, static_cast<const TQ*>(Q), k, m, rows_per_block, grid, batch, u,
      part, stream);
  if (e != cudaSuccess) return e;
  return finish(part, grid, k, c, stream, batch);
}

// 16-byte loads where n % V == 0 and A and p are aligned: then every
// stacked example's row and p are too (an example is m * n elements of A
// and n of p past the previous one), so all examples take the same path.
template <typename TA, typename TQ>
cudaError_t mv_qtv_vec(const void* A, const float* p, const float* y,
                       const float* alpha, const void* Q, long long m,
                       long long n, int k, long long rows_per_block, int grid,
                       int batch, float* u, float* part, float* c,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TA);  // elements of A in 16 bytes
  if (n % V == 0 && aligned16(A) && aligned16(p))
    return mv_qtv<TA, V, TQ>(A, p, y, alpha, Q, m, n, k, rows_per_block,
                             grid, batch, u, part, c, stream);
  return mv_qtv<TA, 1, TQ>(A, p, y, alpha, Q, m, n, k, rows_per_block, grid,
                           batch, u, part, c, stream);
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
// --- A^T q: column tiles x row chunks, one wave of blocks ----------------
//
// The plan (cols, rows, chunks) comes from the wrapper's rmv_plan.  A
// block's kThreads threads form G = kThreads / cols row groups of `cols`
// threads, and a column tile is cols x V columns (the V elements of A in
// 16 bytes): 256 threads, one group, wherever n fills them; narrower
// groups, each on its own rows, where n does not.  Block b takes tile
// b % tiles over the rows [c*rows, (c+1)*rows) of chunk c = b / tiles:
// every tile is cut at the same rows, so the blocks of a chunk read the
// same rows of A together.  In its rows, group g takes i0 + g, i0 + g + G,
// ..., and the block adds its groups' sums by a fixed tree into slot b of
// the wrapper's vpart (tiles x chunks slots of a tile's columns).

constexpr int kRmvBlocksPerSm = 4;   // 4 x 256 threads: <= 64 registers
constexpr int kRmvMaxBlocks = kSms * kRmvBlocksPerSm;
constexpr int kRmvRows = 8;          // rows of 16-byte loads in flight

// 16 bytes of A as its V elements, widened to float as ld() widens each.
template <typename TA>
struct Vec16;
template <>
struct Vec16<float> {
  using Raw = float4;
  static constexpr int V = 4;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[V]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int V = 8;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[V]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 t = __bfloat1622float2(h[e]);
      f[2 * e] = t.x;
      f[2 * e + 1] = t.y;
    }
  }
};
template <>
struct Vec16<double> {
  using Raw = double2;
  static constexpr int V = 2;
  static __device__ __forceinline__ void widen(const Raw& r, float (&f)[V]) {
    f[0] = __double2float_rn(r.x);
    f[1] = __double2float_rn(r.y);
  }
};

// acc[e] += A[i, j0 + e] q_i for rows i = i0, i0 + G, ... < i1, in row
// order: V adjacent columns, 16-byte loads (n % V == 0, A 16-byte
// aligned), kRmvRows rows in flight.
template <typename TA>
__device__ __forceinline__ void rows_vec(const TA* __restrict__ A,
                                         const float* __restrict__ q,
                                         long long n, long long j0,
                                         long long i0, long long i1, int G,
                                         float (&acc)[Vec16<TA>::V]) {
  using W = Vec16<TA>;
  using Raw = typename W::Raw;
  if (j0 >= n) return;
  const long long step = n / W::V * G;  // Raw elements from row to row
  const Raw* a = reinterpret_cast<const Raw*>(A + i0 * n + j0);
  long long i = i0;
  for (; i + (kRmvRows - 1) * G < i1; i += kRmvRows * G) {
    Raw r[kRmvRows];
    float qq[kRmvRows];
#pragma unroll
    for (int u = 0; u < kRmvRows; ++u) {
      r[u] = a[u * step];
      qq[u] = q[i + u * G];
    }
#pragma unroll
    for (int u = 0; u < kRmvRows; ++u) {
      float f[W::V];
      W::widen(r[u], f);
#pragma unroll
      for (int e = 0; e < W::V; ++e) acc[e] = fmaf(f[e], qq[u], acc[e]);
    }
    a += kRmvRows * step;
  }
  for (; i < i1; i += G, a += step) {
    float f[W::V];
    W::widen(*a, f);
    const float qi = q[i];
#pragma unroll
    for (int e = 0; e < W::V; ++e) acc[e] = fmaf(f[e], qi, acc[e]);
  }
}

// The same with element loads: columns j0 + e * cols (coalesced across the
// group), 16 values of A in flight (32 spill at 64 registers).
template <typename TA>
__device__ __forceinline__ void rows_scalar(const TA* __restrict__ A,
                                            const float* __restrict__ q,
                                            long long n, long long j0,
                                            int cols, long long i0,
                                            long long i1, int G,
                                            float (&acc)[Vec16<TA>::V]) {
  constexpr int V = Vec16<TA>::V;
  constexpr int R = 16 / (V * (sizeof(TA) == 8 ? 2 : 1));  // rows in flight
  bool ok[V];
#pragma unroll
  for (int e = 0; e < V; ++e) ok[e] = j0 + (long long)e * cols < n;
  if (!ok[0]) return;
  const long long step = n * G;
  const TA* a = A + i0 * n + j0;
  long long i = i0;
  for (; i + (R - 1) * G < i1; i += R * G) {
    float f[R][V], qq[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      qq[u] = q[i + u * G];
#pragma unroll
      for (int e = 0; e < V; ++e)
        f[u][e] = ok[e] ? ld(a + u * step + e * cols) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (ok[e]) acc[e] = fmaf(f[u][e], qq[u], acc[e]);
    a += R * step;
  }
  for (; i < i1; i += G, a += step) {
    const float qi = q[i];
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (ok[e]) acc[e] = fmaf(ld(a + e * cols), qi, acc[e]);
  }
}

// vpart[b * TC + col] = sum of A[i, col of tile t] q_i over the rows of
// chunk c, for block b = c * tiles + t (TC = cols * V columns a tile), of
// stacked example blockIdx.y (A, q and vpart moved to it first).
template <typename TA, bool VEC>
__global__ void __launch_bounds__(kThreads, kRmvBlocksPerSm)
    rmv_partial_kernel(const TA* __restrict__ A, const float* __restrict__ q,
                       long long m, long long n, int cols, long long rows,
                       float* __restrict__ vpart) {
  constexpr int V = Vec16<TA>::V;
  __shared__ float red[kThreads * V];  // the groups' sums, group by group
  const int G = kThreads / cols;
  const int g = threadIdx.x / cols, l = threadIdx.x - g * cols;
  const long long TC = (long long)cols * V;
  const long long ex = blockIdx.y;
  A += ex * m * n;
  q += ex * m;
  vpart += ex * gridDim.x * TC;
  const long long tiles = (n + TC - 1) / TC;
  const long long t = blockIdx.x % tiles, c = blockIdx.x / tiles;
  const long long i0 = c * rows + g, i1 = min((c + 1) * rows, m);
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (VEC)
    rows_vec<TA>(A, q, n, t * TC + l * V, i0, i1, G, acc);
  else
    rows_scalar<TA>(A, q, n, t * TC + l, cols, i0, i1, G, acc);
  // column e of this thread in the tile
  const int c0 = VEC ? l * V : l, dc = VEC ? 1 : cols;
  if (G > 1) {  // group g's sums to red[g], then a fixed tree into red[0]
    float* mine = red + g * TC;
#pragma unroll
    for (int e = 0; e < V; ++e) mine[c0 + e * dc] = acc[e];
    for (int s = G / 2; s > 0; s >>= 1) {
      __syncthreads();
      if (g < s) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          mine[c0 + e * dc] += mine[s * TC + c0 + e * dc];
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = mine[c0 + e * dc];
  }
  if (g == 0) {
    float* out = vpart + blockIdx.x * TC;
#pragma unroll
    for (int e = 0; e < V; ++e) out[c0 + e * dc] = acc[e];
  }
}

// v_j = (sum over the chunks of their slot's column j) - beta y_j, where
// chunk k's column j sits at vpart[k * width + j] (width = tiles x the
// tile's columns).  The order of the sum is fixed by `ways` (a power of
// two, as many as there are chunks, at most kThreads): residue r < ways
// adds chunks r, r + ways, ... in turn from 0, then a halving tree adds
// the residues (at h = ways/2, ..., 1, residue r < h adds residue r + h).
// Lanes take adjacent columns whatever the chunk count, so every load is
// a coalesced 128 bytes a warp: the residues of a column split over
// sub = min(ways, kWarps) warps, warp rc holding the L = ways / sub
// residues rc, rc + sub, ... in registers.  The tree's levels h >= sub
// add residues of one warp (s[i] += s[i + h / sub]), its levels h < sub
// add across warps in shared memory: the same sums in the same order, so
// every column's bits.  A lane issues all its loads of a round at once: a
// residue past the last chunk reads the last chunk's value and drops it,
// a column past n reads column n - 1's.  A block holds kWarps / sub
// groups of 32 columns; blockIdx.y is the stacked example.

// s[i] += s[i + E] for i < E, then the same for E / 2, ..., 1: the
// halving tree over s[0 : 2E], every index known when it compiles, so s
// stays in registers.
template <int E>
__device__ __forceinline__ void halve(float* s) {
  if constexpr (E > 0) {
#pragma unroll
    for (int i = 0; i < E; ++i) s[i] += s[i + E];
    halve<E / 2>(s);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    rmv_finish_kernel(const float* __restrict__ vpart, long long n,
                      long long width, long long chunks, int ways,
                      const float* __restrict__ y,
                      const float* __restrict__ beta, float* __restrict__ v) {
  __shared__ float part[kThreads];
  const long long ex = blockIdx.y;
  vpart += ex * chunks * width;
  y += ex * n;
  beta += ex;
  v += ex * n;
  const int sub = ways / L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = warp / sub, rc = warp - cg * sub;
  const long long j =
      ((long long)blockIdx.x * (kWarps / sub) + cg) * 32 + lane;
  const float* col = vpart + (j < n ? j : n - 1);
  // chunks x width = tiles x chunks x the tile's columns < 2^31 wherever
  // there is more than one chunk (rmatvec's limits): 32-bit offsets
  const int w = chunks > 1 ? (int)width : 0;
  float s[L];
#pragma unroll
  for (int i = 0; i < L; ++i) s[i] = 0.f;
  for (long long k0 = 0; k0 < chunks; k0 += ways) {
    float x[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const long long k = k0 + rc + (long long)sub * i;
      x[i] = col[(int)(k < chunks ? k : chunks - 1) * w];
    }
#pragma unroll
    for (int i = 0; i < L; ++i)
      if (k0 + rc + (long long)sub * i < chunks) s[i] += x[i];
  }
  halve<L / 2>(s);
  part[threadIdx.x] = s[0];
  for (int h = sub / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (rc < h) part[threadIdx.x] += part[threadIdx.x + h * 32];
  }
  if (rc == 0 && j < n) v[j] = part[threadIdx.x] - beta[0] * y[j];
}

template <int L>
cudaError_t launch_rmv_finish(const float* vpart, long long n,
                              long long width, long long chunks, int ways,
                              const float* y, const float* beta, float* v,
                              cudaStream_t stream, int batch) {
  const long long cols = 32LL * (kWarps / (ways / L));  // a block's columns
  rmv_finish_kernel<L><<<dim3((unsigned)((n + cols - 1) / cols), batch),
                         kThreads, 0, stream>>>(vpart, n, width, chunks,
                                                ways, y, beta, v);
  return cudaGetLastError();
}

// v = A^T q - beta y, for `batch` stacked examples (vpart holds each
// example's tiles x chunks slots after the previous one's).  A plan with
// row groups of a width other than a power of two up to kThreads, with a
// chunk that owns no row or chunks that do not cover the rows, or with
// more than one chunk and more blocks than kRmvMaxBlocks, is refused
// before a launch.
template <typename TA>
cudaError_t rmatvec(const void* A, const float* q, const float* y,
                    const float* beta, long long m, long long n, int cols,
                    long long rows, long long chunks, float* vpart, float* v,
                    cudaStream_t stream, int batch = 1) {
  constexpr int V = Vec16<TA>::V;
  if (batch < 1 || batch > kMaxBatch || m < 1 || n < 1 || rows < 1 ||
      chunks < 1 || cols < 1 ||
      cols > kThreads || (cols & (cols - 1)) != 0 ||
      (chunks - 1) * rows >= m || chunks * rows < m)
    return cudaErrorInvalidValue;
  const long long TC = (long long)cols * V;
  const long long tiles = (n + TC - 1) / TC, grid = tiles * chunks;
  if ((chunks > 1 && grid > kRmvMaxBlocks) || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const TA* a = static_cast<const TA*>(A);
  const dim3 blocks((unsigned)grid, batch);
  if (n % V == 0 && aligned16(A))  // then every stacked example is aligned
    rmv_partial_kernel<TA, true><<<blocks, kThreads, 0, stream>>>(
        a, q, m, n, cols, rows, vpart);
  else
    rmv_partial_kernel<TA, false><<<blocks, kThreads, 0, stream>>>(
        a, q, m, n, cols, rows, vpart);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  int ways = 1;
  while (ways < kThreads && ways < chunks) ways *= 2;
  switch (ways <= kWarps ? 1 : ways / kWarps) {
    case 1: return launch_rmv_finish<1>(vpart, n, tiles * TC, chunks, ways,
                                        y, beta, v, stream, batch);
    case 2: return launch_rmv_finish<2>(vpart, n, tiles * TC, chunks, ways,
                                        y, beta, v, stream, batch);
    case 4: return launch_rmv_finish<4>(vpart, n, tiles * TC, chunks, ways,
                                        y, beta, v, stream, batch);
    case 8: return launch_rmv_finish<8>(vpart, n, tiles * TC, chunks, ways,
                                        y, beta, v, stream, batch);
    case 16: return launch_rmv_finish<16>(vpart, n, tiles * TC, chunks, ways,
                                          y, beta, v, stream, batch);
    default: return launch_rmv_finish<32>(vpart, n, tiles * TC, chunks,
                                          ways, y, beta, v, stream, batch);
  }
}

// (v, c) = (A^T q - beta y, P^T v): rmatvec, then the staged-tile c' = P^T v
// with proj_plan's (tile_rows, pgrid, stages, flags) for P.
template <typename TA, typename TP>
cudaError_t rmv_qtv(const void* A, const float* q, const float* y,
                    const float* beta, const void* P, long long m,
                    long long n, int k, int cols, long long rows,
                    long long chunks, float* vpart, int tile_rows, int pgrid,
                    int stages, int flags, int batch, float* v, float* part,
                    float* c, cudaStream_t stream) {
  const cudaError_t e = rmatvec<TA>(A, q, y, beta, m, n, cols, rows,
                                    chunks, vpart, v, stream, batch);
  if (e != cudaSuccess || k == 0) return e;
  return proj<TP, kQtv>(v, P, nullptr, n, k, tile_rows, pgrid, stages, flags,
                        nullptr, part, c, stream, batch);
}

}  // namespace

extern "C" {

const char* gk_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int gk_mv_qtv(const void* A, int a_bf16, const float* p, const float* y,
              const float* alpha, const void* Q, int q_bf16, long long m,
              long long n, int k, long long rows_per_block, int grid,
              int batch, float* u, float* part, float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (a_bf16)
    e = q_bf16 ? mv_qtv_vec<bf, bf>(A, p, y, alpha, Q, m, n, k,
                                    rows_per_block, grid, batch, u, part, c,
                                    s)
               : mv_qtv_vec<bf, float>(A, p, y, alpha, Q, m, n, k,
                                       rows_per_block, grid, batch, u, part,
                                       c, s);
  else
    e = q_bf16 ? mv_qtv_vec<float, bf>(A, p, y, alpha, Q, m, n, k,
                                       rows_per_block, grid, batch, u, part,
                                       c, s)
               : mv_qtv_vec<float, float>(A, p, y, alpha, Q, m, n, k,
                                          rows_per_block, grid, batch, u,
                                          part, c, s);
  return (int)e;
}

int gk_rmv_qtv(const void* A, int a_bf16, const float* q, const float* y,
               const float* beta, const void* P, int p_bf16, long long m,
               long long n, int k, int cols, long long rows, long long chunks,
               float* vpart, int tile_rows, int pgrid, int stages, int flags,
               int batch, float* v, float* part, float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  cudaError_t e;
  if (a_bf16)
    e = p_bf16 ? rmv_qtv<bf, bf>(A, q, y, beta, P, m, n, k, cols, rows,
                                 chunks, vpart, tile_rows, pgrid, stages,
                                 flags, batch, v, part, c, s)
               : rmv_qtv<bf, float>(A, q, y, beta, P, m, n, k, cols, rows,
                                    chunks, vpart, tile_rows, pgrid, stages,
                                    flags, batch, v, part, c, s);
  else
    e = p_bf16 ? rmv_qtv<float, bf>(A, q, y, beta, P, m, n, k, cols, rows,
                                    chunks, vpart, tile_rows, pgrid, stages,
                                    flags, batch, v, part, c, s)
               : rmv_qtv<float, float>(A, q, y, beta, P, m, n, k, cols, rows,
                                       chunks, vpart, tile_rows, pgrid,
                                       stages, flags, batch, v, part, c, s);
  return (int)e;
}

int gk_proj_qtv(const float* u, const void* Q, int q_bf16, const float* c_in,
                long long L, int k, int tile_rows, int grid, int stages,
                int flags, int batch, float* w, float* part, float* c_out,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, kProjQtv>(
                            u, Q, c_in, L, k, tile_rows, grid, stages, flags,
                            w, part, c_out, s, batch)
                      : proj<float, kProjQtv>(u, Q, c_in, L, k, tile_rows,
                                              grid, stages, flags, w, part,
                                              c_out, s, batch));
}

int gk_proj_norm(const float* u, const void* Q, int q_bf16,
                 const float* c_in, long long L, int k, int tile_rows,
                 int grid, int stages, int flags, int batch, float* v,
                 float* part, float* nrm2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, kProjNorm>(
                            u, Q, c_in, L, k, tile_rows, grid, stages, flags,
                            v, part, nrm2, s, batch)
                      : proj<float, kProjNorm>(u, Q, c_in, L, k, tile_rows,
                                               grid, stages, flags, v, part,
                                               nrm2, s, batch));
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
                     long long n, int cols, long long rows, long long chunks,
                     float* vpart, float* v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_kind == 1)
    e = rmatvec<__nv_bfloat16>(A, q, y, beta, m, n, cols, rows, chunks,
                               vpart, v, s);
  else if (a_kind == 2)
    e = rmatvec<double>(A, q, y, beta, m, n, cols, rows, chunks, vpart, v,
                        s);
  else
    e = rmatvec<float>(A, q, y, beta, m, n, cols, rows, chunks, vpart, v,
                       s);
  return (int)e;
}

}  // extern "C"
