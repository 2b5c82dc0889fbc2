// Products with a tall basis Q (L, k) over flat tiles of whole rows staged
// in shared memory (gk_step.cu and reorth.cu).  One template serves four
// functions, each an epilogue of the same staged tile:
//
//   kProjQtv   w = u - Q c ; c' = Q^T w   gk_proj_qtv
//   kProjNorm  w = u - Q c ; ||w||^2      gk_proj_norm
//   kSubtract  w = u - Q c                reorth_subtract_qc
//   kQtv       c' = Q^T u                 reorth_qtv, and gk_rmv_qtv's
//                                         c = P^T v
//
// What bounds them.  Each does one or two multiply-adds per element of Q
// and reads Q once from device memory, so each is bound by the bytes of Q
// (80 MB at the dense cell's 1e5 x 201 f32 Q, 386 MB at the sparse cell's
// 480,189 x 201 Lanczos basis).  What holds such a stream back is bytes in
// flight and arithmetic that does not overlap them.  Rows of odd width
// are never 16-byte aligned, so the kernel does not load row by row: a
// tile of rows is one contiguous run of the array, copied into shared
// memory in aligned 16-byte cp.async chunks (the ends of the array element
// by element), two stages deep, so the next tile's copy is in flight
// while this one is used.  Each staged element is read once from shared
// memory: up to 256 columns a warp takes a row with lanes along it, c in
// registers, and the same loaded values give the row's dot product, w_r,
// and (with w_r) the warp's running column sums of c'.  Wider bases keep
// c in shared memory where it fits beside the stages, else read it
// through the read-only cache, and add each tile's share of c' in place
// in the block's partials in device memory.  Block b walks tiles b, b+G,
// ... of a fixed grid G (<= 264), so the finishing launch sums G
// partials, not one per row block; the order of every sum is fixed by
// the plan, so the same inputs give the same bits on every run.
//
// The plan (tile rows, grid, stages, flags) comes from the wrappers'
// proj_plan (repro_torch/kernels/gk_step.py); proj() refuses a plan past
// this file's limits before a launch.
//
// Stacked inputs.  proj() also takes `batch` examples of one shape, laid
// out one after another (u (B, L), Q (B, L, k), c (B, k), ...): one launch
// of proj_stacked_kernel, whose grid's y dimension walks the examples,
// and each block moves its pointers to its example (64-bit offsets)
// before it runs proj_kernel's body.  Every example then runs the single
// launch's plan on its own rows, partials and finishing sums, so its
// outputs have that launch's bits; a batch of 1 is proj_kernel itself.
// What bounds a stacked call at the batched solve's shapes (8 x 8192 x
// 101 and 8 x 4096 x 100 f32, one tile a block: 1,176 and 592 blocks of
// 56 rows) is less the bytes than each block's chain: the copy of its
// tile, then its warps' passes over the rows, with the SM's issue slots
// shared by the 4 blocks it holds, so the instructions a row costs set
// the pace.  So the register path takes only as many slots a lane as the
// basis has columns (S = 4 up to 128 columns, else the 8 it holds), in
// every launch: the same products in the same order, then one +0 add
// for the slots left out (see project_tile_regs), so S changes no bit.
// Every call's finishing sums run a warp an output (finish_warps_kernel),
// in finish_kernel's order, with no barrier.  A persistent walk of
// (example, block) items, with one ring across a block's items and the
// finishing sums folded into the launch behind a per-example count,
// measured slower at every batch (PERF.md, Findings).

#pragma once

#include "gk_rows.cuh"  // ld, warp_sum, kThreads, kWarps

namespace {

// out[e] = sum of part[e*G : (e+1)*G], summed in a fixed order, for
// e = (example) * count + (output): each example's count outputs follow
// the previous example's.  Stage 1's finish (gk_step.cu), whose grids
// are wider than a projection plan's.
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const float* __restrict__ part, int G,
                  float* __restrict__ out) {
  __shared__ float s[kThreads];
  const long long e = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const float* row = part + e * G;
  float acc = 0.f;
  for (int b = threadIdx.x; b < G; b += kThreads) acc += row[b];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = s[0];
}

constexpr int kProjBlocks = 264;     // grid cap: two blocks on each of 132 SMs
static_assert(kProjBlocks <= 2 * kThreads, "a thread of finish_kernel adds "
                                           "at most two partials");

// finish_kernel's sums of a projection plan's G <= kProjBlocks partials,
// a warp an output (e < n), in two passes (G > kThreads takes the
// second): thread t of finish_kernel's block is lane t % 32's register
// t / 32, so the tree's levels 128, 64 and 32 add registers and 16 to 1
// shuffle down, the same operands in the same order.  Every load is in
// straight-line code at a clamped address, all in flight at once; a
// partial past G adds +0, which leaves a sum that starts from +0 (never
// -0) as finish_kernel's skip leaves it.  No barrier and 1/8 of
// finish_kernel's blocks.
__global__ void __launch_bounds__(kThreads)
    finish_warps_kernel(const float* __restrict__ part, int G, long long n,
                        float* __restrict__ out) {
  constexpr int R = kThreads / 32;  // finish_kernel's slots a lane holds
  const long long e = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= n) return;  // a whole warp
  const int lane = threadIdx.x & 31;
  const float* row = part + e * G;
  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int t = lane + 32 * i;
    const float x = row[min(t, G - 1)];
    v[i] = 0.f + (t < G ? x : 0.f);
  }
  if (G > kThreads) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int t = lane + 32 * i + kThreads;
      const float x = row[min(t, G - 1)];
      v[i] += t < G ? x : 0.f;
    }
  }
#pragma unroll
  for (int h = R / 2; h > 0; h >>= 1)
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] += v[i + h];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v[0] += __shfl_down_sync(0xffffffffu, v[0], o);
  if (lane == 0) out[e] = v[0];
}

cudaError_t finish(const float* part, int G, int count, float* out,
                   cudaStream_t stream, int batch = 1) {
  if (count == 0) return cudaSuccess;
  finish_kernel<<<dim3(count, batch), kThreads, 0, stream>>>(part, G, out);
  return cudaGetLastError();
}

// What a staged tile gives (see the top of this file).
enum ProjMode { kProjQtv, kProjNorm, kSubtract, kQtv };

template <int MODE>
struct Epilogue {
  static constexpr bool kDot = MODE != kQtv;  // w = u - Q c
  static constexpr bool kCols = MODE == kProjQtv || MODE == kQtv;  // Q^T w
  static constexpr bool kNorm = MODE == kProjNorm;
};

// --- flat tiles staged in shared memory ------------------------------------
//
// A tile is `rows` consecutive rows of the basis, one contiguous run of
// rows*k elements of the row-major array whatever k's parity.  A stage of
// shared memory holds the tile's slice of u (4-byte cp.async copies), then
// the run, copied in 16-byte cp.async chunks.  The chunks are aligned in
// device memory, so the run starts (g0 & 15) bytes into its buffer; a
// chunk at a tile's edge also carries bytes of the neighbouring tile,
// which this tile ignores.  Only at the two ends of the array does an
// aligned chunk reach outside it: there the elements are copied one by one.

constexpr int kMaxTileRows = 512;
constexpr int kMaxK = 49152;         // the wrappers' MAX_K
constexpr long long kSmemLimit = 232448 - 256;  // 227 KB a block can have,
                                                // less room for red[]
constexpr int kMaxStages = 2;
constexpr int kCShared = 1;          // plan flag: c in shared memory
constexpr int kMaxBatch = 65535;     // stacked examples: the grid's y limit
// proj_stacked_kernel's register bound, and proj_kernel's past the
// register path, <= 64 a thread: 4 blocks of kThreads an SM, as many as
// the f32 stages' shared memory allows (the grid holds 2).  Under the
// default bound ptxas stops at 48 registers, and the examples' offsets,
// or proj_qtv's column sums past 256 columns, then spill.
constexpr int kProjBlocksPerSm = 4;

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

// The epilogue over a staged tile, k > 32 * kRegCols: w = u - Q c (a warp
// per row, lanes along it), then the tile's share of c' = Q^T w into
// acc[j * gridDim.x] (threads own columns and walk the tile's rows) or of
// ||w||^2 into nrm (lane 0 of each warp).  Reads the tile from shared
// memory only.
template <typename TQ, int MODE>
__device__ void project_tile(char* stage, const ProjTile<TQ>& tile, int k,
                             const float* cc, float* acc,
                             float* __restrict__ w, float& nrm) {
  using E = Epilogue<MODE>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* su = reinterpret_cast<float*>(stage);  // u in, w out
  const TQ* q = tile.run(stage);
  if (E::kDot) {
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
        if (E::kNorm) nrm = fmaf(wr, wr, nrm);
      }
    }
  }
  if (E::kCols) {
    if (E::kDot) __syncthreads();  // every w_r of the tile is in su
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

template <typename TQ, int MODE, int S>
__device__ void project_tile_regs(const char* stage, const ProjTile<TQ>& tile,
                                  int k, const float (&cr)[kRegCols],
                                  float (&ar)[kRegCols],
                                  float* __restrict__ w, float& nrm) {
  using E = Epilogue<MODE>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* su = reinterpret_cast<const float*>(stage);
  const TQ* q = tile.run(stage);
  for (int r = warp; r < tile.rows; r += kWarps) {
    const TQ* qr = q + (long long)r * k;
    float qv[kRegCols];
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      const int j = lane + 32 * t;
      qv[t] = j < k ? ld(qr + j) : 0.f;
      if (E::kDot) dot = fmaf(qv[t], cr[t], dot);
    }
    // The 8-slot chain's slots S..7 hold +0 in qv and cr, and each adds
    // fmaf(+0, +0, dot) = dot + (+0): one such add gives their bits.  It
    // turns a -0 dot (a product below the least subnormal rounds to -0)
    // into +0, and changes nothing else; __fadd_rn is never folded away.
    if (E::kDot && S < kRegCols) dot = __fadd_rn(dot, 0.f);
    const float wr = E::kDot ? su[r] - warp_sum(dot) : su[r];
    if (E::kCols) {  // the columns from 32 S on are never stored
#pragma unroll
      for (int t = 0; t < S; ++t) ar[t] = fmaf(qv[t], wr, ar[t]);
    }
    if (E::kDot && lane == 0) {
      w[tile.r0 + r] = wr;
      if (E::kNorm) nrm = fmaf(wr, wr, nrm);
    }
  }
}

// Block b walks tiles b, b + G, b + 2G, ... (G = gridDim.x) through a ring
// of `stages` buffers (2, or 1 where two do not fit): the next tile's copy
// is in flight while this one is used.  Its partial goes to part[j * G +
// b] (c', k of them) or part[b] (||w||^2); finish_kernel sums the G
// partials in a fixed order.  REGS (k <= 256): c and the column sums in
// registers.  Otherwise c sits in shared memory where the plan's flag puts
// it, and the column sums accumulate in place in part.
template <typename TQ, int MODE, bool REGS, int S>
__device__ __forceinline__ void proj_block(
    const float* __restrict__ u, const TQ* __restrict__ Q,
    const float* __restrict__ c_in, long long L, int k, int tile_rows,
    long long tiles, int stages, int flags, float* __restrict__ w,
    float* __restrict__ part) {
  using E = Epilogue<MODE>;
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
      cr[t] = E::kDot && j < k ? c_in[j] : 0.f;
      ar[t] = 0.f;
    }
  } else {
    if (E::kDot && (flags & kCShared)) {
      float* sc = reinterpret_cast<float*>(smem + sbytes * stages);
      for (int j = threadIdx.x; j < k; j += kThreads) sc[j] = c_in[j];
      cc = sc;
    }
    if (E::kCols)  // each thread zeroes, and later adds to, its own columns
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
      project_tile_regs<TQ, MODE, S>(stage, tile, k, cr, ar, w, nrm);
    else
      project_tile<TQ, MODE>(stage, tile, k, cc, acc, w, nrm);
    __syncthreads();  // the stage is refilled next
  }
  if (E::kNorm) {
    if (lane == 0) red[warp] = nrm;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int i = 0; i < kWarps; ++i) s += red[i];
      part[blockIdx.x] = s;
    }
  } else if (E::kCols && REGS) {  // the warps' column sums, through the
    float* sums = reinterpret_cast<float*>(smem);  // idle stages: kWarps x k
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

// S register slots a lane where the register path runs (REGS).  Past it
// the bound is kProjBlocksPerSm; on it 0 sets none, as ever.
template <typename TQ, int MODE, bool REGS, int S>
__global__ void __launch_bounds__(kThreads, REGS ? 0 : kProjBlocksPerSm)
    proj_kernel(const float* __restrict__ u, const TQ* __restrict__ Q,
                const float* __restrict__ c_in, long long L, int k,
                int tile_rows, long long tiles, int stages, int flags,
                float* __restrict__ w, float* __restrict__ part) {
  proj_block<TQ, MODE, REGS, S>(u, Q, c_in, L, k, tile_rows, tiles, stages,
                                flags, w, part);
}

// proj_kernel over stacked examples: blockIdx.y is the example.
template <typename TQ, int MODE, bool REGS, int S>
__global__ void __launch_bounds__(kThreads, kProjBlocksPerSm)
    proj_stacked_kernel(const float* __restrict__ u,
                        const TQ* __restrict__ Q,
                        const float* __restrict__ c_in, long long L, int k,
                        int tile_rows, long long tiles, int stages,
                        int flags, float* __restrict__ w,
                        float* __restrict__ part) {
  using E = Epilogue<MODE>;
  const long long ex = blockIdx.y;
  proj_block<TQ, MODE, REGS, S>(
      u + ex * L, Q + ex * L * k, E::kDot ? c_in + ex * k : c_in, L, k,
      tile_rows, tiles, stages, flags, E::kDot ? w + ex * L : w,
      MODE == kSubtract ? part
                        : part + ex * (E::kNorm ? 1LL : k) * gridDim.x);
}

template <typename TQ, int MODE, bool REGS, int S>
cudaError_t launch_proj(const float* u, const void* Q, const float* c_in,
                        long long L, int k, int tile_rows, long long tiles,
                        int grid, int stages, int flags, long long smem,
                        float* w, float* part, cudaStream_t stream,
                        int batch) {
  auto kernel = batch == 1 ? proj_kernel<TQ, MODE, REGS, S>
                           : proj_stacked_kernel<TQ, MODE, REGS, S>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(grid, batch), kThreads, smem, stream>>>(
      u, static_cast<const TQ*>(Q), c_in, L, k, tile_rows, tiles, stages,
      flags, w, part);
  return cudaGetLastError();
}

// One call of a mode over `batch` stacked examples: the staged-tile
// kernel, then (c' or ||w||^2) the finishing launch into out.  The plan
// comes from the wrapper's proj_plan; anything outside this file's limits
// is refused before a launch.  part holds grid (||w||^2) or k * grid (c')
// floats an example; w and part go unused where the mode has no such
// output.
template <typename TQ, int MODE>
cudaError_t proj(const float* u, const void* Q, const float* c_in,
                 long long L, int k, int tile_rows, int grid, int stages,
                 int flags, float* w, float* part, float* out,
                 cudaStream_t stream, int batch = 1) {
  using E = Epilogue<MODE>;
  if (batch < 1 || batch > kMaxBatch || L < 1 || k < 0 || k > kMaxK ||
      tile_rows < 1 ||
      tile_rows > kMaxTileRows || grid < 1 || grid > kProjBlocks ||
      stages < 1 || stages > kMaxStages || (flags & ~kCShared) != 0)
    return cudaErrorInvalidValue;
  const long long tiles = (L + tile_rows - 1) / tile_rows;
  const long long smem =
      proj_smem(tile_rows, k, sizeof(TQ), stages, flags);
  const bool regs = k <= 32 * kRegCols;
  // the register path sums its warps' columns in the stages at the end
  const long long sums = regs && E::kCols ? 4LL * kWarps * k : 0;
  if (grid > tiles || smem > kSmemLimit ||
      stage_bytes(tile_rows, k, sizeof(TQ)) * stages < sums)
    return cudaErrorInvalidValue;

  // the register path takes 4 slots a lane up to 128 columns, else 8
  const cudaError_t e =
      !regs ? launch_proj<TQ, MODE, false, kRegCols>(
                  u, Q, c_in, L, k, tile_rows, tiles, grid, stages, flags,
                  smem, w, part, stream, batch)
      : k <= 32 * 4 ? launch_proj<TQ, MODE, true, 4>(
                          u, Q, c_in, L, k, tile_rows, tiles, grid, stages,
                          flags, smem, w, part, stream, batch)
                    : launch_proj<TQ, MODE, true, kRegCols>(
                          u, Q, c_in, L, k, tile_rows, tiles, grid, stages,
                          flags, smem, w, part, stream, batch);
  if (e != cudaSuccess || MODE == kSubtract) return e;
  const long long n = (long long)(E::kNorm ? 1 : k) * batch;
  if (n == 0) return cudaSuccess;
  finish_warps_kernel<<<(unsigned)((n + kWarps - 1) / kWarps), kThreads, 0,
                        stream>>>(part, grid, n, out);
  return cudaGetLastError();
}

}  // namespace
