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
//  * Short rows (L < kLongRow; the forward pack), one vector, and any pack
//    without a window layout or a block wider than kMaxBlockCols: a warp
//    per row (spmv_kernel).  A warp's lanes are CW column lanes times
//    32 / CW slot groups (CW = 1 for one vector, 8 for up to 8 columns, 32
//    above): slot group g takes slots g, g + 32/CW, ..., and column lane c
//    gathers X[cols[i, s], c0 + c], so the CW lanes of a slot read one
//    contiguous segment of an X row.  Columns past 32 go to grid.y.  Long
//    rows without a layout take the same kernel with a whole block of 256
//    threads as the team, a block per row.
//  * Long rows, one vector, through the operator's window layout
//    (window_kernel): x is cut into windows of kWindow f32 (192 KB) that
//    fit shared memory.  The layout (kernels/sparse_matvec.py
//    window_layout, built once per operator) is the pack itself with each
//    row's slots stably reordered by sub-window of kSub rows of x (its
//    padding last), plus a (rows x (windows + 1)) table of where each
//    window's segment starts and, where it is small beside the pack, a
//    (rows x (subs + 1)) table of the same at every sub-window; a window
//    is kWindowSubs sub-windows, so its slots are one contiguous segment
//    of the row, whose edges this kernel reads from the compact window
//    table (the sub-window table, read from device memory at each row,
//    measured slower).  A block owns one
//    window and a range of rows: it stages its window of x in shared
//    memory, then each warp walks one row's segment in that window and
//    gathers from shared memory, never from L2, and writes one partial per
//    (row, window).  One block of 512 threads per SM (grid ~ 132), so the
//    pack is streamed once and x is read from L2 once per row group.  A
//    second launch (sum_windows_kernel) sums a row's partials over the
//    windows in window order.  A warp reads its segment as one flat run:
//    the aligned body in 16-byte loads of 4 columns and 4 values, with a
//    streaming (evict-first) hint, and the unaligned head and tail (< 4
//    slots each) slot by slot.  Each lane loads kUnroll groups, then
//    issues all their 4 * kUnroll gathers before it uses any of them, with
//    one accumulator a group, combined in a fixed order.
//  * Blocks of 2 to kMaxBlockCols columns through the same layout's
//    sub-window table, short rows and long, where the partials below take
//    no more memory than the pack (the wrapper's block_scratch_fits)
//    (block_kernel): a gathered X row of b f32 spans three
//    32-byte sectors of L2 at b = 20, so a block of columns gathered from
//    L2 moves 12 times the pack's bytes there.  Here a block window is
//    `ratio` sub-windows of X's rows times all b columns (at a pitch of b
//    rounded up to 4; ratio * kSub * pitch <= kBlockFloats f32: 200 KB),
//    staged in shared memory; a block owns one window and a range of
//    rows.  A warp sums kSetRows rows at a time, kRowLanes lanes a row,
//    lane l on columns 4l .. 4l + 3: each lane group copies up to kChunk
//    slots of its row's segment into its own buffer (the column stored as
//    its offset in the staged window), then reads them back four at a
//    time in 16-byte broadcasts and gathers its four columns from shared
//    memory in one 16-byte load a slot, so each (row, window, column) is
//    one fmaf chain in slot order.  The segments are short (~25 slots at
//    the Netflix shape): the next kAhead sets' first chunks are in flight
//    in registers while a set is summed, and the set loop is unrolled by
//    kAhead so that no register is copied while its load is pending.  The
//    (row, window, column) partials go to a scratch (windows, m, b);
//    sum_windows_kernel adds them in window order.  Staging costs row
//    groups x |X| of L2 reads, the partials windows x m x b x 8 bytes of
//    device memory, both well under the 12x gather; what bounds the
//    kernel is then shared memory: by count, one wavefront a gathered
//    row-slot.

// Sums are fixed by the pack's shape: a team sums its lanes with a fixed
// xor-shuffle tree and, for a block, the warps' sums in warp order; the
// window paths' partials are summed in window order.  No atomics: the
// same bits on every run, whatever the grid.  The reference pads rows to
// a multiple of 128 and slots to 128 lanes; these kernels mask their
// ragged edges and never pad or copy the pack.  Offsets are 64-bit: m * L
// and n * b may pass 2^31.
//
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int (cudaErrorInvalidValue for a window
// plan outside this file's limits).  v_kind: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), warp_sum, kThreads

namespace {

constexpr int kLongRow = 1024;   // slots at which a row gets a whole block
constexpr int kUnroll = 4;       // 4-slot groups a lane has in flight
constexpr int kSub = 512;        // rows of x in a sub-window of the layout
constexpr int kWindow = 49152;   // f32 of x a window stages: 192 KB
constexpr int kWindowSubs = kWindow / kSub;   // 96
constexpr int kWinThreads = 512;   // 16 warps: up to 128 registers, no
                                   // spills at kUnroll = 4
constexpr int kWinWarps = kWinThreads / 32;
constexpr int kMaxWindowBlocks = 65535;   // gridDim.y limit on windows
constexpr int kBlkThreads = 512;          // block_kernel: 16 warps
constexpr int kBlkWarps = kBlkThreads / 32;
constexpr int kMaxBlockCols = 32;         // 8 lanes x 4 columns
constexpr int kBlockFloats = 51200;       // f32 of X a block window: 200 KB
constexpr int kRowLanes = 8;              // lanes on a row: 4 columns each
constexpr int kSetRows = 32 / kRowLanes;  // rows a warp sums at once
constexpr int kChunk = 40;                // slots of a row staged at a time
constexpr int kSlotsPerLane = kChunk / kRowLanes;
constexpr int kBufPitch = kChunk + 4;     // a row's buffer: the four rows'
                                          // 16-byte reads hit four quads
constexpr int kAhead = 2;                 // sets' first chunks in flight
static_assert(kWindow % kSub == 0, "a window is whole sub-windows");

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

// Row i's segment [off[s0], off[s1]) of an offsets table of `pitch`
// entries a row.
__device__ __forceinline__ int2 segment(const int* __restrict__ offsets,
                                        long long i, int pitch, int s0,
                                        int s1) {
  const int* off = offsets + i * pitch;
  return make_int2(__ldg(off + s0), __ldg(off + s1));
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
  if (i < r1) seg = segment(offsets, i, windows + 1, w, w + 1);
  for (; i < r1; i += kWinWarps) {
    const int2 next = i + kWinWarps < r1
                          ? segment(offsets, i + kWinWarps, windows + 1, w,
                                    w + 1)
                          : make_int2(0, 0);
    const float s = warp_sum(run_dot<TV>(vals, cols, i * L + seg.x,
                                         i * L + seg.y, lane, vec, xs,
                                         (int)c0));
    if (lane == 0) part[(long long)w * m + i] = s;
    seg = next;
  }
}

// Y[e] = sum over w of part[w * count + e], in window order (count = m
// for one vector, m * b for a block); 8 windows' loads in flight.
__global__ void __launch_bounds__(kThreads)
    sum_windows_kernel(const float* __restrict__ part, long long count,
                       int windows, float* __restrict__ Y) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= count) return;
  float t = 0.f;
  for (int w0 = 0; w0 < windows; w0 += 8) {
    float p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (w0 + u < windows)
        p[u] = __ldcs(part + (long long)(w0 + u) * count + e);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (w0 + u < windows) t += p[u];
  }
  Y[e] = t;
}

// --- blocks of columns, by block window: a lane per column --------------

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(double v) {
  return __double2float_rn(v);
}

// A lane's share of one row's chunk of kChunk slots, as loaded: slots
// a + l + 8u, u < kSlotsPerLane, l the lane's place in its row's group
// (values raw, converted when staged, so that no instruction waits on the
// loads before the chunk is used).
template <typename TV>
struct Chunk {
  int c[kSlotsPerLane];
  TV v[kSlotsPerLane];
};

// part[(w * m + i) * b + c] = sum over row i's slots in block window w
// (blockIdx.x) of vals * X[col, c], for the rows [blockIdx.y *
// rows_per_group, +rows_per_group).  The window is X's rows [w * ratio *
// kSub, +ratio * kSub) (sub-windows [w * ratio, +ratio) of the layout),
// staged whole in shared memory at a pitch of bp >= b floats (b rounded up
// to 4).  Warp k walks the rows r0 + 32 * (k + kBlkWarps * q) + j (batch
// q, j = 0..31) kSetRows at a time: lane group g (kRowLanes lanes) sums
// row j + g, lane l of it columns 4l .. 4l + 3 with 16-byte gathers.  The
// next kAhead sets' first chunks are in flight in registers while a set is
// summed; a segment longer than kChunk slots reads its further chunks as
// it goes.  Each lane holds the offsets of its row of the batch being
// walked, of the next and of the one after (loaded a batch ahead).
template <typename TV>
__global__ void __launch_bounds__(kBlkThreads, 1)
    block_kernel(const TV* __restrict__ vals, const int* __restrict__ cols,
                 const int* __restrict__ offsets, long long m, int L,
                 int subs, int ratio, const float* __restrict__ X,
                 long long n, int b, long long rows_per_group,
                 float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const int bp = (b + 3) & ~3;                 // staged pitch of X
  const int w = blockIdx.x;
  const long long x0 = (long long)w * ratio * kSub;
  const long long x1 = min(n, x0 + (long long)ratio * kSub);
  const int wfloats = ratio * kSub * bp;       // a multiple of 4
  float* xs = smem;
  {  // stage X[x0:x1, :] at pitch bp (the pad columns zero)
    const float* src = X + x0 * b;
    const long long len = (x1 - x0) * bp;
    if (bp == b && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(xs);
      for (long long q = threadIdx.x; q < len / 4; q += kBlkThreads)
        d4[q] = __ldg(s4 + q);
    } else {
      for (long long k = threadIdx.x; k < len; k += kBlkThreads) {
        const long long r = k / bp;
        const int c = (int)(k - r * bp);
        xs[k] = c < b ? __ldg(src + r * b + c) : 0.f;
      }
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / kRowLanes, l = lane % kRowLanes;
  const bool live = 4 * l < b;                 // my columns 4l .. 4l + 3
  int* bo = reinterpret_cast<int*>(smem + wfloats) +
            warp * 2 * kSetRows * kBufPitch + g * kBufPitch;
  float* bv = reinterpret_cast<float*>(bo + kSetRows * kBufPitch);
  const long long r0 = (long long)blockIdx.y * rows_per_group;
  const long long r1 = min(m, r0 + rows_per_group);
  const int s0 = w * ratio, s1 = min(subs, s0 + ratio);
  const int xoff = (int)x0;
  if (r0 + 32LL * warp >= r1) return;   // no row for this warp
  // the warp's t-th row, and this lane's row of batch q
  auto row_at = [&](long long t) {
    return r0 + 32 * (warp + (long long)kBlkWarps * (t >> 5)) + (t & 31);
  };
  auto seg_of = [&](long long q) {
    const long long row = row_at(32 * q + lane);
    return row < r1 ? segment(offsets, row, subs + 1, s0, s1)
                    : make_int2(0, 0);
  };
  int2 cur = seg_of(0), nxt = seg_of(1), far = seg_of(2);
  long long beta = 0;     // batch of cur
  // my row's segment in set u (rows kSetRows * u + g of the warp's walk),
  // u's batch beta or beta + 1 (warp-uniform)
  auto seg_at = [&](long long u) {
    const long long t = kSetRows * u;
    const int2 src = (t >> 5) == beta ? cur : nxt;
    const int from = (int)(t & 31) + g;
    return make_int2(__shfl_sync(0xffffffffu, src.x, from),
                     __shfl_sync(0xffffffffu, src.y, from));
  };
  auto load = [&](long long row, int a, int e, Chunk<TV>& ch) {
    const long long base = row * L;
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      const int s = a + l + kRowLanes * u;
      if (s < e) {
        ch.c[u] = __ldg(cols + base + s);
        ch.v[u] = __ldg(vals + base + s);
      }
    }
  };
  auto issue = [&](long long u, Chunk<TV>& ch) {
    if (row_at(kSetRows * u) < r1) {          // the set has a row
      const int2 sg = seg_at(u);
      load(row_at(kSetRows * u + g), sg.x, min(sg.y, sg.x + kChunk), ch);
    }
  };
  auto stage = [&](const Chunk<TV>& ch) {
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      bo[l + kRowLanes * u] = (ch.c[u] - xoff) * bp;
      bv[l + kRowLanes * u] = to_f32(ch.v[u]);
    }
  };
  // acc[0..3] + the first cnt staged slots of my row, my four columns,
  // one chain a column in slot order
  auto sum_staged = [&](int cnt, float (&acc)[4]) {
    const int4* o4 = reinterpret_cast<const int4*>(bo);
    const float4* v4 = reinterpret_cast<const float4*>(bv);
    for (int s = 0; s < cnt; s += 4) {
      const int4 o = o4[s >> 2];
      const float4 v = v4[s >> 2];
      const int oo[4] = {o.x, o.y, o.z, o.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
      float4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (live && s + k < cnt)
          x[k] = *reinterpret_cast<const float4*>(xs + oo[k] + 4 * l);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (live && s + k < cnt) {
          acc[0] = fmaf(vv[k], x[k].x, acc[0]);
          acc[1] = fmaf(vv[k], x[k].y, acc[1]);
          acc[2] = fmaf(vv[k], x[k].z, acc[2]);
          acc[3] = fmaf(vv[k], x[k].w, acc[3]);
        }
    }
  };
  // set u's first chunks live in q[u % kAhead] from their issue, kAhead
  // sets ahead, until they are staged: the set loop is unrolled by kAhead
  // so that no register is copied (a copy would wait for the loads)
  Chunk<TV> q[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
#pragma unroll
    for (int u = 0; u < kSlotsPerLane; ++u) {
      q[k].c[u] = 0;
      q[k].v[u] = TV(0);
    }
    issue(k, q[k]);
  }
  const unsigned group = 0xffu << (kRowLanes * g);
  for (long long u0 = 0;; u0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long u = u0 + k;
      const long long t = kSetRows * u;
      if (row_at(t) >= r1) return;
      if (t > 0 && (t & 31) == 0) {        // into the next batch
        ++beta;
        cur = nxt;
        nxt = far;
        far = seg_of(beta + 2);
      }
      const long long row = row_at(t + g);
      const int2 rs = seg_at(u);
      stage(q[k]);
      issue(u + kAhead, q[k]);
      __syncwarp();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      sum_staged(min(kChunk, rs.y - rs.x), acc);
      for (int a = rs.x + kChunk; a < rs.y; a += kChunk) {   // long rows
        Chunk<TV> ch;
        load(row, a, min(rs.y, a + kChunk), ch);
        __syncwarp(group);
        stage(ch);
        __syncwarp(group);
        sum_staged(min(kChunk, rs.y - a), acc);
      }
      if (live && row < r1) {
        float* y = part + ((long long)w * m + row) * b + 4 * l;
        if ((b & 3) == 0) {
          *reinterpret_cast<float4*>(y) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * l + c < b) y[c] = acc[c];
        }
      }
      __syncwarp();
    }
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

template <typename TV>
cudaError_t blocked(const void* vals, const int* cols, const int* offsets,
                    long long m, int L, int subs, int ratio, int windows,
                    const float* X, long long n, int b,
                    long long rows_per_group, int groups, float* part,
                    float* Y, cudaStream_t stream) {
  const int bp = (b + 3) & ~3;
  const size_t smem = (size_t)ratio * kSub * bp * sizeof(float) +
                      (size_t)kBlkWarps * 2 * kSetRows * kBufPitch * 4;
  cudaError_t e = cudaFuncSetAttribute(
      block_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  block_kernel<TV><<<dim3((unsigned)windows, (unsigned)groups), kBlkThreads,
                     smem, stream>>>(static_cast<const TV*>(vals), cols,
                                     offsets, m, L, subs, ratio, X, n, b,
                                     rows_per_group, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long count = m * b;
  sum_windows_kernel<<<(unsigned)((count + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(part, count, windows, Y);
  return cudaGetLastError();
}

// The plan's limits, shared by both window paths: rows_per_group x groups
// cover the rows once, and `windows` windows of `span` rows of x cover x
// once, with subs sub-windows of kSub rows.
bool plan_fits(long long m, int L, long long n, int subs, long long span,
               int windows, long long rows_per_group, int groups) {
  return m >= 1 && L >= 1 && n >= 1 && windows >= 1 &&
         subs == (n + kSub - 1) / kSub && (windows - 1) * span < n &&
         windows * span >= n && rows_per_group >= 1 && groups >= 1 &&
         groups <= kMaxWindowBlocks && (groups - 1) * rows_per_group < m &&
         groups * rows_per_group >= m;
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

// y = A x through a window layout: vals / cols (m, L) the pack in the
// layout's order, offsets (m, windows + 1) its window table, x (n,), part
// (windows * m) scratch.  The plan (groups of rows_per_group rows) comes
// from the wrapper's window_plan.
int sparse_matvec_windows(const void* vals, int v_kind, const int* cols,
                          const int* offsets, long long m, int L,
                          int windows, const float* x, long long n,
                          long long rows_per_group, int groups, float* part,
                          float* Y, void* stream) {
  if (windows > kMaxWindowBlocks ||
      !plan_fits(m, L, n, (int)((n + kSub - 1) / kSub), kWindow, windows,
                 rows_per_group, groups))
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

// Y = A X, X (n, b) row-major with 2 <= b <= kMaxBlockCols, through the
// same layout: block windows of `ratio` sub-windows (ratio * kSub * b <=
// kBlockFloats), part (windows * m * b) scratch.  The plan comes from the
// wrapper's block_plan.
int sparse_matvec_block(const void* vals, int v_kind, const int* cols,
                        const int* offsets, long long m, int L, int subs,
                        int ratio, int windows, const float* X, long long n,
                        int b, long long rows_per_group, int groups,
                        float* part, float* Y, void* stream) {
  if (b < 2 || b > kMaxBlockCols || ratio < 1 ||
      (long long)ratio * kSub * ((b + 3) & ~3) > kBlockFloats ||
      !plan_fits(m, L, n, subs, (long long)ratio * kSub, windows,
                 rows_per_group, groups))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_kind == 1)
    e = blocked<__nv_bfloat16>(vals, cols, offsets, m, L, subs, ratio,
                               windows, X, n, b, rows_per_group, groups,
                               part, Y, st);
  else if (v_kind == 2)
    e = blocked<double>(vals, cols, offsets, m, L, subs, ratio, windows, X,
                        n, b, rows_per_group, groups, part, Y, st);
  else
    e = blocked<float>(vals, cols, offsets, m, L, subs, ratio, windows, X, n,
                       b, rows_per_group, groups, part, Y, st);
  return (int)e;
}

}  // extern "C"
