// COO scatter-add for Hopper (sm_90a): the count-sketch fold primitive.
//
// Replaces the Pallas kernel of src/repro/kernels/count_sketch.py:
//
//   count_sketch_{bin_count, bin_scatter, part_count, part_scatter,
//   tile_sum} <- scatter_add (count_sketch.py:75): out[rows[e], cols[e]]
//       += vals[e] on a fresh (m, d) f32 panel; duplicate coordinates sum
//
// The destination is data, so this is the repository's one scatter.  The
// TPU kernel keeps the whole panel resident and adds one block of entries
// after another, which is sound because a TPU grid runs in order
// (count_sketch.py:17-18).  Hopper runs blocks at once, and float
// atomicAdd onto the panel would give different bits from run to run.
// This design uses no float atomics and no sort of the whole stream.
//
// Design: a stable binned fold.  The flattened panel (key row * d + col)
// is cut into tiles of T = 2^tile_bits cells, a tile of f32 small enough
// for one block's shared memory (the wrapper takes 16,384 cells, 64 KB),
// and into at most kBatchBins bins of 2^bin_bits cells, 2^k tiles each.
// An entry outside the panel has no bin and is never summed.  The stream
// is cut into S contiguous slices, one per warp, and
//  1. bin_count: each warp counts its slice's entries per bin, with
//     integer atomics on its own counters in shared memory (integer counts
//     are the same whatever order the atomics run in); a block writes its
//     warps' counts to the bin-major (bins x S) count matrix;
//  2. the wrapper takes the inclusive scan of that matrix (torch.cumsum,
//     index preparation as ell_pack's torch ops are), so bin b's entries
//     from slice s start at incl[b*S+s] - counts[b*S+s];
//  3. bin_scatter writes every entry's (cell inside its bin, value as f32),
//     8 bytes, into its bin, each bin in entry order, so the sum needs no
//     gather.  Writing each entry on its own costs one memory transaction
//     per entry (an 8-byte store to a random place), so a block takes its
//     kWarps slices in batches of kBatch entries and sorts each batch by
//     bin in shared memory, stably: a warp ranks its chunks of 32 with
//     __match_any_sync (an entry's rank is the number of its peers in
//     lower lanes plus the warp's earlier ones), per-bin prefixes across
//     warps and a block scan over the bins give each entry its place, and
//     the block then writes the batch bin by bin, runs of consecutive
//     entries to consecutive addresses.  That needs at most kBatchBins
//     bins, which is why bins widen to 2^k tiles on larger panels;
//  4. where a bin has more tiles than the tile sum reads itself (the
//     wrapper reads bins of up to 4 tiles whole: on an H100, splitting
//     them cost as much or more than reading them 2 or 4 times), the same
//     three stages run again inside each bin (part_count, a scan,
//     part_scatter): the bin's pairs are the stream, a block's slices are
//     slices of one bin, and the key is the pair's part of the bin (at
//     most kBatchBins parts, one tile each unless the panel has more than
//     kBatchBins^2 tiles).  Stable inside every bin, so the parts hold
//     each part's entries in entry order, as if the stream had been binned
//     by part at once;
//  5. tile_sum: one block per tile zeroes the tile in shared memory and
//     reads its bin (or part) in order, kSumBatch entries at a time.  Each
//     warp owns the cells of one residue mod kSumWarps; the block routes
//     the batch's entries of its tile to their owner warps' queues, stably
//     (ballots on the owner's bits), and each warp walks its queue 32
//     entries at a time: __match_any_sync groups the lanes of one cell,
//     and the group's leader adds the group's values (staged in shared
//     memory) onto the cell in lane order.  The block then writes the tile
//     once, coalesced; an empty tile writes zeros, so there is no separate
//     zero pass.
// Summation order: bins, parts, batches, queues and chunks keep entry
// order, so every cell is summed one entry after another in entry order,
// starting from 0: the order of np.add.at and of index_add_ on the CPU.
// The panel equals the plain version on the CPU bit for bit, on any
// values, and is the same on every run.
//
// What bounds it.  One add per entry, so bytes: each entry's destination
// and value read once (12 bytes in the caller's int32 / f32 stream) and
// the panel written once.  The design moves more: the stream's indices
// are read twice and its values once, 8 bytes an entry are written to the
// bins and read back by each of a bin's tiles (or, where bins are split,
// read twice more and written once more by step 4), and the count
// matrices are written, scanned and read (a few MB).
//
// Skew.  A tile's entries are summed by its one block, and a cell's by
// one warp, so a stream that lands whole in one cell (all at (0, 0)) is
// walked by a single warp, chunk by chunk; a stream into one tile but
// many cells spreads over the block's warps.  Steps 1-3 stay spread over
// all warps; step 4 gives each bin a fixed number of slices, so a bin
// that takes the whole stream is split by that many warps.
//
// Limits.  Bin, part and tile indices and cells are 32-bit (the flattened
// key is 64-bit), so panels of more than 2^31 cells work; past
// kBatchBins^2 tiles a part holds 2^k tiles, each read by its block.
// Stream positions are 32-bit: the wrapper refuses a stream of 2^31
// entries or more.  Every entry checks bins <= kBatchBins and a whole
// number of blocks of slices, and returns cudaErrorInvalidValue otherwise.
//
// vals may be f32, bf16 or f64; each is converted to f32 as it is binned.
// C interface for ctypes: launches on the given stream, allocates nothing,
// returns cudaGetLastError() as an int.  v_kind: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads, kWarps

namespace {

constexpr int kAhead = 8;            // chunks of 32 whose loads are in flight
constexpr int kChunk = 32 * kAhead;  // entries a warp loads at once
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBatchChunks = 16;     // chunks a warp ranks in a batch
constexpr int kBatch = kWarps * kBatchChunks * 32;  // 4,096 entries a batch
constexpr int kBatchBins = 512;      // most bins the scatter sorts by
constexpr int kMaxTileBits = 15;     // a 128 KB tile of f32
constexpr int kSumWarps = 8;         // a tile_sum block; one residue each
constexpr int kSumChunks = 4;        // chunks a warp routes in a batch
constexpr int kSumBatch = kSumWarps * kSumChunks * 32;  // 1,024 entries
constexpr int kOwnerBits = 3;        // log2(kSumWarps)
static_assert(kSumWarps == 1 << kOwnerBits, "one owner residue a warp");
static_assert(kSumWarps * kSumWarps % 32 == 0, "whole queue-offset scan");

// The caller's stream.  Entry (r, c) of the (m, d) panel has the key
// r * d + c, its bin the key's high bits (key >> bits) and its cell the
// low ones; bin -1 for a coordinate outside the panel.  load() reads N
// chunks of 32 entries from base, lane-strided (chunk u holds entries base
// + 32u .. base + 32u + 31, in lane order); only a load that crosses end
// checks bounds, and a lane past the end gets bin -1.  Branch-free, so the
// loads of a whole batch stay in flight together.
template <typename TV>
struct Stream {
  const int* __restrict__ rows;
  const int* __restrict__ cols;
  const TV* __restrict__ vals;
  long long m, d;
  int bits;

  template <int N, bool kVals>
  __device__ __forceinline__ void load(long long base, long long end,
                                       int lane, int (&bin)[N],
                                       int (&cell)[N], int (&val)[N]) const {
    int r[N], c[N];
    float v[N];
    if (base + 32 * N <= end) {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const long long e = base + u * 32 + lane;
        r[u] = rows[e];
        c[u] = cols[e];
        if constexpr (kVals) v[u] = ld(vals + e);
      }
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const long long e = base + u * 32 + lane;
        const bool in = e < end;
        r[u] = in ? rows[e] : -1;
        c[u] = in ? cols[e] : -1;
        if constexpr (kVals) v[u] = in ? ld(vals + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool in = r[u] >= 0 && r[u] < m && c[u] >= 0 && c[u] < d;
      const long long key = in ? (long long)r[u] * d + c[u] : 0;
      bin[u] = in ? (int)(key >> bits) : -1;
      cell[u] = (int)(key & ((1ll << bits) - 1));
      if constexpr (kVals) val[u] = __float_as_int(v[u]);
    }
  }
};

// A binned stream read again (step 4): pair (cell inside a bin, value
// bits) goes to the bin's part cell >> bits, at the cell's low bits.  The
// loads are those of Stream; a lane past the end gets bin -1.
struct Pairs {
  const int2* __restrict__ pairs;
  int bits;

  template <int N, bool kVals>
  __device__ __forceinline__ void load(long long base, long long end,
                                       int lane, int (&bin)[N],
                                       int (&cell)[N], int (&val)[N]) const {
    int2 x[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long e = base + u * 32 + lane;
      x[u] = e < end ? pairs[e] : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      bin[u] = x[u].x < 0 ? -1 : x[u].x >> bits;
      cell[u] = x[u].x & ((1 << bits) - 1);
      if constexpr (kVals) val[u] = x[u].y;
    }
  }
};

// How a stage's input is cut.  Segment g (blockIdx.y) is a range of the
// input in S slices of equal length, one a warp, kWarps a block.  Steps 1
// and 3: one segment, the whole stream of E entries, in slices of
// slice_len.  Step 4: segment g is bin g of steps 1-3, its range read
// from their scan (prev, prev_S slices a bin), in slices of ceil(len / S).
struct Slicing {
  const int* __restrict__ prev;  // nullptr in steps 1 and 3
  int prev_S;
  long long E;
  long long slice_len;
  int S;

  // [lo, hi): slices s .. s + n - 1 of segment g
  __device__ __forceinline__ void range(int g, int s, int n, long long& lo,
                                        long long& hi) const {
    long long begin = 0, end = E, len = slice_len;
    if (prev != nullptr) {
      begin = g ? prev[(long long)g * prev_S - 1] : 0;
      end = prev[(long long)g * prev_S + prev_S - 1];
      len = (end - begin + S - 1) / S;
    }
    lo = begin + s * len;
    hi = lo + n * len < end ? lo + n * len : end;
  }
};

// Exclusive scan of one int a thread over a block of kThreads; *total is
// the block's sum.  red: kWarps + 1 ints of shared memory, free again
// after the next __syncthreads.
__device__ __forceinline__ int block_scan(int x, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? red[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < kWarps) red[lane] = wi - w;
    if (lane == kWarps - 1) red[kWarps] = wi;
  }
  __syncthreads();
  *total = red[kWarps];
  return red[warp] + inc - x;
}

// Steps 1 and 4's count.  Per-warp bin counts of a slice (slice s =
// blockIdx.x * kWarps + warp of segment g = blockIdx.y), on the warp's
// counters hist[warp * bins + b] in shared memory; the block writes its
// kWarps slices' counts of bin b together (consecutive ints of the
// bin-major (segments x bins x S) matrix).
template <typename Src>
__global__ void __launch_bounds__(kThreads)
    bin_count_kernel(Src src, Slicing sl, int bins, int* __restrict__ counts) {
  extern __shared__ int hist[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.y, s0 = blockIdx.x * kWarps;
  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) hist[i] = 0;
  __syncthreads();
  int* h = hist + warp * bins;
  long long lo, hi;
  sl.range(g, s0 + warp, 1, lo, hi);
  for (long long base = lo; base < hi; base += kChunk) {
    int bin[kAhead], cell[kAhead], val[kAhead];
    src.template load<kAhead, false>(base, hi, lane, bin, cell, val);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (bin[u] >= 0) atomicAdd(h + bin[u], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) {
    const int b = i / kWarps, w = i - b * kWarps;
    counts[((long long)g * bins + b) * sl.S + s0 + w] = hist[w * bins + b];
  }
}

// Steps 3 and 4's stable scatter.  The block's slices s0 .. s0 + kWarps -
// 1 of segment g are one contiguous range of the input, and its entries of
// bin b fill the bin from incl[i] - counts[i] on (i = (g*bins + b)*S +
// s0), in entry order.  Shared memory: a batch's sorted pairs and their
// bins, the per-warp rank table, and per-bin batch totals, local starts
// and block cursors.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
    batch_scatter_kernel(Src src, Slicing sl, int bins,
                         const int* __restrict__ counts,
                         const int* __restrict__ incl,
                         int2* __restrict__ binned) {
  extern __shared__ int2 sorted[];                        // kBatch pairs
  int* tab = reinterpret_cast<int*>(sorted + kBatch);     // kWarps x bins
  int* tot = tab + kWarps * bins;                         // bins
  int* start = tot + kBatchBins;                          // bins
  int* cur = start + kBatchBins;                          // bins
  int* red = cur + kBatchBins;                            // kWarps + 1
  unsigned short* sbin = reinterpret_cast<unsigned short*>(red + 2 * kWarps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int g = blockIdx.y, s0 = blockIdx.x * kWarps;
  for (int b = threadIdx.x; b < bins; b += kThreads) {
    const long long i = ((long long)g * bins + b) * sl.S + s0;
    cur[b] = incl[i] - counts[i];
  }
  long long lo, hi;
  sl.range(g, s0, kWarps, lo, hi);
  for (long long base = lo; base < hi; base += kBatch) {
    for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) tab[i] = 0;
    __syncthreads();
    // Rank: warp w takes the batch's w-th run of kBatchChunks chunks.
    int bin[kBatchChunks], cell[kBatchChunks], val[kBatchChunks];
    int rank[kBatchChunks];
    src.template load<kBatchChunks, true>(
        base + warp * kBatchChunks * 32, hi, lane, bin, cell, val);
    int* row = tab + warp * bins;
#pragma unroll
    for (int u = 0; u < kBatchChunks; ++u) {
      const unsigned peers = __match_any_sync(kAll, bin[u]);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (lane == leader && bin[u] >= 0) {
        at = row[bin[u]];
        row[bin[u]] = at + __popc(peers);
      }
      rank[u] = __shfl_sync(kAll, at, leader) + __popc(peers & below);
      __syncwarp();  // this chunk's table writes before the next one's reads
    }
    __syncthreads();
    // Per bin: each warp's offset among the batch's entries of the bin.
    for (int b = threadIdx.x; b < bins; b += kThreads) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int t = tab[w * bins + b];
        tab[w * bins + b] = run;
        run += t;
      }
      tot[b] = run;
    }
    __syncthreads();
    // Local starts: the exclusive scan of the totals over the bins.
    constexpr int kPer = kBatchBins / kThreads;
    int t[kPer], sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = threadIdx.x * kPer + j;
      t[j] = b < bins ? tot[b] : 0;
      sum += t[j];
    }
    int n;
    int ex = block_scan(sum, red, &n);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = threadIdx.x * kPer + j;
      if (b < bins) start[b] = ex;
      ex += t[j];
    }
    __syncthreads();
    // Place the batch in shared memory, sorted by bin, stably.
#pragma unroll
    for (int u = 0; u < kBatchChunks; ++u) {
      if (bin[u] < 0) continue;
      const int p = start[bin[u]] + row[bin[u]] + rank[u];
      sorted[p] = make_int2(cell[u], val[u]);
      sbin[p] = (unsigned short)bin[u];
    }
    __syncthreads();
    // Write it out: the runs of one bin go to consecutive addresses.
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = sbin[i];
      binned[cur[b] + i - start[b]] = sorted[i];
    }
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += kThreads) cur[b] += tot[b];
  }
}

// kSumChunks chunks of 32 binned pairs from base, lane-strided; a lane
// past end reads cell -1.
__device__ __forceinline__ void load_pairs(const int2* __restrict__ binned,
                                           long long base, long long end,
                                           int lane, int2 (&x)[kSumChunks]) {
#pragma unroll
  for (int u = 0; u < kSumChunks; ++u) {
    const long long e = base + u * 32 + lane;
    x[u] = e < end ? binned[e] : make_int2(-1, 0);
  }
}

// 5. One block per tile (tile j of bin blockIdx.x >> sub_bits): the bin's
// pairs of this tile summed in order into the tile in shared memory, then
// the tile written once.  Shared memory: a batch's queues (kSumBatch
// pairs), the tile (T floats), each warp's 32 staged values, and the
// routing tables.
__global__ void __launch_bounds__(kSumWarps * 32)
    tile_sum_kernel(const int2* __restrict__ binned,
                    const int* __restrict__ incl, int S, int bits,
                    int sub_bits, long long total, float* __restrict__ out) {
  extern __shared__ int2 queue[];                              // kSumBatch
  float* tile = reinterpret_cast<float*>(queue + kSumBatch);   // T cells
  const int T = 1 << bits;
  float* stage = tile + T;                                     // warps x 32
  int* wtot = reinterpret_cast<int*>(stage + kSumWarps * 32);  // warp, owner
  int* qoff = wtot + kSumWarps * kSumWarps;                    // warp, owner
  int* qend = qoff + kSumWarps * kSumWarps;                    // owner
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const long long b = blockIdx.x >> sub_bits;
  const int j = blockIdx.x & ((1 << sub_bits) - 1);
  for (int i = threadIdx.x; i < T; i += kSumWarps * 32) tile[i] = 0.f;
  const long long begin = b ? incl[b * S - 1] : 0;
  const long long end = incl[b * S + S - 1];
  // Route: warp w reads the batch's w-th run of kSumChunks chunks (the
  // next batch's loads are issued before this one is routed); an entry of
  // this tile goes to the queue of warp (cell mod kSumWarps).
  int2 x[kSumChunks], next[kSumChunks];
  load_pairs(binned, begin + warp * kSumChunks * 32, end, lane, x);
  for (long long base = begin; base < end; base += kSumBatch) {
    if (base + kSumBatch < end)
      load_pairs(binned, base + kSumBatch + warp * kSumChunks * 32, end, lane,
                 next);
    int qrank[kSumChunks];
    int cnt = 0;  // lane o < kSumWarps: this warp's entries for owner o
#pragma unroll
    for (int u = 0; u < kSumChunks; ++u) {
      const int cell = x[u].x;
      const bool mine = cell >= 0 && (cell >> bits) == j;
      const int o = cell & (kSumWarps - 1);
      const unsigned tile_lanes = __ballot_sync(kAll, mine);
      unsigned same = tile_lanes;  // lanes with this lane's owner
      unsigned ours = tile_lanes;  // lanes whose owner is this lane's index
#pragma unroll
      for (int k = 0; k < kOwnerBits; ++k) {
        const unsigned bk = __ballot_sync(kAll, (o >> k) & 1);
        same &= ((o >> k) & 1) ? bk : ~bk;
        ours &= ((lane >> k) & 1) ? bk : ~bk;
      }
      const int before = __shfl_sync(kAll, cnt, o);
      qrank[u] = mine ? before + __popc(same & below) : -1;
      if (lane < kSumWarps) cnt += __popc(ours);
    }
    if (lane < kSumWarps) wtot[warp * kSumWarps + lane] = cnt;
    __syncthreads();
    if (warp == 0) {
      // the queues hold owner 0's entries, then owner 1's, ..., each in
      // warp order: the exclusive scan of the totals in (owner, warp)
      // order, kPairs a lane, is each (warp, owner)'s queue offset
      constexpr int kPairs = kSumWarps * kSumWarps / 32;
      int t[kPairs], inc = 0;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int i = kPairs * lane + k;  // owner i / kSumWarps, warp i % ..
        t[k] = wtot[(i % kSumWarps) * kSumWarps + i / kSumWarps];
        inc += t[k];
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, inc, o);
        if (lane >= o) inc += y;
      }
      int ex = inc;
#pragma unroll
      for (int k = 0; k < kPairs; ++k) ex -= t[k];
#pragma unroll
      for (int k = 0; k < kPairs; ++k) {
        const int i = kPairs * lane + k;
        qoff[(i % kSumWarps) * kSumWarps + i / kSumWarps] = ex;
        ex += t[k];
        if (i % kSumWarps == kSumWarps - 1) qend[i / kSumWarps] = ex;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSumChunks; ++u)
      if (qrank[u] >= 0) {
        const int cell = x[u].x;
        queue[qoff[warp * kSumWarps + (cell & (kSumWarps - 1))] + qrank[u]] =
            make_int2(cell & (T - 1), x[u].y);
      }
    __syncthreads();
    // Walk: warp r adds its queue (its cells only) 32 entries at a time.
    const int q0 = warp ? qend[warp - 1] : 0, q1 = qend[warp];
    float* st = stage + warp * 32;
    for (int p = q0; p < q1; p += 32) {
      const int2 y = p + lane < q1 ? queue[p + lane] : make_int2(-1, 0);
      const unsigned peers = __match_any_sync(kAll, y.x);
      st[lane] = __int_as_float(y.y);
      __syncwarp();
      if (y.x >= 0 && lane == __ffs(peers) - 1) {
        float acc = tile[y.x];
        for (unsigned q = peers; q; q &= q - 1) acc += st[__ffs(q) - 1];
        tile[y.x] = acc;
      }
      __syncwarp();  // the stage is read before the next chunk overwrites it
    }
    __syncthreads();  // queues and tables are free for the next batch
#pragma unroll
    for (int u = 0; u < kSumChunks; ++u) x[u] = next[u];
  }
  __syncthreads();
  const long long t0 = (b << (bits + sub_bits)) + ((long long)j << bits);
  const long long n = total - t0 < T ? total - t0 : T;
  for (int i = threadIdx.x; i < n; i += kSumWarps * 32) out[t0 + i] = tile[i];
}

// --- launchers ------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The limits the kernels' shared-memory tables rely on.
bool fits(int segments, int bins, int S) {
  return segments >= 1 && segments <= 65535 && bins >= 1 &&
         bins <= kBatchBins && S >= kWarps && S % kWarps == 0;
}

template <typename Src>
cudaError_t count(Src src, const Slicing& sl, int segments, int bins,
                  int* counts, cudaStream_t stream) {
  if (!fits(segments, bins, sl.S)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * bins * sizeof(int);
  cudaError_t e = allow_smem(bin_count_kernel<Src>, smem);
  if (e != cudaSuccess) return e;
  bin_count_kernel<Src><<<dim3(sl.S / kWarps, segments), kThreads, smem,
                          stream>>>(src, sl, bins, counts);
  return cudaGetLastError();
}

template <typename Src>
cudaError_t scatter(Src src, const Slicing& sl, int segments, int bins,
                    const int* counts, const int* incl, int2* binned,
                    cudaStream_t stream) {
  if (!fits(segments, bins, sl.S)) return cudaErrorInvalidValue;
  const size_t smem = kBatch * (sizeof(int2) + sizeof(unsigned short)) +
                      ((size_t)kWarps * bins + 3 * kBatchBins + 2 * kWarps) *
                          sizeof(int);
  cudaError_t e = allow_smem(batch_scatter_kernel<Src>, smem);
  if (e != cudaSuccess) return e;
  batch_scatter_kernel<Src><<<dim3(sl.S / kWarps, segments), kThreads, smem,
                              stream>>>(src, sl, bins, counts, incl, binned);
  return cudaGetLastError();
}

template <typename TV>
Stream<TV> stream_of(const int* rows, const int* cols, const void* vals,
                     long long m, long long d, int bits) {
  return Stream<TV>{rows, cols, static_cast<const TV*>(vals), m, d, bits};
}

}  // namespace

extern "C" {

const char* count_sketch_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Step 1: counts (bins * S int32, bin-major; 1 <= bins <= 512) of the S
// slices of slice_len entries (S a multiple of 8).
int count_sketch_bin_count(const int* rows, const int* cols, long long E,
                           long long m, long long d, int bits, int bins, int S,
                           long long slice_len, int* counts, void* stream) {
  const Slicing sl{nullptr, 0, E, slice_len, S};
  return (int)count(stream_of<float>(rows, cols, nullptr, m, d, bits), sl, 1,
                    bins, counts, static_cast<cudaStream_t>(stream));
}

// Step 3: binned (E int2 pairs (cell inside the bin, f32 bits); the first
// incl[last] are written) from the counts and their inclusive scan incl.
int count_sketch_bin_scatter(const int* rows, const int* cols,
                             const void* vals, int v_kind, long long E,
                             long long m, long long d, int bits, int bins,
                             int S, long long slice_len, const int* counts,
                             const int* incl, void* binned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* out = static_cast<int2*>(binned);
  const Slicing sl{nullptr, 0, E, slice_len, S};
  cudaError_t e;
  if (v_kind == 1)
    e = scatter(stream_of<__nv_bfloat16>(rows, cols, vals, m, d, bits), sl,
                1, bins, counts, incl, out, st);
  else if (v_kind == 2)
    e = scatter(stream_of<double>(rows, cols, vals, m, d, bits), sl, 1, bins,
                counts, incl, out, st);
  else
    e = scatter(stream_of<float>(rows, cols, vals, m, d, bits), sl, 1, bins,
                counts, incl, out, st);
  return (int)e;
}

// Step 4's count: the pairs of step 3 (bins bins, their scan incl with S
// slices a bin) counted by part (cell >> part_bits, parts a bin) in
// part_S slices a bin: counts (bins * parts * part_S int32, bin-major,
// then part-major).
int count_sketch_part_count(const void* binned, const int* incl, int S,
                            int bins, int part_bits, int parts, int part_S,
                            int* counts, void* stream) {
  const Slicing sl{incl, S, 0, 0, part_S};
  const Pairs src{static_cast<const int2*>(binned), part_bits};
  return (int)count(src, sl, bins, parts, counts,
                    static_cast<cudaStream_t>(stream));
}

// Step 4's scatter: out (as many int2 pairs as binned holds; cell inside
// the part) from step 4's counts and their inclusive scan part_incl.
int count_sketch_part_scatter(const void* binned, const int* incl, int S,
                              int bins, int part_bits, int parts, int part_S,
                              const int* counts, const int* part_incl,
                              void* out, void* stream) {
  const Slicing sl{incl, S, 0, 0, part_S};
  const Pairs src{static_cast<const int2*>(binned), part_bits};
  return (int)scatter(src, sl, bins, parts, counts, part_incl,
                      static_cast<int2*>(out),
                      static_cast<cudaStream_t>(stream));
}

// Step 5: the (total,) f32 panel from the binned pairs (bins bins, their
// scan incl with S slices a bin), one block a tile of 2^tile_bits cells,
// 2^sub_bits tiles a bin.
int count_sketch_tile_sum(const void* binned, const int* incl, int S,
                          int tile_bits, int sub_bits, int bins,
                          long long total, float* out, void* stream) {
  if (tile_bits < 5 || tile_bits > kMaxTileBits || sub_bits < 0 ||
      bins < 1 || S < 1 || ((long long)bins << sub_bits) > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      kSumBatch * sizeof(int2) +
      ((size_t(1) << tile_bits) + kSumWarps * 32) * sizeof(float) +
      (2 * kSumWarps * kSumWarps + kSumWarps) * sizeof(int);
  cudaError_t e = allow_smem(tile_sum_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  tile_sum_kernel<<<(unsigned)((long long)bins << sub_bits), kSumWarps * 32,
                    smem, st>>>(static_cast<const int2*>(binned), incl, S,
                                tile_bits, sub_bits, total, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
