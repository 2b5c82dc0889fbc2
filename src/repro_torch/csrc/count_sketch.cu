// COO scatter-add for Hopper (sm_90a): the count-sketch fold primitive.
//
// Replaces the Pallas kernel of src/repro/kernels/count_sketch.py:
//
//   count_sketch_scatter_add <- scatter_add (count_sketch.py:75)
//       out[rows[e], cols[e]] += vals[e]  on a fresh (m, d) f32 panel;
//       duplicate coordinates sum
//
// The destination is data, so this is the repository's one scatter.  The
// TPU kernel keeps the whole panel resident and adds one block of entries
// after another, which is sound because a TPU grid runs in order
// (count_sketch.py:17-18).  Hopper runs blocks at once.  Float atomicAdd
// onto the panel would serialize on the heavy collisions of a sketch fold
// (each touched cell of a fold receives tens to hundreds of entries) and
// would give different bits from run to run.  This kernel uses no atomics.
//
// Design.  The wrapper (kernels/count_sketch.py) prepares the index, as
// ell_pack does for the sparse matvec: the flattened destination key
// row * d + col in int64 (a coordinate outside the panel gets the key
// m * d, past its end) and a stable sort of the keys, so the entries of one
// destination lie together and in entry order.  The kernel then
//  1. writes 0 to every cell of the panel, and
//  2. gives each sorted entry a thread; the thread at the head of a run of
//     equal keys sums the run's values, gathered through the sort's
//     permutation, and writes the cell once.  It loads eight entries of
//     the run at a time, so eight gathers are in flight, and adds them in
//     order.
// Summation order: each cell's entries are added one by one in entry
// order, starting from 0, the order of np.add.at and of index_add_ on the
// CPU.  So the panel equals the plain version on the CPU bit for bit, on
// any values, and is the same on every run.  Keys outside [0, m * d) are
// skipped: an out-of-range coordinate writes nothing, and no host sync
// checks for one.
//
// What bounds it.  One add per entry, so bytes: the panel written once and
// each entry's destination and value read once (12 bytes an entry in the
// caller's int32 / f32 stream).  The kernel reads more than that: the
// 8-byte sorted key and 8-byte permutation of every entry, and each value
// by a gather that costs a 32-byte sector.  The sort (torch.sort in the
// wrapper) is index preparation and is timed with the whole wrapper.
//
// vals may be f32, bf16 or f64; each is converted to f32 before it is
// added.  Offsets and keys are 64-bit.  C interface for ctypes: launches
// on the given stream, allocates nothing, returns cudaGetLastError() as an
// int.  v_kind: 0 f32, 1 bf16, 2 f64.

#include "gk_rows.cuh"  // ld (f32 / bf16 / f64 -> f32), kThreads

namespace {

constexpr int kMaxBlocks = 65535 * 32;
constexpr int kAhead = 8;  // entries of a run whose loads are in flight at once

__global__ void __launch_bounds__(kThreads)
    zero_kernel(float* __restrict__ out, long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
       t < total; t += stride)
    out[t] = 0.f;
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
    segment_sum_kernel(const long long* __restrict__ keys,
                       const long long* __restrict__ perm,
                       const TV* __restrict__ vals, long long E,
                       long long total, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < E;
       e += stride) {
    const long long key = keys[e];
    if (key < 0 || key >= total) continue;       // outside the panel
    if (e > 0 && keys[e - 1] == key) continue;   // not the head of a run
    // The run is walked kAhead entries at a time: their keys, positions and
    // gathered values are loaded together (independent loads in flight),
    // then the values of the run are added one by one in entry order.
    float acc = 0.f;
    for (long long t = e;; t += kAhead) {
      float v[kAhead];
      bool in[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        in[j] = t + j < E && keys[t + j] == key;
        v[j] = in[j] ? ld(vals + perm[t + j]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j)
        if (in[j]) acc += v[j];
      if (!in[kAhead - 1]) break;  // keys are sorted: the run has ended
    }
    out[key] = acc;
  }
}

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename TV>
cudaError_t scatter_add(const long long* keys, const long long* perm,
                        const void* vals, long long E, long long total,
                        float* out, cudaStream_t stream) {
  zero_kernel<<<blocks_for(total), kThreads, 0, stream>>>(out, total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || E == 0) return e;
  segment_sum_kernel<TV><<<blocks_for(E), kThreads, 0, stream>>>(
      keys, perm, static_cast<const TV*>(vals), E, total, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* count_sketch_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int count_sketch_scatter_add(const long long* keys, const long long* perm,
                             const void* vals, int v_kind, long long E,
                             long long total, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (v_kind == 1)
    e = scatter_add<__nv_bfloat16>(keys, perm, vals, E, total, out, s);
  else if (v_kind == 2)
    e = scatter_add<double>(keys, perm, vals, E, total, out, s);
  else
    e = scatter_add<float>(keys, perm, vals, E, total, out, s);
  return (int)e;
}

}  // extern "C"
