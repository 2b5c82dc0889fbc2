// Reorthogonalization kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/reorth.py:
//
//   reorth_qtv         <- qtv         (reorth.py:50)   c = Q^T v
//   reorth_subtract_qc <- subtract_qc (reorth.py:68)   w = v - Q c
//
// One classical Gram-Schmidt pass against a basis Q (m, k) is qtv then
// subtract_qc; ops.reorth repeats the pair `passes` times.  Q is f32 or
// bf16 (widened with __bfloat162float), v, c and w are f32, and every
// product accumulates in f32, as in the reference kernels.
//
// What bounds them.  Each does one multiply-add per element of Q it reads,
// so both are bound by bytes of device memory: one pass over Q (m * k
// elements, 386 MB for the sparse cell's 480,189 x 201 f32 Lanczos basis)
// plus v.  The designs stream Q once, with coalesced loads, and never pad
// or copy it: ragged edges are masked.  Offsets are 64-bit.
//
// Design.
//  * qtv is a reduction over the m rows.  On the TPU it accumulates c in
//    place across a sequential grid (reorth.py:26-36); Hopper runs blocks at
//    once, so each (column tile, row chunk) block writes a partial column
//    sum (rmv_partial_kernel of gk_rows.cuh: threads own adjacent columns,
//    so each warp's load of a row segment is coalesced) and a finishing
//    launch sums the chunks of each column in a fixed order: warp w takes
//    chunks w, w + 8, ..., then the eight warp sums add in warp order.  No
//    float atomics: the same inputs give the same bits on every run.
//  * subtract_qc is row-parallel.  Each block copies c (k floats) into
//    shared memory; a warp takes one row at a time and forms Q[i, :] . c
//    with row_dot (lanes on adjacent addresses, a fixed xor-shuffle tree),
//    so every row's dot is summed in the same order on every run.
//
// C interface for ctypes: every entry point launches on the given stream,
// allocates nothing (the caller passes outputs and scratch) and returns
// cudaGetLastError() as an int.

#include "gk_rows.cuh"  // row_dot, rmv_partial_kernel, ld, kThreads, kWarps

namespace {

// c[j] = sum over chunks s of vpart[s * k + j], in a fixed order.  Block b
// owns the 32 columns from b * 32; lane = column, warp = chunk residue.
__global__ void __launch_bounds__(kThreads)
    qtv_finish_kernel(const float* __restrict__ vpart, int chunks, int k,
                      float* __restrict__ c) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (j < k)
    for (int s = warp; s < chunks; s += kWarps)
      acc += vpart[(long long)s * k + j];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && j < k) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += part[w][lane];
    c[j] = t;
  }
}

template <typename TQ>
cudaError_t qtv(const void* Q, const float* v, long long m, int k,
                long long rows_per_chunk, int chunks, float* vpart, float* c,
                cudaStream_t stream) {
  cudaError_t e = launch_rmv_partial(static_cast<const TQ*>(Q), v, m,
                                     (long long)k, rows_per_chunk, chunks,
                                     vpart, stream);
  if (e != cudaSuccess) return e;
  qtv_finish_kernel<<<(k + 31) / 32, kThreads, 0, stream>>>(vpart, chunks, k,
                                                           c);
  return cudaGetLastError();
}

// w[i] = v[i] - Q[i, :] . c; warps stride over the rows.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
    subtract_qc_kernel(const float* __restrict__ v,
                       const TQ* __restrict__ Q, const float* __restrict__ c,
                       long long m, int k, float* __restrict__ w) {
  extern __shared__ float sc[];
  for (int j = threadIdx.x; j < k; j += kThreads) sc[j] = c[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       i < m; i += stride) {
    const float d = row_dot<TQ, 1>(Q + i * k, sc, k, lane);  // warp-uniform
    if (lane == 0) w[i] = v[i] - d;
  }
}

template <typename TQ>
cudaError_t subtract_qc(const float* v, const void* Q, const float* c,
                        long long m, int k, int grid, float* w,
                        cudaStream_t stream) {
  subtract_qc_kernel<TQ><<<grid, kThreads, (size_t)k * sizeof(float),
                           stream>>>(v, static_cast<const TQ*>(Q), c, m, k,
                                     w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* reorth_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int reorth_qtv(const void* Q, int q_bf16, const float* v, long long m, int k,
               long long rows_per_chunk, int chunks, float* vpart, float* c,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? qtv<__nv_bfloat16>(Q, v, m, k, rows_per_chunk,
                                           chunks, vpart, c, s)
                      : qtv<float>(Q, v, m, k, rows_per_chunk, chunks, vpart,
                                   c, s));
}

int reorth_subtract_qc(const float* v, const void* Q, int q_bf16,
                       const float* c, long long m, int k, int grid, float* w,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? subtract_qc<__nv_bfloat16>(v, Q, c, m, k, grid, w, s)
                      : subtract_qc<float>(v, Q, c, m, k, grid, w, s));
}

}  // extern "C"
