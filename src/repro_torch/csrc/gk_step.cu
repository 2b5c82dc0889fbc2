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
// fused matvecs are stage 1 with an empty basis (k = 0: no c = Q^T u
// epilogue and no finishing launch); the operator calls them for the
// half-steps of a float64 DenseOp(backend="pallas").
//
// What bounds them.  Every kernel does about one multiply-add per element it
// reads, far below the card's ~20 flop/byte f32 ridge, so each is bound by
// bytes of device memory: stage 1 reads A once (m*n elements, 32 GB at the
// 1e5 x 8e4 f32 operand) plus the basis once; each proj kernel reads the
// basis once.  A half-step therefore moves |A| + (passes+1)|Q| bytes, and
// |A| dominates by ~400x at the main shape.  The designs below aim at one
// thing: stream A (and Q) exactly once, with coalesced loads, and never
// write a vector of length m or n to memory between the matvec and the
// first projection product.
//
// Design.
//  * The row kernel (rows_kernel) gives each warp one row at a time: the
//    warp computes that row's scalar (a dot product over A's row or Q's
//    row, lanes on adjacent addresses, 16-byte vector loads where the row
//    is aligned), then the block folds the eight scalars of the group into
//    its share of c = Q^T u while the Q rows are still in L1.  The scalar
//    never makes a round trip through device memory before c sees it.
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

template <typename TQ>
struct ProjRow {  // w_i = u_i - Q[i, :] . c
  const float* u;
  const TQ* Q;
  const float* c;
  int k;
  __device__ float operator()(long long i, int lane) const {
    return u[i] - row_dot<TQ, 1>(Q + i * k, c, k, lane);
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
// vector.  Each warp computes one row scalar, writes it to out, and the
// block accumulates either its share of c = Q^T out (NORM = false; k floats
// of dynamic shared memory, written to part[j * gridDim.x + b]) or of
// ||out||^2 (NORM = true; written to part[b]).
template <class Row, typename TQ, bool NORM>
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
  if (!NORM)
    for (int j = threadIdx.x; j < k; j += kThreads) sc[j] = 0.f;
  float nrm = 0.f;
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
    if (NORM) {
      if (threadIdx.x == 0)
        for (int w = 0; w < nw; ++w) nrm = fmaf(sw[w], sw[w], nrm);
    } else {
      for (int j = threadIdx.x; j < k; j += kThreads) {
        float acc = sc[j];
        for (int w = 0; w < nw; ++w)
          acc = fmaf(ld(Q + (g + w) * k + j), sw[w], acc);
        sc[j] = acc;
      }
    }
    __syncthreads();
  }
  if (NORM) {
    if (threadIdx.x == 0) part[blockIdx.x] = nrm;
  } else {
    for (int j = threadIdx.x; j < k; j += kThreads)
      part[(long long)j * gridDim.x + blockIdx.x] = sc[j];
  }
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

template <class Row, typename TQ, bool NORM>
cudaError_t launch_rows(const Row& row, const TQ* Q, int k, long long L,
                        long long rows_per_block, int grid, float* out,
                        float* part, cudaStream_t stream) {
  const size_t smem = NORM ? 0 : (size_t)k * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<Row, TQ, NORM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  rows_kernel<Row, TQ, NORM>
      <<<grid, kThreads, smem, stream>>>(row, Q, k, L, rows_per_block, out,
                                         part);
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
  const cudaError_t e = launch_rows<MvRow<TA, V>, TQ, false>(
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
  e = launch_rows<RmvRow, TP, false>(row, static_cast<const TP*>(P), k, n,
                                     rows_per_block, grid, v, part, stream);
  if (e != cudaSuccess) return e;
  return finish(part, grid, k, c, stream);
}

template <typename TQ, bool NORM>
cudaError_t proj(const float* u, const void* Q, const float* c_in,
                 long long L, int k, long long rows_per_block, int grid,
                 float* w, float* part, float* out, cudaStream_t stream) {
  const TQ* Qt = static_cast<const TQ*>(Q);
  const ProjRow<TQ> row{u, Qt, c_in, k};
  const cudaError_t e = launch_rows<ProjRow<TQ>, TQ, NORM>(
      row, Qt, k, L, rows_per_block, grid, w, part, stream);
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
                long long L, int k, long long rows_per_block, int grid,
                float* w, float* part, float* c_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16
                   ? proj<__nv_bfloat16, false>(u, Q, c_in, L, k,
                                                rows_per_block, grid, w, part,
                                                c_out, s)
                   : proj<float, false>(u, Q, c_in, L, k, rows_per_block,
                                        grid, w, part, c_out, s));
}

int gk_proj_norm(const float* u, const void* Q, int q_bf16,
                 const float* c_in, long long L, int k,
                 long long rows_per_block, int grid, float* v, float* part,
                 float* nrm2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16
                   ? proj<__nv_bfloat16, true>(u, Q, c_in, L, k,
                                               rows_per_block, grid, v, part,
                                               nrm2, s)
                   : proj<float, true>(u, Q, c_in, L, k, rows_per_block, grid,
                                       v, part, nrm2, s));
}

int gk_matvec_fused(const void* A, int a_kind, const float* p, const float* y,
                    const float* alpha, long long m, long long n,
                    long long rows_per_block, int grid, float* u,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_kind == 1)
    e = mv_qtv_vec<__nv_bfloat16, float>(A, p, y, alpha, nullptr, m, n, 0,
                                         rows_per_block, grid, u, nullptr,
                                         nullptr, s);
  else if (a_kind == 2)
    e = mv_qtv_vec<double, float>(A, p, y, alpha, nullptr, m, n, 0,
                                  rows_per_block, grid, u, nullptr, nullptr,
                                  s);
  else
    e = mv_qtv_vec<float, float>(A, p, y, alpha, nullptr, m, n, 0,
                                 rows_per_block, grid, u, nullptr, nullptr,
                                 s);
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
