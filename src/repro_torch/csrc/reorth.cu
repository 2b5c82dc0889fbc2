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
// plus v.  Q is read in place, never padded or copied.
//
// Design.  Both are epilogues of the projection pair's staged tiles
// (proj_tiles.cuh): a block copies tiles of whole rows, one contiguous run
// of the array whatever k's parity (804 bytes a row at k = 201 f32, 402
// in bf16: never 16-byte aligned), into shared memory in aligned 16-byte
// cp.async chunks, two stages deep, and reads each staged element once.
//  * qtv is the c' = Q^T w fold with w = v: a warp takes a row with lanes
//    along it and keeps its columns' sums in registers (k <= 256); the
//    block adds its warps' sums in warp order, and a finishing launch sums
//    the blocks' partials in a fixed order.  On the TPU c accumulates in
//    place across a sequential grid (reorth.py:26-36); Hopper runs blocks
//    at once, so no float atomics: the same inputs give the same bits.
//  * subtract_qc is the w = u - Q c half alone: a warp forms each row's
//    dot product with c (a fixed xor-shuffle tree), so every row is summed
//    in the same order on every run, with no reduction across blocks and
//    no finishing launch.
//
// C interface for ctypes: every entry point launches on the given stream,
// allocates nothing (the caller passes outputs and scratch) and returns
// cudaGetLastError() as an int.  (tile_rows, grid, stages, flags) is the
// wrappers' proj_plan for Q.

#include "proj_tiles.cuh"  // proj

extern "C" {

const char* reorth_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int reorth_qtv(const void* Q, int q_bf16, const float* v, long long m, int k,
               int tile_rows, int grid, int stages, int flags, float* part,
               float* c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, kQtv>(v, Q, nullptr, m, k,
                                                  tile_rows, grid, stages,
                                                  flags, nullptr, part, c, s)
                      : proj<float, kQtv>(v, Q, nullptr, m, k, tile_rows,
                                          grid, stages, flags, nullptr, part,
                                          c, s));
}

int reorth_subtract_qc(const float* v, const void* Q, int q_bf16,
                       const float* c, long long m, int k, int tile_rows,
                       int grid, int stages, int flags, float* w,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? proj<__nv_bfloat16, kSubtract>(
                            v, Q, c, m, k, tile_rows, grid, stages, flags, w,
                            nullptr, nullptr, s)
                      : proj<float, kSubtract>(v, Q, c, m, k, tile_rows, grid,
                                               stages, flags, w, nullptr,
                                               nullptr, s));
}

}  // extern "C"
