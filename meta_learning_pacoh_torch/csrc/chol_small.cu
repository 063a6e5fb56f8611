// Batched Cholesky factorization of small matrices, 1 <= N <= 64 (the port
// sends 32 <= N <= 64 here): one warp per matrix, its rows in registers.
//
// Replaces the Pallas TPU kernels of meta_learning_pacoh_tpu/ops/pallas/
// chol_kernel.py (cholesky_pallas: _chol_single, one matrix in VMEM, and
// _chol_batched, 128 matrices lane-major [N, N, 128]). Both are the
// right-looking factorization: per column j the pivot, the scaled column,
// and the rank-1 update of the trailing block. Contract of the port's K4
// (chol.cu): input [B, N, N] float32, only the lower triangle read; no
// jitter; output the lower factor with zeros above the diagonal, or all NaN
// for a matrix with a pivot that is not finite and positive.
//
// What bounds it on the card: a matrix is N^3/3 flops on 4 N^2 bytes in and
// out; at the eval's B=20 to 200, N=50 that is at most 8.3 MFLOP against
// 4 MB, a few microseconds of either at the card's peaks. What sets its time
// is the serial chain of N pivots a matrix. The design is K2's (mll.cu), on
// the same register factorization (warp_chol.cuh's factor_rows) without its
// border row or jitter levels: one warp a matrix, a block of its own; the
// lower triangle lands in a per-warp shared tile (odd leading dimension) by
// cp.async, every row's copies in flight at once; lane l takes rows l and
// l + 32 into registers; each column's pivot is shuffled from its owner,
// the scaled column broadcast as float4 from a column buffer, one __syncwarp
// a column. A pivot fails unless finite and positive (a denormal one is
// factored, as by the plain version, through rsqrtf, which does not flush
// it); the first failure sends the matrix out all NaN. L goes out through
// the tile's upper triangle, coalesced, zeros above the diagonal. Two
// instances: N <= 32 (R = 1) and 33 <= N <= 64 (R = 2).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

#include "warp_chol.cuh"

constexpr int kMaxN = 64;

// No register cap and spans of 16 (N <= 32) or 32 columns: on the H100 at
// N=32 the cap of 64 registers read 0.0096 ms against 0.0089 without, and
// at N=50 spans of 16 read 0.0205-0.0206 against 0.0202-0.0204.
template <int R>
__global__ void __launch_bounds__(32)
chol_small_warp_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float tile[];  // the matrix's tile, then its column buffers
  const int lane = threadIdx.x;
  const long long m = blockIdx.x;
  const int ld = n | 1;  // odd: the lanes reading down a column hit 32 banks
  float* colbuf = tile + (n * ld + 3) / 4 * 4;  // two column buffers, 16-byte aligned
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = a + m * nn;
  // the lower triangle's rows into the tile, coalesced, all in flight at once
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int c = lane + 32 * s;
      if (c <= i) cp_async4(tile + i * ld + c, src + i * n + c);
    }
  cp_async_wait_all();
  __syncwarp();

  float rows[R][32 * R], w[R], dg[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = lane + 32 * s;
#pragma unroll
    for (int c = 0; c < 32 * (s + 1); ++c) rows[s][c] = row < n && c <= row ? tile[row * ld + c] : 0.f;
    dg[s] = 1.f;
  }
  const bool ok =
      factor_rows<R, false, PositivePivots, 16 * R>(rows, w, dg, tile, colbuf, ld, n, lane, false);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int row = lane + 32 * s;
    if (row < n) tile[row * ld + row] = dg[s];
  }
  // L's rows out coalesced from the tile's upper triangle, zeros above
  __syncwarp();
  float* dst = out + m * nn;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int c = lane + 32 * s;
      if (c < n) dst[i * n + c] = !ok ? NAN : (c <= i ? tile[c * ld + i] : 0.f);
    }
}

}  // namespace

extern "C" int pacoh_chol_small(const float* a, float* out, int b, int n, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(warp_floats(n)) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    chol_small_warp_kernel<1><<<b, 32, bytes, st>>>(a, out, n);
  else
    chol_small_warp_kernel<2><<<b, 32, bytes, st>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local-memory bytes a thread (where spills and stack frames
// go) of the instance for N <= 32 (wide = 0) or 33 <= N <= 64.
extern "C" int pacoh_chol_small_usage(int wide, int* out, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = wide ? cudaFuncGetAttributes(&attr, chol_small_warp_kernel<2>)
             : cudaFuncGetAttributes(&attr, chol_small_warp_kernel<1>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
