// Batched Cholesky factorization of small matrices, 1 <= N <= 64 (the port
// sends 32 <= N <= 64 here): one warp per matrix.
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
// out; at the eval's B=200, N=50 that is 8.3 MFLOP against 4 MB, a few
// microseconds of either at the card's peaks. What sets its time is the
// serial chain of N pivots a matrix, each a shuffle-free broadcast read, a
// column scale and a trailing update of (N - j) columns over a lane's rows.
// The design: the lane-major TPU layout filled vector lanes with 128
// matrices; here a warp owns one matrix, held in shared memory with an odd
// leading dimension (N | 1), so the 32 lanes walking down a column hit 32
// banks. Lane l owns rows l and l + 32. All lanes read the pivot and the
// entries of column j at one address (a broadcast); __syncwarp orders the
// column's writes before the update reads them. No block barrier: a block
// holds several independent warps, as many as 48 KB of shared memory takes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxWarps = 8;
constexpr int kSmemBytes = 48 * 1024;

__global__ void chol_small_kernel(const float* __restrict__ a, float* __restrict__ out, int b,
                                  int n, int ld, int warps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long m = static_cast<long long>(blockIdx.x) * warps + warp;
  if (m >= b) return;  // the block has no barrier, so a spare warp may leave
  float* A = smem + static_cast<size_t>(warp) * n * ld;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = a + m * nn;
  float* dst = out + m * nn;

  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    if (j <= i) A[i * ld + j] = src[e];
  }
  __syncwarp();

  const int r0 = lane, r1 = lane + 32;
  bool ok = true;
  for (int j = 0; j < n; ++j) {
    const float d = A[j * ld + j];  // every lane reads the same pivot
    if (!(d > 0.f && d < INFINITY)) {
      ok = false;
      break;
    }
    const float p = sqrtf(d);
    const float inv = 1.f / p;
    __syncwarp();  // the pivot is read before its owner overwrites it
    float l0 = 0.f, l1 = 0.f;
    if (r0 == j) A[j * ld + j] = p;
    if (r1 == j) A[j * ld + j] = p;
    if (r0 > j && r0 < n) {
      l0 = A[r0 * ld + j] * inv;
      A[r0 * ld + j] = l0;
    }
    if (r1 > j && r1 < n) {
      l1 = A[r1 * ld + j] * inv;
      A[r1 * ld + j] = l1;
    }
    __syncwarp();  // column j is final before the update reads it
    for (int c = j + 1; c < n; ++c) {
      const float lc = A[c * ld + j];
      if (r0 >= c && r0 < n) A[r0 * ld + c] -= l0 * lc;
      if (r1 >= c && r1 < n) A[r1 * ld + c] -= l1 * lc;
    }
    __syncwarp();
  }

  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - i * n;
    dst[e] = !ok ? NAN : (j <= i ? A[i * ld + j] : 0.f);
  }
}

}  // namespace

extern "C" int pacoh_chol_small(const float* a, float* out, int b, int n, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = n | 1;  // odd: a warp down a column touches 32 banks
  const int per_warp = n * ld * static_cast<int>(sizeof(float));
  int warps = kSmemBytes / per_warp;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const int blocks = (b + warps - 1) / warps;
  chol_small_kernel<<<blocks, warps * 32, static_cast<size_t>(warps) * per_warp,
                      static_cast<cudaStream_t>(stream)>>>(a, out, b, n, ld, warps);
  return static_cast<int>(cudaGetLastError());
}
