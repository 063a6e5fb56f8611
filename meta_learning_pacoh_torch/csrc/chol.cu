// Batched Cholesky factor L of B matrices A [B, N, N], one block per matrix,
// reading only the lower triangle of A and writing zeros above the diagonal.
// No jitter: a matrix whose pivot is not finite and positive comes back all
// NaN, and safe_cholesky escalates the jitter around the call.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// blocked_mll_kernel.py: _chol_only_kernel (launched by _chol_only_call,
// entry blocked_cholesky).
//
// What bounds it on the card: at the slice's eval shape, N=200 and B=2000
// (200 test tasks x 10 particles), a matrix is 160 KB and N^3/3 = 2.7e6
// flops, 5.3e9 for the batch: about 0.1 ms of the card's f32 rate and 0.2 ms
// of its bandwidth, so the floor is far below what this kernel takes. It is
// bound by the sequential column steps of one block, with one block per SM.
// The matrix lives in shared memory up to the opt-in limit (227 KB, N <= 231
// here) and is factored in place; above that the block factors in place in
// the output buffer in device memory. Right-looking in panels of kPanel
// columns: the panel's columns are factored one by one (two barriers each),
// then the trailing matrix takes one rank-kPanel update, so each trailing
// element is read and written once per panel instead of once per column.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 512;
constexpr int kPanel = 8;

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const float* __restrict__ a, float* __restrict__ out, int n,
            int in_shared) {
  extern __shared__ float smem[];
  __shared__ float pcol[kPanel][kMaxN];  // the current panel's factored columns

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kThreads >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const float* src = a + base;
  float* dst = out + base;
  float* m = in_shared ? smem : dst;

  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, k = idx % n;
    if (k <= i) m[idx] = src[idx];
  }
  __syncthreads();

  // Every thread reads the same pivot, which no thread writes before the
  // next barrier, so `failed` and the breaks below are uniform.
  bool failed = false;
  for (int j0 = 0; j0 < n && !failed; j0 += kPanel) {
    const int jb = min(kPanel, n - j0);
    const int j_end = j0 + jb;
    for (int t = 0; t < jb; ++t) {
      const int j = j0 + t;
      const float d = sqrtf(m[j * n + j]);
      if (!(d > 0.f && d < INFINITY)) {
        failed = true;
        break;
      }
      for (int i = j + tid; i < n; i += kThreads)
        pcol[t][i] = (i == j) ? d : m[i * n + j] / d;
      __syncthreads();
      for (int i = j + tid; i < n; i += kThreads) m[i * n + j] = pcol[t][i];
      // the panel's later columns c in (j, j_end), rows i >= c
      for (int i = j + 1 + warp; i < n; i += n_warps) {
        const float ci = pcol[t][i];
        const int c_end = min(i + 1, j_end);
        for (int c = j + 1 + lane; c < c_end; c += 32) m[i * n + c] -= ci * pcol[t][c];
      }
      __syncthreads();
    }
    if (failed) break;
    // trailing lower triangle: a warp per row, lanes along the row
    for (int r = j_end + warp; r < n; r += n_warps) {
      float pr[kPanel];
#pragma unroll
      for (int t = 0; t < kPanel; ++t) pr[t] = (t < jb) ? pcol[t][r] : 0.f;
      float* row = m + r * n;
      for (int c = j_end + lane; c <= r; c += 32) {
        float acc = row[c];
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          if (t < jb) acc -= pr[t] * pcol[t][c];
        row[c] = acc;
      }
    }
    __syncthreads();
  }
  __syncthreads();

  const float nan = nanf("");
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, k = idx % n;
    dst[idx] = failed ? nan : ((k <= i) ? m[idx] : 0.f);
  }
}

template <int kThreads>
int launch(const float* a, float* out, int b, int n, int device, cudaStream_t stream) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t static_bytes = sizeof(float) * kPanel * kMaxN;
  const size_t bytes = static_cast<size_t>(n) * n * sizeof(float);
  const int in_shared = bytes + static_bytes <= static_cast<size_t>(optin);
  const size_t dyn = in_shared ? bytes : 0;
  if (in_shared) {
    err = cudaFuncSetAttribute(chol_kernel<kThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_kernel<kThreads><<<b, kThreads, dyn, stream>>>(a, out, n, in_shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pacoh_chol(const float* a, float* out, int b, int n, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  // measured on the H100: 1024 threads win at N=200, 512 at N=70
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n >= 128 ? launch<1024>(a, out, b, n, device, s) : launch<512>(a, out, b, n, device, s);
}
