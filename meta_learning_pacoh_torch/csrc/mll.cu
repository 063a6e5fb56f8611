// Batched GP marginal-likelihood core for B independent N x N systems, one
// block per system, forward and backward.
//
// Replaces the Pallas TPU kernels of meta_learning_pacoh_tpu/ops/pallas/
// mll_kernel.py: _mll_fwd_kernel (launched by _mll_fwd_call) and
// _mll_bwd_kernel (launched by _mll_bwd_call).
//
//   forward:  L = chol(Kn + j I) for the first jitter j of (0, 1e-4, 1e-2)
//             whose factor has a finite positive diagonal (the last level is
//             taken regardless), chosen per system;
//             z = L^{-1} r,  quad = |z|^2,  logdet = 2 sum log diag L
//   backward: alpha = L^{-T} z,  W = L^{-1},
//             dKn = gl W^T W - gq alpha alpha^T,  dr = 2 gq alpha
//
// What bounds it on the card: at the slice's B=200, N=20 a system is 1.6 KB
// and about 3e3 flops, so each block is bound by its barrier chain (one or
// two per column), not by bandwidth or flops; the batch gives 200 blocks,
// more than the 132 SMs. The TPU kernel put 128 systems in the lanes of one
// vector op; here a block owns one system in shared memory (N <= 64 is at
// most 16 KB a matrix) and its threads share each column's update. The
// escalation levels run only when the previous one failed, so a healthy
// system factors once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Right-looking Cholesky of the lower triangle of m (n x n, row-major, shared),
// in place. Returns (to every thread) whether each pivot gave a finite positive
// diagonal. With stop_early the loop ends at the first failed pivot.
__device__ bool factor_lower(float* m, int n, bool stop_early, float* col, int* bad) {
  const int tid = threadIdx.x;
  if (tid == 0) *bad = 0;
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float d = sqrtf(m[j * n + j]);
    if (tid == 0 && !(d > 0.f && d < INFINITY)) *bad = 1;
    for (int i = j + tid; i < n; i += blockDim.x) {
      const float v = (i == j) ? d : m[i * n + j] / d;
      col[i] = v;
    }
    __syncthreads();
    if (stop_early && *bad) return false;
    for (int i = j + tid; i < n; i += blockDim.x) m[i * n + j] = col[i];
    const int w = n - j - 1;
    for (int idx = tid; idx < w * w; idx += blockDim.x) {
      const int a = j + 1 + idx / w, b = j + 1 + idx % w;
      if (b <= a) m[a * n + b] -= col[a] * col[b];
    }
    __syncthreads();
  }
  return *bad == 0;
}

__global__ void __launch_bounds__(kThreads)
mll_fwd_kernel(const float* __restrict__ kn, const float* __restrict__ r,
               float* __restrict__ quad, float* __restrict__ logdet,
               float* __restrict__ l_out, float* __restrict__ z_out, int n) {
  extern __shared__ float smem[];
  float* m = smem;            // n * n
  float* col = m + n * n;     // n
  float* z = col + n;         // n
  __shared__ int bad;

  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const float* a = kn + static_cast<size_t>(sys) * n * n;
  const float jitters[3] = {0.f, 1e-4f, 1e-2f};

  for (int level = 0; level < 3; ++level) {
    const float jit = jitters[level];
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, k = idx % n;
      m[idx] = a[idx] + ((i == k) ? jit : 0.f);
    }
    __syncthreads();
    const bool last = level == 2;
    if (factor_lower(m, n, !last, col, &bad) || last) break;
  }

  // z = L^{-1} r by forward substitution in warp 0; quad and logdet.
  if (tid < 32) {
    const float* rr = r + static_cast<size_t>(sys) * n;
    float q = 0.f, ld = 0.f;
    for (int i = 0; i < n; ++i) {
      float part = 0.f;
      for (int k = tid; k < i; k += 32) part += m[i * n + k] * z[k];
      part = warp_sum(part);
      if (tid == 0) {
        const float zi = (rr[i] - part) / m[i * n + i];
        z[i] = zi;
        q += zi * zi;
        ld += logf(m[i * n + i]);
      }
      __syncwarp();
    }
    if (tid == 0) {
      quad[sys] = q;
      logdet[sys] = 2.f * ld;
    }
  }
  __syncthreads();

  float* lo = l_out + static_cast<size_t>(sys) * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, k = idx % n;
    lo[idx] = (k <= i) ? m[idx] : 0.f;
  }
  for (int i = tid; i < n; i += blockDim.x) z_out[static_cast<size_t>(sys) * n + i] = z[i];
}

__global__ void __launch_bounds__(kThreads)
mll_bwd_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
               const float* __restrict__ gq, const float* __restrict__ gl,
               float* __restrict__ dkn, float* __restrict__ dr, int n) {
  extern __shared__ float smem[];
  float* l = smem;            // n * n
  float* w = l + n * n;       // n * n, W = L^{-1} (lower)
  float* alpha = w + n * n;   // n

  const int sys = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ls = l_in + static_cast<size_t>(sys) * n * n;
  const float* zs = z_in + static_cast<size_t>(sys) * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) l[idx] = ls[idx];
  __syncthreads();

  // alpha = L^{-T} z by back substitution in warp 0.
  if (tid < 32) {
    for (int i = n - 1; i >= 0; --i) {
      float part = 0.f;
      for (int k = i + 1 + tid; k < n; k += 32) part += l[k * n + i] * alpha[k];
      part = warp_sum(part);
      if (tid == 0) alpha[i] = (zs[i] - part) / l[i * n + i];
      __syncwarp();
    }
  }
  // W = L^{-1}: thread c solves L w = e_c for column c (zero above row c).
  for (int c = tid; c < n; c += blockDim.x) {
    for (int i = 0; i < c; ++i) w[i * n + c] = 0.f;
    for (int i = c; i < n; ++i) {
      float acc = (i == c) ? 1.f : 0.f;
      for (int k = c; k < i; ++k) acc -= l[i * n + k] * w[k * n + c];
      w[i * n + c] = acc / l[i * n + i];
    }
  }
  __syncthreads();

  const float g_q = gq[sys], g_l = gl[sys];
  float* out = dkn + static_cast<size_t>(sys) * n * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int a = idx / n, b = idx % n;
    float kinv = 0.f;
    for (int k = (a > b ? a : b); k < n; ++k) kinv += w[k * n + a] * w[k * n + b];
    out[idx] = g_l * kinv - g_q * alpha[a] * alpha[b];
  }
  for (int i = tid; i < n; i += blockDim.x)
    dr[static_cast<size_t>(sys) * n + i] = 2.f * g_q * alpha[i];
}

}  // namespace

extern "C" int pacoh_mll_fwd(const float* kn, const float* r, float* quad,
                             float* logdet, float* l_out, float* z_out, int b,
                             int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(n * n + 2 * n) * sizeof(float);
  mll_fwd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      kn, r, quad, logdet, l_out, z_out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pacoh_mll_bwd(const float* l, const float* z, const float* gq,
                             const float* gl, float* dkn, float* dr, int b, int n,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * n * n + n) * sizeof(float);
  mll_bwd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      l, z, gq, gl, dkn, dr, n);
  return static_cast<int>(cudaGetLastError());
}
