// Blocked GP marginal-likelihood core for B independent N x N systems,
// 49 <= N <= 512, forward and backward, one block per system.
//
// Replaces the Pallas TPU kernels of meta_learning_pacoh_tpu/ops/pallas/
// blocked_mll_kernel.py: _mll_fwd_kernel (launched by _blocked_fwd_call)
// and _mll_bwd_kernel (launched by _blocked_bwd_call), the custom VJP
// blocked_mll_quad_logdet.
//
//   forward:  L = chol(Kn + j I) at the first jitter j of (0, 1e-4, 1e-2)
//             whose factorization succeeds (every pivot finite and
//             positive), chosen per system, the jitter on the whole
//             diagonal; a system that fails at every level comes back NaN.
//             z = L^-1 r,  quad = |z|^2,  logdet = 2 sum log diag L
//   backward: W = L^-1, alpha = W^T z,
//             dKn = gl W^T W - gq alpha alpha^T,  dr = 2 gq alpha
//
// What bounds it on the card: at bench.py's B=200, N=200 a system is 160 KB
// and about N^3/3 flops forward (the factor) and N^3/2 backward (the
// inverse, N^3/6, and K^-1, N^3/3), 1-1.3 GFLOP in all against 64 MB each
// way: the card's bound is about 20 us. This kernel is far from it: one
// block per system walks the columns in order with two barriers each, so it
// is bound by that chain, and 200 blocks fill the 132 SMs in two waves.
// The matrix lives in shared memory when it fits (N <= 235 with the odd
// leading dimension); above, the block works in place in its output buffer
// in device memory (1 MB at N=512, in L2). The backward inverts L in place
// and forms each row of dKn from W without a second N x N matrix: row a
// needs W's rows k >= a only, so in device memory it overwrites W's row a
// as soon as every thread has read it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxN = 512;

#include "blocked_factor.cuh"

// Shared-memory floats of a block, and whether its matrix is in shared
// memory; ops/cuda/blocked_mll_kernel.py (blocked_in_shared) states the same.
size_t vector_floats(int n) { return static_cast<size_t>(kPanel + 3) * n + 1; }

int in_shared(int n, int optin) {
  const size_t bytes = (static_cast<size_t>(n) * shared_ld(n) + vector_floats(n)) * sizeof(float);
  return bytes <= static_cast<size_t>(optin);
}

__global__ void __launch_bounds__(kThreads)
blocked_fwd_kernel(const float* __restrict__ kn, const float* __restrict__ r,
                   float* __restrict__ quad, float* __restrict__ logdet,
                   float* __restrict__ l_out, float* __restrict__ z_out, int n, int shared) {
  extern __shared__ float smem[];
  float* pcol = smem;             // kPanel * n
  float* z = pcol + kPanel * n;   // n
  float* red = z + 3 * n;         // 1
  const int sys = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(sys) * n * n;
  const float* a = kn + base;
  float* dst = l_out + base;
  float* m = shared ? red + 1 : dst;
  const int ld = shared ? shared_ld(n) : n;

  const int level = factor_escalated(m, n, ld, pcol, [&](float* w, float jit) {
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, k = idx % n;
      if (k <= i) w[i * ld + k] = a[idx] + ((i == k) ? jit : 0.f);
    }
  });
  if (level < 0) {
    const float nan = nanf("");
    for (int idx = tid; idx < n * n; idx += blockDim.x) dst[idx] = nan;
    for (int i = tid; i < n; i += blockDim.x) z_out[static_cast<size_t>(sys) * n + i] = nan;
    if (tid == 0) quad[sys] = logdet[sys] = nan;
    return;
  }
  const float q = forward_subst(m, n, ld, r + static_cast<size_t>(sys) * n, z, red);
  const float ld_val = logdet_lower(m, n, ld, red);
  if (tid == 0) {
    quad[sys] = q;
    logdet[sys] = ld_val;
  }
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, k = idx % n;
    dst[idx] = (k <= i) ? m[i * ld + k] : 0.f;
  }
  for (int i = tid; i < n; i += blockDim.x) z_out[static_cast<size_t>(sys) * n + i] = z[i];
}

__global__ void __launch_bounds__(kThreads)
blocked_bwd_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
                   const float* __restrict__ gq, const float* __restrict__ gl,
                   float* __restrict__ dkn, float* __restrict__ dr, int n, int shared) {
  extern __shared__ float smem[];
  float* col = smem;              // n (kPanel * n reserved, as the forward)
  float* z = col + kPanel * n;    // n
  float* alpha = z + n;           // n
  float* red = alpha + 2 * n;     // 1
  const int sys = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(sys) * n * n;
  const float* ls = l_in + base;
  float* out = dkn + base;
  float* m = shared ? red + 1 : out;
  const int ld = shared ? shared_ld(n) : n;

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, k = idx % n;
    if (k <= i) m[i * ld + k] = ls[idx];
  }
  for (int i = tid; i < n; i += blockDim.x) z[i] = z_in[static_cast<size_t>(sys) * n + i];
  __syncthreads();
  invert_lower(m, n, ld, col);
  wt_times(m, n, ld, z, alpha);

  const float g_q = gq[sys], g_l = gl[sys];
  for (int i = tid; i < n; i += blockDim.x) dr[static_cast<size_t>(sys) * n + i] = 2.f * g_q * alpha[i];
  // row a of dKn from W's rows k >= a; with n <= kThreads a thread owns column b
  const int b = tid;
  for (int a = 0; a < n; ++a) {
    float val = 0.f;
    if (b < n) val = g_l * kinv_entry(m, n, ld, a, b) - g_q * alpha[a] * alpha[b];
    __syncthreads();  // every thread has read W's row a
    if (b < n) out[static_cast<size_t>(a) * n + b] = val;
  }
}

int launch_setup(const void* kernel, int n, int device, int* shared, size_t* dyn) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *shared = in_shared(n, optin);
  *dyn = (vector_floats(n) + (*shared ? static_cast<size_t>(n) * shared_ld(n) : 0)) * sizeof(float);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*dyn));
  return static_cast<int>(err);
}

}  // namespace

extern "C" int pacoh_blocked_mll_fwd(const float* kn, const float* r, float* quad, float* logdet,
                                     float* l_out, float* z_out, int b, int n, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int shared = 0;
  size_t dyn = 0;
  const int e = launch_setup(reinterpret_cast<const void*>(blocked_fwd_kernel), n, device,
                             &shared, &dyn);
  if (e != 0) return e;
  blocked_fwd_kernel<<<b, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      kn, r, quad, logdet, l_out, z_out, n, shared);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pacoh_blocked_mll_bwd(const float* l, const float* z, const float* gq,
                                     const float* gl, float* dkn, float* dr, int b, int n,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int shared = 0;
  size_t dyn = 0;
  const int e = launch_setup(reinterpret_cast<const void*>(blocked_bwd_kernel), n, device,
                             &shared, &dyn);
  if (e != 0) return e;
  blocked_bwd_kernel<<<b, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      l, z, gq, gl, dkn, dr, n, shared);
  return static_cast<int>(cudaGetLastError());
}
