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
// way: the card's bound is about 20 us (bytes). Both are far from it: one
// block per system walks a factorization's chain of dependent steps.
//
// The forward factors with the tiled design of csrc/tiled_chol.cuh: panels
// of 32 columns at three barriers each, trailing updates from register
// micro-tiles, the lower triangle packed in shared memory so that two
// blocks share an SM up to N=207 (bench.py's 200 systems run in one wave of
// 264 slots), loaded by cp.async, and r carried as the border row N, so
// that z = L^-1 r comes out of the factorization with no serial forward
// substitution. Each escalation level reloads the pristine system; the
// jitter goes on the whole diagonal as each diagonal tile is factored. Up
// to N=307 the triangle is in shared memory; above, the block works in
// place in its output L in device memory (L2-resident) and in z.
//
// The backward keeps the column-at-a-time algebra of csrc/blocked_factor.cuh
// (one block of 512 threads per system, bound by that chain): the matrix
// lives in shared memory when it fits (N <= 235 with the odd leading
// dimension); above, the block works in place in its output buffer in
// device memory (1 MB at N=512, in L2). It inverts L in place and forms each
// row of dKn from W without a second N x N matrix: row a needs W's rows
// k >= a only, so in device memory it overwrites W's row a as soon as every
// thread has read it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;      // the backward
constexpr int kFwdThreads = 256;   // the forward, two blocks an SM
constexpr int kMaxN = 512;

#include "blocked_factor.cuh"
#include "tiled_chol.cuh"

// Shared-memory floats of a backward block, and whether its matrix is in
// shared memory; ops/cuda/blocked_mll_kernel.py (blocked_bwd_in_shared)
// states the same.
size_t vector_floats(int n) { return static_cast<size_t>(kPanel + 3) * n + 1; }

int in_shared(int n, int optin) {
  const size_t bytes = (static_cast<size_t>(n) * shared_ld(n) + vector_floats(n)) * sizeof(float);
  return bytes <= static_cast<size_t>(optin);
}

__global__ void __launch_bounds__(kFwdThreads, 2)
blocked_fwd_kernel(const float* __restrict__ kn, const float* __restrict__ r,
                   float* __restrict__ quad, float* __restrict__ logdet,
                   float* __restrict__ l_out, float* __restrict__ z_out, int n, int packed) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int sys = blockIdx.x, tid = threadIdx.x;
  const size_t base = static_cast<size_t>(sys) * n * n;
  float* dst = l_out + base;
  float* z = z_out + static_cast<size_t>(sys) * n;
  const float* rs = r + static_cast<size_t>(sys) * n;
  // the system with r as its border row N
  const TiledMatrix m{packed ? smem + tiled_scratch_floats(n, n + 1) : dst, z, n, n + 1,
                      packed != 0};
  bool ok = false;
  for (int level = 0; level < 3 && !ok; ++level) {
    tiled_load(m, kn + base, rs);
    ok = tiled_factor(m, level == 0 ? 0.f : (level == 1 ? 1e-4f : 1e-2f), smem);
  }
  const float* zr = m.row(n);
  if (tid < 32) {  // quad = |z|^2, logdet = 2 sum log diag L, in one fixed order
    float q = 0.f, s = 0.f;
    for (int i = tid; ok && i < n; i += 32) {
      q += zr[i] * zr[i];
      s += logf(m.row(i)[i]);
    }
    q = warp_sum(q);
    s = warp_sum(s);
    if (tid == 0) {
      quad[sys] = ok ? q : nanf("");
      logdet[sys] = ok ? 2.f * s : nanf("");
    }
  }
  __syncthreads();
  tiled_store(m, dst, ok);
  if (packed || !ok)
    for (int i = tid; i < n; i += blockDim.x) z[i] = ok ? zr[i] : nanf("");
}

__global__ void __launch_bounds__(kThreads)
blocked_bwd_kernel(const float* __restrict__ l_in, const float* __restrict__ z_in,
                   const float* __restrict__ gq, const float* __restrict__ gl,
                   float* __restrict__ dkn, float* __restrict__ dr, int n, int shared) {
  extern __shared__ float smem[];
  float* col = smem;              // n (kPanel * n reserved)
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
  int packed = 0;
  size_t dyn = 0;
  const int e = tiled_setup(blocked_fwd_kernel, n, n + 1, device, &packed, &dyn);
  if (e != 0) return e;
  blocked_fwd_kernel<<<b, kFwdThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      kn, r, quad, logdet, l_out, z_out, n, packed);
  return static_cast<int>(cudaGetLastError());
}

// Resident forward blocks per SM at this N, into *blocks.
extern "C" int pacoh_blocked_mll_fwd_blocks_per_sm(int n, int* blocks, int device, void* stream) {
  (void)stream;
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  return tiled_blocks_per_sm(blocked_fwd_kernel, kFwdThreads, n, n + 1, device, blocks);
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
