// Stein variational transport with the RBF kernel and the median-heuristic
// bandwidth, for K particles of P parameters, in one block.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// svgd_kernel.py (_svgd_kernel, launched by _svgd_phi_call):
//
//   d2     = |x_i|^2 + |x_j|^2 - 2 x_i.x_j, clamped at 0
//   median = the order statistic of d2's K*K entries at 0-based rank K*K/2
//            (the upper middle for an even count, as the TPU kernel's
//            bisection converges to; not numpy's midpoint average)
//   gamma  = 1 / (1e-8 + 2h),  h = median / (2 log(K+1))
//   K_xx   = exp(-gamma d2)
//   phi    = (K_xx S + 2 gamma (X * rowsum(K_xx) - K_xx X)) / K
//
// What bounds it on the card: at the slice's K=10, P=2372 the kernel reads
// X twice and S once (about 0.3 MB) and does about 1e6 flops, so a single
// block is bound by its own latency (the Gram reduction, the selection and
// four barriers), not by bandwidth or flops. One block keeps the K x K
// intermediates in shared memory and needs no second pass; the median is an
// exact selection (each of the K*K entries counts the entries below it),
// which at K*K <= 1024 costs less than bisection and has no tolerance.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
svgd_phi_kernel(const float* __restrict__ x, const float* __restrict__ s,
                float* __restrict__ phi, int k, int p, float log_kp1) {
  __shared__ float gram[kMaxK * kMaxK];
  __shared__ float d2[kMaxK * kMaxK];
  __shared__ float kxx[kMaxK * kMaxK];
  __shared__ float row_sum[kMaxK];
  __shared__ float median;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int kk = k * k;

  // Gram matrix X X^T: one warp per pair (i <= j), lanes stride over P.
  for (int pair = warp; pair < kk; pair += n_warps) {
    const int i = pair / k, j = pair % k;
    if (j < i) continue;  // uniform across the warp
    float acc = 0.f;
    for (int c = lane; c < p; c += 32) acc += x[i * p + c] * x[j * p + c];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      gram[i * k + j] = acc;
      gram[j * k + i] = acc;
    }
  }
  if (tid == 0) median = nanf("");  // stays NaN only if d2 holds a NaN
  __syncthreads();

  for (int q = tid; q < kk; q += blockDim.x) {
    const int i = q / k, j = q % k;
    d2[q] = fmaxf(gram[i * k + i] + gram[j * k + j] - 2.f * gram[q], 0.f);
  }
  __syncthreads();

  // Exact selection of the entry at rank kk/2: the value v with
  // #(d2 < v) <= rank < #(d2 <= v). Ties write the same value.
  const int rank = kk / 2;
  for (int q = tid; q < kk; q += blockDim.x) {
    const float v = d2[q];
    int less = 0, less_eq = 0;
    for (int t = 0; t < kk; ++t) {
      const float w = d2[t];
      less += (w < v);
      less_eq += (w <= v);
    }
    if (less <= rank && rank < less_eq) median = v;
  }
  __syncthreads();

  const float h = median / (2.f * log_kp1);
  const float gamma = 1.f / (1e-8f + 2.f * h);
  for (int q = tid; q < kk; q += blockDim.x) kxx[q] = expf(-gamma * d2[q]);
  __syncthreads();
  if (tid < k) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += kxx[tid * k + j];
    row_sum[tid] = acc;
  }
  __syncthreads();

  // phi: one thread per parameter column, the K-column of X and S held in
  // registers (the unrolled, guarded loops keep the arrays out of local
  // memory).
  const float two_gamma = 2.f * gamma;
  const float kf = static_cast<float>(k);
  for (int c = tid; c < p; c += blockDim.x) {
    float xs[kMaxK], ss[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        xs[j] = x[j * p + c];
        ss[j] = s[j * p + c];
      }
    }
    for (int i = 0; i < k; ++i) {
      float ks = 0.f, kx = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
          const float w = kxx[i * k + j];
          ks += w * ss[j];
          kx += w * xs[j];
        }
      }
      phi[i * p + c] = (ks + two_gamma * (x[i * p + c] * row_sum[i] - kx)) / kf;
    }
  }
}

}  // namespace

extern "C" int pacoh_svgd_phi(const float* x, const float* s, float* phi, int k,
                              int p, float log_kp1, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || p < 1) return static_cast<int>(cudaErrorInvalidValue);
  svgd_phi_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, s, phi, k, p, log_kp1);
  return static_cast<int>(cudaGetLastError());
}
