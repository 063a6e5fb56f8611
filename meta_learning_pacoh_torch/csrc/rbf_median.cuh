// The median heuristic's pieces on K particles' pair distances, shared by
// the Stein transport kernel K1 (svgd_phi.cu) and the fused SVGD kernels
// (through fused_update.cuh): the pairs' order, the median from the pairs
// and the RBF kernel's gamma. Their arithmetic stays fixed, so that every
// kernel sharing them keeps its bits.
//
// Included inside an anonymous namespace of each kernel's source.

#pragma once

// Index of the pair (i, j), i < j, of K particles in the row-major list of
// the K (K - 1) / 2 pairs (0,1), (0,2), .., (0,K-1), (1,2), ..
__device__ __forceinline__ int pair_index(int i, int j, int K) {
  return i * K - i * (i + 1) / 2 + (j - i - 1);
}

// median_upper of a K x K matrix of squared distances that is exactly
// symmetric with a zero diagonal, from its K (K - 1) / 2 pair values d2p
// (pair_index order): each pair counts twice and the diagonal K zeros, so
// the value is median_upper's on the whole matrix, from a quarter of its
// comparisons. slot: one shared float.
__device__ float median_upper_pairs(const float* d2p, int n_pairs, int K, float* slot) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (tid == 0) *slot = nanf("");
  __syncthreads();
  const int rank = K * K / 2;
  for (int c = tid; c <= n_pairs; c += nth) {
    const float val = c < n_pairs ? d2p[c] : 0.f;  // the last candidate: the diagonal's 0
    int less = 0, less_eq = 0;
    for (int u = 0; u < n_pairs; ++u) {
      less += d2p[u] < val;
      less_eq += d2p[u] <= val;
    }
    less = 2 * less + (val > 0.f ? K : 0);
    less_eq = 2 * less_eq + (val >= 0.f ? K : 0);
    if (less <= rank && rank < less_eq) *slot = val;
  }
  __syncthreads();
  return *slot;
}

// gamma of the RBF kernel exp(-gamma d2) at bandwidth med / (2 log(K+1)).
__device__ __forceinline__ float rbf_gamma(float med, float log_kp1) {
  const float bw = med / (2.f * log_kp1);
  return 1.f / (1e-8f + 2.f * bw);
}
