// The update stage shared by the fused training kernels: the SVGD kernels'
// median heuristic, Stein transport and Adam (fused_svgd.cu, B2, and
// fused_svgd_bign.cu, B10), and the VI kernels' block sum and Adam
// (fused_vi.cu, B7, and fused_vi_bign.cu, B11). The counterparts of
// make_transport_section and the optax-exact Adam of
// meta_learning_pacoh_tpu/ops/pallas/fused_train_kernel.py. The arithmetic
// of each function stays fixed, so that the kernels sharing it keep their
// bits; B2 selects its median from the pairs (median_upper_pairs, the same
// value as median_upper's).
//
// Included inside an anonymous namespace of each kernel's source, after its
// Adam constants kB1, kB2, kEps, kOneMinusB1, kOneMinusB2. The median from
// the pairs and the RBF bandwidth are in rbf_median.cuh, which it includes.

#include "rbf_median.cuh"

// The block's sum of one value a thread, in one fixed order (the same in
// every block); every thread receives it. red: [32] shared floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < n_warps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// One optax Adam step of one coordinate on gradient g, bias corrections bc1,
// bc2 of the step.
__device__ __forceinline__ void adam(float g, float& theta, float& m, float& v, float lr, float bc1,
                                     float bc2) {
  const float mn = kB1 * m + kOneMinusB1 * g;
  const float vn = kB2 * v + kOneMinusB2 * g * g;
  m = mn;
  v = vn;
  theta -= lr * ((mn / bc1) / (sqrtf(vn / bc2) + kEps));
}

// The K x K squared distances d2s (shared, kk = K*K entries) at rank kk/2
// (the upper middle) by exact selection, to every thread; NaN only if d2s
// holds a NaN. slot: one shared float.
__device__ float median_upper(const float* d2s, int kk, float* slot) {
  const int tid = threadIdx.x, nth = blockDim.x;
  if (tid == 0) *slot = nanf("");
  __syncthreads();
  const int rank = kk / 2;
  for (int c = tid; c < kk; c += nth) {
    const float val = d2s[c];
    int less = 0, less_eq = 0;
    for (int u = 0; u < kk; ++u) {
      less += (d2s[u] < val);
      less_eq += (d2s[u] <= val);
    }
    if (less <= rank && rank < less_eq) *slot = val;
  }
  __syncthreads();
  return *slot;
}

// One coordinate of one particle: the Stein transport phi = (sum_j kw_j s_j
// + 2 gamma (x sum_j kw_j - sum_j kw_j x_j)) / K over the particle's kernel
// row kw [K] (row_sum its sum), then Adam on g = -phi. score(j) and
// particle(j) give the coordinate of particle j; x is this particle's.
// Returns the updated coordinate.
template <class Score, class Particle>
__device__ __forceinline__ float transport_adam(const float* kw, int K, float row_sum,
                                                float two_gamma, float x, Score score,
                                                Particle particle, float& m, float& v, float lr,
                                                float bc1, float bc2) {
  float ks = 0.f, kx = 0.f;
  for (int j = 0; j < K; ++j) {
    ks += kw[j] * score(j);
    kx += kw[j] * particle(j);
  }
  const float phi = (ks + two_gamma * (x * row_sum - kx)) / static_cast<float>(K);
  adam(-phi, x, m, v, lr, bc1, bc2);
  return x;
}

// transport_adam with the K particles' coordinate and score read from
// device memory written in this launch (particle[j * stride], score[j *
// stride], through L2), sixteen particles' loads in flight at a time: the
// same arithmetic in the same order.
__device__ __forceinline__ float transport_adam_l2(const float* kw, int K, float row_sum,
                                                   float two_gamma, float x, const float* score,
                                                   const float* particle, size_t stride,
                                                   float& m, float& v, float lr, float bc1,
                                                   float bc2) {
  float ks = 0.f, kx = 0.f;
  for (int j0 = 0; j0 < K; j0 += 16) {
    float sv[16], xv[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (j0 + u < K) {
        sv[u] = __ldcg(score + (j0 + u) * stride);
        xv[u] = __ldcg(particle + (j0 + u) * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (j0 + u < K) {
        ks += kw[j0 + u] * sv[u];
        kx += kw[j0 + u] * xv[u];
      }
    }
  }
  const float phi = (ks + two_gamma * (x * row_sum - kx)) / static_cast<float>(K);
  adam(-phi, x, m, v, lr, bc1, bc2);
  return x;
}
