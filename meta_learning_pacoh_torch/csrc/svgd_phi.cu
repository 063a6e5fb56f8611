// Stein variational transport with the RBF kernel and the median-heuristic
// bandwidth, for K particles of P parameters, over one thread-block cluster;
// S such systems (stacked fits: seeds or trials, x [S, K, P]) in one launch,
// one cluster a system.
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
// What bounds it on the card: it must read X and S and write phi, 3 K P
// floats (85 ns of device memory at the general step's K=10, P=2372), and
// does about 7 K^2 P flops (a few ns). Neither is near: one block on one SM
// (the first design) was bound by its own latency, a serial 75-step strided
// loop a Gram pair over device memory and X read a second time for phi.
// The design spreads P over the C CTAs of one cluster (ops/cuda/
// svgd_kernel.py's svgd_plan: C <= 16, 16 with the non-portable attribute):
// CTA r owns the contiguous columns [r * slice, (r + 1) * slice) of P and
// copies its K x slice of X and S into shared memory once (16-byte cp.async
// where every row is aligned, else 4-byte; S's copy lands during the K x K
// work), forms the partial Gram of the K (K + 1) / 2 pairs over its slice
// (a warp four pairs), and after one cluster barrier sums the C partials in rank
// order over distributed shared memory, so every CTA holds the same bits of
// the whole Gram (no float atomics: two calls give the same bits). Each CTA
// then repeats the K x K work for itself (d2 with an exactly zero diagonal,
// rbf_median.cuh's median_upper_pairs and rbf_gamma, K_xx, row sums) and
// writes phi for its own slice from shared memory, coalesced. A cluster
// barrier's arrive after the remote reads and its wait before the exit keep
// every CTA's shared memory alive while another reads it. Where a slice of
// X and S does not fit in shared memory (K P in the hundreds of thousands),
// the CTAs read their slices from device memory instead (the plan's
// `staged` = 0), with the same arithmetic.
//
// A seed axis (the counterpart of the Pallas call under jax.vmap, whose
// batching rule adds a grid axis): the grid is (C, S) with clusters of
// (C, 1, 1), so cluster y = blockIdx.y owns system y, offsets x, s and phi
// by y K P and takes its own median. Each cluster's arithmetic is the
// single system's, so S = 1 gives the same bits as a [K, P] call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 32;
constexpr int kMaxPairs = kMaxK * (kMaxK + 1) / 2;
constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxStagedBytes = 200 * 1024;  // X and S slices: svgd_kernel.py MAX_STAGED_BYTES

#include "cluster_util.cuh"
#include "rbf_median.cuh"

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Copy rows [K][w] of src (row stride p, from column lo) into dst (row
// stride ld, a multiple of 4) by cp.async; 16-byte copies when `vec`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int k, int p, int lo,
                                           int w, int ld, bool vec) {
  const int tid = threadIdx.x;
  const int w4 = vec ? w / 4 : 0;  // 16-byte chunks a row
  for (int e = tid; e < k * w4; e += blockDim.x) {
    const int i = e / w4, v = 4 * (e - i * w4);
    cp_async16(dst + i * ld + v, src + static_cast<size_t>(i) * p + lo + v);
  }
  const int tail = w - 4 * w4;  // the scalar rest of each row
  for (int e = tid; e < k * tail; e += blockDim.x) {
    const int i = e / tail, v = 4 * w4 + (e - i * tail);
    cp_async4(dst + i * ld + v, src + static_cast<size_t>(i) * p + lo + v);
  }
}

// The q-th pair (i <= j) of K particles, row by row: (0,0), (0,1), .., (0,K-1), (1,1), ..
__device__ __forceinline__ void pair_of(int q, int k, int& i, int& j) {
  for (i = 0; q >= k - i; ++i) q -= k - i;
  j = i + q;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
svgd_phi_cluster_kernel(const float* __restrict__ x, const float* __restrict__ s,
                        float* __restrict__ phi, int k, int p, int slice, float log_kp1) {
  extern __shared__ __align__(16) float stage[];  // X, then S: [K][slice] each
  __shared__ float partial[kMaxPairs];            // this CTA's Gram pairs (i <= j)
  __shared__ float gram[kMaxK * kMaxK];
  __shared__ float d2p[kMaxPairs];                // the pairs i < j, pair_index order
  __shared__ __align__(16) float kxx[kMaxK * kMaxK];  // rows of 32, zero past K
  __shared__ float row_sum[kMaxK];
  __shared__ float slot;

  cg::cluster_group cluster = cg::this_cluster();
  const size_t system = static_cast<size_t>(blockIdx.y) * k * p;  // this cluster's [K, P]
  x += system;
  s += system;
  phi += system;
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int lo = min(rank * slice, p);
  const int w = min(p, lo + slice) - lo;  // this CTA's columns; the last may be ragged or empty

  // The slice's X, each row at stride ld, then the partial Gram. S's copy is
  // issued after the first cluster barrier (whose release would otherwise
  // wait for it) and lands during the K x K work.
  const float* xs = x + lo;
  const float* ss = s + lo;
  int ld = p;
  const bool vec = (p & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(s)) & 15) == 0;
  if constexpr (kStaged) {
    stage_rows(stage, x, k, p, lo, w, slice, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    xs = stage;
    ld = slice;
  }

  // The partial Gram of the pairs (i <= j) over the slice: a warp four pairs
  // in one pass over the columns (the lanes over the columns), then four
  // shuffle trees side by side, each in one fixed order.
  const int n_pairs = k * (k + 1) / 2;
  for (int q0 = 4 * warp; q0 < n_pairs; q0 += 4 * n_warps) {
    int pi[4], pj[4];
    pair_of(q0, k, pi[0], pj[0]);
#pragma unroll
    for (int u = 1; u < 4; ++u) {  // the next pairs, row by row
      const bool wrap = pj[u - 1] == k - 1;
      pi[u] = wrap ? pi[u - 1] + 1 : pi[u - 1];
      pj[u] = wrap ? pi[u] : pj[u - 1] + 1;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = lane; c < w; c += 32) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < n_pairs) acc[u] += xs[pi[u] * ld + c] * xs[pj[u] * ld + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += __shfl_down_sync(0xffffffffu, acc[u], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (q0 + u < n_pairs) partial[q0 + u] = acc[u];
    }
  }
  cluster.sync();  // every CTA's partials written
  if constexpr (kStaged) {
    stage_rows(stage + k * slice, s, k, p, lo, w, slice, vec);
    cp_async_commit();
    ss = stage + k * slice;
  }

  // The whole Gram, the partials summed in rank order (the same bits in every CTA).
  for (int q = tid; q < n_pairs; q += blockDim.x) {
    int i, j;
    pair_of(q, k, i, j);
    const float g = cluster_sum_upto<kMaxCluster>(cluster, partial, q);
    gram[i * k + j] = g;
    gram[j * k + i] = g;
  }
  // done with the other CTAs' shared memory (the loads' values are stored
  // above); the matching wait is before the exit
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  __syncthreads();

  // d2 of the pairs i < j (K <= 32: q = 32 i + j); the diagonal is exactly 0
  for (int q = tid; q < kMaxK * kMaxK; q += blockDim.x) {
    const int i = q >> 5, j = q & 31;
    if (i < j && j < k)
      d2p[pair_index(i, j, k)] =
          fmaxf(gram[i * k + i] + gram[j * k + j] - 2.f * gram[i * k + j], 0.f);
  }
  __syncthreads();
  const float gamma = rbf_gamma(median_upper_pairs(d2p, k * (k - 1) / 2, k, &slot), log_kp1);
  for (int q = tid; q < kMaxK * kMaxK; q += blockDim.x) {
    const int i = q >> 5, j = q & 31;
    if (i < k) {
      const float d =
          i == j || j >= k ? 0.f : d2p[i < j ? pair_index(i, j, k) : pair_index(j, i, k)];
      kxx[q] = j < k ? expf(-gamma * d) : 0.f;
    }
  }
  __syncthreads();
  if (tid < k) {
    float acc = 0.f;
    for (int j = 0; j < k; ++j) acc += kxx[tid * kMaxK + j];
    row_sum[tid] = acc;
  }
  if constexpr (kStaged) cp_async_wait<0>();
  __syncthreads();

  // phi of the slice: G groups of threads, each group a pass over the
  // columns (a thread a column, coalesced) for the rows i = g, g + G, ..
  // (G = 3 at a slice of 152 columns and 512 threads). A thread holds its
  // K-column of X and S in registers, zero past K, and reads each K_xx row
  // as float4 broadcasts, zero past K. The arrays are indexed only by
  // unrolled loop indices, under one uniform guard a group of 4; the loop
  // over the rows stays a loop. The zero terms past K add exactly 0 in the
  // same order.
  const float two_gamma = 2.f * gamma;
  const float kf = static_cast<float>(k);
  const int groups = max(1, min(k, static_cast<int>(blockDim.x) / slice));
  const int span = blockDim.x / groups;
  const int g = tid / span;
  for (int c = tid - g * span; g < groups && c < w; c += span) {
    float xv[kMaxK], sv[kMaxK];
#pragma unroll
    for (int j0 = 0; j0 < kMaxK; j0 += 4) {
      if (j0 < k) {
#pragma unroll
        for (int j = j0; j < j0 + 4; ++j) {
          xv[j] = j < k ? xs[j * ld + c] : 0.f;
          sv[j] = j < k ? ss[j * ld + c] : 0.f;
        }
      }
    }
    for (int i = g; i < k; i += groups) {
      const float4* krow = reinterpret_cast<const float4*>(kxx + i * kMaxK);
      float ks = 0.f, kx = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < kMaxK; j0 += 4) {
        if (j0 < k) {
          const float4 wv = krow[j0 / 4];
          const float wgt[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ks += wgt[u] * sv[j0 + u];
            kx += wgt[u] * xv[j0 + u];
          }
        }
      }
      phi[static_cast<size_t>(i) * p + lo + c] =
          (ks + two_gamma * (xs[i * ld + c] * row_sum[i] - kx)) / kf;
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace

extern "C" int pacoh_svgd_phi(const float* x, const float* s, float* phi, int batch, int k,
                              int p, float log_kp1, int cluster, int slice, int staged,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the X and S slices where the plan stages them (svgd_kernel.py's svgd_plan)
  const long long bytes = staged ? 2LL * k * slice * static_cast<long long>(sizeof(float)) : 0;
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxK || p < 1 || cluster < 1 ||
      cluster > kMaxCluster || slice < 4 || slice % 4 != 0 ||
      static_cast<long long>(slice) * cluster < p || bytes > kMaxStagedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? svgd_phi_cluster_kernel<true> : svgd_phi_cluster_kernel<false>;
  // once an instance: room for the largest staged plan, clusters of up to 16
  static bool configured[2] = {false, false};
  if (!configured[staged ? 1 : 0]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxStagedBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[staged ? 1 : 0] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);  // one cluster (cluster, 1, 1) a system
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, x, s, phi, k, p, slice, log_kp1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Registers and local-memory bytes a thread (where spills and stack frames
// go) of the instance that stages P's slices (staged = 1) or reads them from
// device memory.
extern "C" int pacoh_svgd_phi_usage(int staged, int* out, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = staged ? cudaFuncGetAttributes(&attr, svgd_phi_cluster_kernel<true>)
               : cudaFuncGetAttributes(&attr, svgd_phi_cluster_kernel<false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
