// Splitting one model over a thread-block cluster of C CTAs: the task groups
// and the slices of the parameter vector, and the rank-order sums over
// distributed shared memory. Shared by the score section of the fused SVGD,
// VI and MLAP kernels (cluster_score.cuh, C <= 8) and the fused MAP kernel
// (fused_map.cu, C <= 16). Included inside an anonymous namespace, after
// <cooperative_groups.h>.

#pragma once

// First task of CTA r of c over t tasks (contiguous groups, sizes differ by
// at most one); CTA r owns [task_lo(r), task_lo(r + 1)).
__host__ __device__ __forceinline__ int task_lo(int r, int t, int c) { return (r * t) / c; }

// Floats of each CTA's slice of a vector of p (a multiple of 4): CTA r owns
// [r * slice_len, min(p, (r + 1) * slice_len)), which may be empty.
__host__ __device__ __forceinline__ int slice_len(int p, int c) {
  return ((p + c - 1) / c + 3) / 4 * 4;
}

// Coordinate c of the cluster's vector whose CTA partials are v: the
// partials summed in rank order 0..C-1 over distributed shared memory, the
// C loads in flight together (C <= kMax).
template <int kMax>
__device__ __forceinline__ float cluster_sum_upto(const cooperative_groups::cluster_group& cluster,
                                                  float* v, int c) {
  const int n = static_cast<int>(cluster.num_blocks());
  float part[kMax];
#pragma unroll
  for (int q = 0; q < kMax; ++q)
    if (q < n) part[q] = cluster.map_shared_rank(v, q)[c];
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMax; ++q)
    if (q < n) s += part[q];
  return s;
}
