// Sums over lanes in one fixed order, shared by the kernels' tiled passes
// (tiled_inverse.cuh, bign_score.cuh, map_tiles.cuh). Included inside an
// anonymous namespace of each kernel's source.

#pragma once

// The sum of v over the warp, the same order in every lane.
__device__ __forceinline__ float warp_total(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The lanes that share one item's sum where `items` items spread over the
// block: the largest power of two g <= 32 with items * g <= blockDim.x
// (1 when items > blockDim.x / 2) that leaves each lane at least two of the
// `reach` terms of a sum. Thread t takes item t / g, part t % g.
__device__ __forceinline__ int group_lanes(int items, int reach) {
  int g = 1;
  while (g < 32 && items * 2 * g <= static_cast<int>(blockDim.x) && 4 * g <= reach) g *= 2;
  return g;
}

// The sum of v over the g lanes of an aligned group, the same xor tree in
// each; every lane of the warp calls it.
__device__ __forceinline__ float group_total(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
