#!/usr/bin/env python3
"""Write a copy of the port whose small-N Cholesky B5 runs 33 <= N <= 64
over two warps a matrix, to time beside the package on one CUDA card.

    python3 tools/b5_two_warps.py DIR
    python3 tools/general_kernels_bench.py --root DIR

The copy's ``csrc/chol_small.cu`` gains a kernel of 64 threads a matrix:
warp w holds rows 32 w + lane in registers; each column's raw entries, the
pivot first, go through a shared column buffer (two, alternating), one
block barrier a column, and every thread then updates its row as
a[r][c] -= (a_r / d) a_c, in spans of 16 columns under one guard. N <= 32
stays on the one-warp kernel. DIR must not exist; give one that
``.gitignore`` lists (``_scratch_tree/...``). The package itself keeps one
warp a matrix on ``csrc/warp_chol.cuh``'s shared factorization.
"""

import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.join(os.path.dirname(HERE), "meta_learning_pacoh_torch")

KERNEL = r"""// 33 <= N <= 64 over two warps a matrix, warp w holding rows
// 32 w + lane in registers; each column's raw entries (pivot first) go
// through a shared column buffer, one block barrier a column; every thread
// then scales: a[r][c] -= (a_r / d) a_c.
template <int Wp>
__device__ __forceinline__ bool two_warp_rows(float* tile, float* colbuf, int ld, int n, int lane,
                                              float& dg) {
  constexpr int K = 32 * (Wp + 1);
  const int row = 32 * Wp + lane;
  float a[K];
#pragma unroll
  for (int c = 0; c < K; ++c) a[c] = row < n && c <= row ? tile[row * ld + c] : 0.f;
  dg = 1.f;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u;
      if (j < n) {
        float* col = colbuf + (j & 1) * 68;  // col[c] = A[j + c][j], col[0] the pivot
        if (row >= j) col[row - j] = a[u];
        __syncthreads();
        const float d = col[0];
        if (!(d > 0.f && d < INFINITY)) return false;
        const float inv = rsqrtf(d);
        const float l = a[u] * inv;
        const float sc = l * inv;
        if (row > j && row < n) tile[j * ld + row] = l;
        dg = row == j ? d * inv : dg;
#pragma unroll
        for (int c1 = 0; c1 < K; c1 += 16) {
          if (j + (c1 > 0 ? c1 : 1) < n) {
            float lc[16];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float4 q = reinterpret_cast<const float4*>(col)[c1 / 4 + v];
              lc[4 * v] = q.x;
              lc[4 * v + 1] = q.y;
              lc[4 * v + 2] = q.z;
              lc[4 * v + 3] = q.w;
            }
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (c1 + e > 0 && u + c1 + e < K) a[u + c1 + e] -= sc * lc[e];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k + 4 < K; ++k) a[k] = a[k + 4];
  }
  return true;
}

__global__ void __launch_bounds__(64)
chol_small_two_warp_kernel(const float* __restrict__ a, float* __restrict__ out, int n) {
  extern __shared__ __align__(16) float tile[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long m = blockIdx.x;
  const int ld = n | 1;
  float* colbuf = tile + (n * ld + 3) / 4 * 4;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = a + m * nn;
  for (int i = 0; i < n; ++i)
    if (t <= i) cp_async4(tile + i * ld + t, src + i * n + t);
  cp_async_wait_all();
  __syncthreads();
  float dg;
  const bool ok = warp == 0 ? two_warp_rows<0>(tile, colbuf, ld, n, lane, dg)
                            : two_warp_rows<1>(tile, colbuf, ld, n, lane, dg);
  if (t < n) tile[t * ld + t] = dg;
  __syncthreads();
  float* dst = out + m * nn;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
    if (t < n) dst[i * n + t] = !ok ? NAN : (t <= i ? tile[t * ld + i] : 0.f);
}

"""

LAUNCH = "    chol_small_warp_kernel<2><<<b, 32, bytes, st>>>(a, out, n);"
TWO_WARP_LAUNCH = ("    chol_small_two_warp_kernel<<<b, 64, bytes + 16 * sizeof(float), st>>>"
                   "(a, out, n);")


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    dest = os.path.abspath(sys.argv[1])
    pkg = os.path.join(dest, "meta_learning_pacoh_torch")
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(pkg, "csrc", "chol_small.cu")
    with open(path) as f:
        src = f.read()
    if src.count("}  // namespace") != 1 or src.count(LAUNCH) != 1:
        sys.exit("b5_two_warps: csrc/chol_small.cu no longer has the expected layout")
    src = src.replace("}  // namespace", KERNEL + "}  // namespace").replace(LAUNCH, TWO_WARP_LAUNCH)
    with open(path, "w") as f:
        f.write(src)
    print(f"wrote {pkg}")


if __name__ == "__main__":
    main()
