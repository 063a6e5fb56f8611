// Tiled right-looking Cholesky of one N x N system per thread block (N <= 512),
// written for Hopper: the factorization of the batched Cholesky K4
// (csrc/chol.cu) and of the blocked MLL forward B4 (csrc/blocked_mll.cu).
//
// The counterpart of factor_panels (with its border row) and extract_border_z
// of meta_learning_pacoh_tpu/ops/pallas/blocked_mll_kernel.py :461-488, :566.
//
// The matrix is factored in panels of kTile = 32 columns, three block
// barriers a panel (about 21 at N=200, where a column at a time took 425):
//   (a) warp 0 factors the 32 x 32 diagonal tile in registers, one row a
//       lane, each pivot broadcast with __shfl_sync and each column through
//       L11^T in `lt` (1 / L_cc on its diagonal), no block barrier; it
//       writes L11 back and the pivot verdict to `flag`;
//   (b) every thread solves one row below the tile, x L11^T = a, in
//       registers, and writes it back and, column-major, to the panel buffer;
//   (c) every thread updates 4 x 4 micro-tiles of the trailing lower
//       triangle, A22 -= L21 L21^T, from 16-byte loads of the panel buffer
//       (32 products deep, full float32 FMA: TF32 breaks these matrices).
// An optional border row (row N, never a pivot) takes part in (b) and (c):
// after the last panel it holds z^T = (L^-1 r)^T, so B4 needs no serial
// forward substitution.
//
// Storage. In shared memory the lower triangle is packed by rows, row i
// padded to a multiple of 4 floats (packed_off), so every row starts on a
// 16-byte boundary: about N^2/2 floats, 82 KB at N=200 with the border, and
// with the scratch two blocks fit on an SM up to N=207 (B4) / 208 (K4) and
// one up to N=307 / 308. Above, the block works in place in its square
// output in device memory (ld = N, the border row in a vector of its own);
// the scratch stays in shared memory. No float atomics: one call gives the
// same bits each time.
//
// Every function is called by all threads of the block. Included inside an
// anonymous namespace of each kernel's source.

#include <stdint.h>

constexpr int kTile = 32;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Offset of row i in the packed lower triangle: rows k < i of round4(k + 1)
// floats each.
__host__ __device__ __forceinline__ int packed_off(int i) {
  const int q = i >> 2, rem = i & 3;
  return 8 * q * (q + 1) + 4 * rem * (q + 1);
}

// Stride of the panel buffer: the rows below the first tile, rounded up.
__host__ __device__ __forceinline__ int panel_ld(int n, int n_rows) {
  const int below = n_rows - (n < kTile ? n : kTile);
  return round4(below > 1 ? below : 1);
}

// Shared-memory floats: lt (kTile^2), flag (4), the panel buffer (kTile
// rows), and the packed triangle of n_rows rows when it is held there.
// ops/cuda/chol_kernel.py (chol_in_shared) and ops/cuda/blocked_mll_kernel.py
// (blocked_in_shared) state the same.
__host__ __device__ __forceinline__ size_t tiled_scratch_floats(int n, int n_rows) {
  return static_cast<size_t>(kTile) * kTile + 4 + static_cast<size_t>(kTile) * panel_ld(n, n_rows);
}
__host__ __device__ __forceinline__ size_t tiled_packed_floats(int n, int n_rows) {
  return tiled_scratch_floats(n, n_rows) + packed_off(n_rows);
}

struct TiledMatrix {
  float* base;    // packed rows (shared memory) or the square, ld = n (device memory)
  float* border;  // row n in device memory (the packed case keeps it after row n - 1)
  int n, n_rows;  // n_rows = n + 1 with a border row
  bool packed;
  __device__ __forceinline__ float* row(int i) const {
    if (packed) return base + packed_off(i);
    return i < n ? base + static_cast<size_t>(i) * n : border;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The pristine lower triangle of src (square, ld = n) into M, and the border
// row from border_src when M has one; ends with a barrier. Into shared memory
// by cp.async (16-byte copies when every row of src is 16-byte aligned), a
// warp a row; in device memory by plain copies.
__device__ void tiled_load(const TiledMatrix& M, const float* __restrict__ src,
                           const float* __restrict__ border_src) {
  const int tid = threadIdx.x, nth = blockDim.x, n = M.n;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  if (M.packed) {
    const bool vec = (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    for (int i = warp; i < n; i += n_warps) {
      float* dst = M.row(i);
      const float* s = src + static_cast<size_t>(i) * n;
      if (vec) {
        for (int c = 4 * lane; c <= i; c += 128) cp_async16(dst + c, s + c);
      } else {
        for (int c = lane; c <= i; c += 32) cp_async4(dst + c, s + c);
      }
    }
    if (M.n_rows > n)
      for (int c = tid; c < n; c += nth) cp_async4(M.row(n) + c, border_src + c);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = warp; i < n; i += n_warps) {
      float* dst = M.row(i);
      const float* s = src + static_cast<size_t>(i) * n;
      for (int c = lane; c <= i; c += 32) dst[c] = s[c];
    }
    if (M.n_rows > n)
      for (int c = tid; c < n; c += nth) M.border[c] = border_src[c];
  }
  __syncthreads();
}

// (a) Warp 0: the diagonal tile at j0 (jb <= kTile real rows; the lanes
// beyond are identity rows), with the jitter on its diagonal. A column costs
// one shuffle (the next pivot), one rsqrt and a warp-synchronous pass
// through lt.
__device__ void tile_factor(const TiledMatrix& M, int j0, int jb, float jitter, float* lt,
                            int* flag) {
  const int lane = threadIdx.x & 31;
  const bool real = lane < jb;
  float* rowp = real ? M.row(j0 + lane) + j0 : nullptr;
  float a[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    a[c] = real ? (c <= lane ? rowp[c] : 0.f) : (c == lane ? 1.f : 0.f);
    if (c == lane && real) a[c] += jitter;
  }
  bool ok = true;
  float p = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    // every lane takes the same pivot, so `ok` is uniform over the warp
    ok = ok && p > 0.f && p < INFINITY;
    const float inv = rsqrtf(p);
    const float l = lane > j ? a[j] * inv : 0.f;
    // the next pivot from lane j + 1's own l, the same FMA as its update
    // below, so that lt's round trip stays off the pivot chain
    const float p_j = p;
    if (j + 1 < kTile) p = __shfl_sync(0xffffffffu, a[j + 1] - l * l, j + 1);
    // column j of L11 into row j of lt (1 / L_jj on the diagonal), read back
    // by every lane as 16-byte broadcasts
    lt[j * kTile + lane] = lane == j ? inv : l;
    a[j] = lane == j ? p_j * inv : l;
    __syncwarp();
    // lanes below column c update their entry c; the others only touch
    // entries above their diagonal, which nothing reads
#pragma unroll
    for (int q = (j + 1) / 4; q < kTile / 4; ++q) {
      const float4 w = reinterpret_cast<const float4*>(lt + j * kTile)[q];
      if (4 * q > j) a[4 * q] -= l * w.x;
      if (4 * q + 1 > j) a[4 * q + 1] -= l * w.y;
      if (4 * q + 2 > j) a[4 * q + 2] -= l * w.z;
      if (4 * q + 3 > j) a[4 * q + 3] -= l * w.w;
    }
  }
  if (real) {
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c <= lane) rowp[c] = a[c];
  }
  if (lane == 0) *flag = ok ? 0 : 1;
}

// (b) Rows i >= j_end: x L11^T = a (columns j0..j0+jb of row i), a thread a
// row; x back into the row and into panel[c * ldp + i - j_end] for all kTile
// c (zero beyond jb).
__device__ void panel_solve(const TiledMatrix& M, int j0, int jb, const float* lt, float* panel,
                            int ldp) {
  const int j_end = j0 + jb;
  for (int i = j_end + threadIdx.x; i < M.n_rows; i += blockDim.x) {
    float* rowp = M.row(i) + j0;
    float x[kTile];
    if (M.packed) {  // rows start 16-byte aligned, j0 is a multiple of 4
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * q < jb) v = reinterpret_cast<const float4*>(rowp)[q];
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (c >= jb) x[c] = 0.f;
    } else {
#pragma unroll
      for (int c = 0; c < kTile; ++c) x[c] = c < jb ? rowp[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      x[k] *= lt[k * kTile + k];
#pragma unroll
      for (int q = (k + 1) / 4; q < kTile / 4; ++q) {
        const float4 w = reinterpret_cast<const float4*>(lt + k * kTile)[q];
        if (4 * q > k) x[4 * q] -= x[k] * w.x;
        if (4 * q + 1 > k) x[4 * q + 1] -= x[k] * w.y;
        if (4 * q + 2 > k) x[4 * q + 2] -= x[k] * w.z;
        if (4 * q + 3 > k) x[4 * q + 3] -= x[k] * w.w;
      }
    }
    if (M.packed) {  // entries beyond jb are zero and land in the row's padding
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q)
        if (4 * q < jb)
          reinterpret_cast<float4*>(rowp)[q] =
              make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (c < jb) rowp[c] = x[c];
    }
    float* p = panel + (i - j_end);
#pragma unroll
    for (int c = 0; c < kTile; ++c) p[c * ldp] = x[c];
  }
}

// (c) A22 -= L21 L21^T over the trailing lower triangle (rows j_end..n_rows,
// columns j_end..n), a 4 x 4 micro-tile a thread at a time; the tiles of
// the triangle are numbered row by row. j_end is a multiple of 4.
__device__ void trailing_update(const TiledMatrix& M, int j_end, const float* panel, int ldp) {
  const int m_rows = M.n_rows - j_end, m_cols = M.n - j_end;
  if (m_cols <= 0) return;
  const int tr = (m_rows + 3) / 4, tc = (m_cols + 3) / 4;
  const int n_tiles = tr * (tr + 1) / 2;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    int R = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (R * (R + 1) / 2 > t) --R;
    while ((R + 1) * (R + 2) / 2 <= t) ++R;
    const int C = t - R * (R + 1) / 2;
    if (C >= tc) continue;  // the border's tile row beyond the last column tile
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    const float* pr = panel + 4 * R;
    const float* pc = panel + 4 * C;
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(pr + k * ldp);
      const float4 b = *reinterpret_cast<const float4*>(pc + k * ldp);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = j_end + 4 * R + u;
      if (r >= M.n_rows) break;
      float* rowp = M.row(r) + j_end + 4 * C;
      if (M.packed) {  // columns above the diagonal or past n are the row's padding
        float4 w = *reinterpret_cast<float4*>(rowp);
        w.x -= acc[u][0];
        w.y -= acc[u][1];
        w.z -= acc[u][2];
        w.w -= acc[u][3];
        *reinterpret_cast<float4*>(rowp) = w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = j_end + 4 * C + v;
          if (c <= r && c < M.n) rowp[v] -= acc[u][v];
        }
      }
    }
  }
}

// The factor of M's lower triangle (plus the jitter on its diagonal) in
// place. Returns, to every thread, whether every pivot was finite and
// positive; stops at the first tile that has one that is not. scratch:
// tiled_scratch_floats(n, n_rows) floats of shared memory.
__device__ bool tiled_factor(const TiledMatrix& M, float jitter, float* scratch) {
  float* lt = scratch;
  int* flag = reinterpret_cast<int*>(scratch + kTile * kTile);
  float* panel = scratch + kTile * kTile + 4;
  const int ldp = panel_ld(M.n, M.n_rows);
  for (int j0 = 0; j0 < M.n; j0 += kTile) {
    const int jb = min(kTile, M.n - j0);
    if (threadIdx.x < 32) tile_factor(M, j0, jb, jitter, lt, flag);
    __syncthreads();
    // warp 0 writes the flag again only after the next barrier
    if (*flag) return false;
    panel_solve(M, j0, jb, lt, panel, ldp);
    __syncthreads();
    trailing_update(M, j0 + jb, panel, ldp);
    __syncthreads();
  }
  return true;
}

// The square output dst (ld = n): the factor's lower triangle, zeros above,
// or all NaN when the factorization failed; a warp a row, 16 bytes a lane
// when the rows allow it.
__device__ void tiled_store(const TiledMatrix& M, float* __restrict__ dst, bool ok) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int n = M.n;
  const float nan = nanf("");
  const bool vec = M.packed && (n & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int i = warp; i < n; i += n_warps) {
    const float* src = M.row(i);
    float* d = dst + static_cast<size_t>(i) * n;
    if (vec) {  // chunks at c <= i lie inside the packed row and its padding
      for (int c = 4 * lane; c < n; c += 128) {
        float4 v = c <= i ? *reinterpret_cast<const float4*>(src + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        if (c + 1 > i) v.y = 0.f;
        if (c + 2 > i) v.z = 0.f;
        if (c + 3 > i) v.w = 0.f;
        if (!ok) v = make_float4(nan, nan, nan, nan);
        *reinterpret_cast<float4*>(d + c) = v;
      }
    } else {
      for (int c = lane; c < n; c += 32) d[c] = ok ? (c <= i ? src[c] : 0.f) : nan;
    }
  }
}

// Host side. Whether the packed triangle of n_rows rows fits in shared
// memory (*packed), the dynamic shared-memory bytes a block of `kernel` asks
// for (*dyn), and the carve-out set to the most shared memory. Returns a
// cudaError_t.
template <typename Kernel>
int tiled_setup(Kernel kernel, int n, int n_rows, int device, int* packed, size_t* dyn) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *packed = tiled_packed_floats(n, n_rows) * sizeof(float) <= static_cast<size_t>(optin);
  *dyn = (*packed ? tiled_packed_floats(n, n_rows) : tiled_scratch_floats(n, n_rows)) * sizeof(float);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

// Resident blocks per SM of `kernel` (threads a block) at this N, into
// *blocks, read with cudaOccupancyMaxActiveBlocksPerMultiprocessor.
template <typename Kernel>
int tiled_blocks_per_sm(Kernel kernel, int threads, int n, int n_rows, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int packed = 0;
  size_t dyn = 0;
  const int e = tiled_setup(kernel, n, n_rows, device, &packed, &dyn);
  if (e != 0) return e;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, dyn));
}
