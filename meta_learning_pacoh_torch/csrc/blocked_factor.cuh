// Dense per-block linear algebra of one N x N GP system (N <= 512), column
// by column: the blocked MLL kernel's backward (csrc/blocked_mll.cu, B4).
// The counterparts of the helpers of
// meta_learning_pacoh_tpu/ops/pallas/blocked_mll_kernel.py:
//
//   factor_escalated   factor_escalated :507 (and factor_panels :461)
//   forward_subst      zsubst_blocked :595
//   logdet_lower       logdet_blocked :612 / logdet_from_wd :618
//   invert_lower       assemble_w_inv :632 (W = L^-1)
//   kinv_entry         the K^-1 = W^T W of _mll_bwd_kernel :690-706
//
// One thread block owns one system. The matrix is row-major with leading
// dimension ld, either in shared memory (an odd ld, so that a warp walking
// down a column hits 32 different banks) or, when it does not fit, in the
// block's own region of device memory (ld = N). Only the lower triangle is
// read and written. The TPU's choices are not carried over: no padding of
// N to a panel multiple, no lane-major base tiles, and no bordered system
// (a serial forward substitution in one warp is cheap here).
//
// Every function is called by all threads of the block and returns to all
// of them; each ends with the block's writes visible (a __syncthreads).
// Included inside an anonymous namespace of each kernel's source.

constexpr int kPanel = 8;  // columns factored before one trailing update

// Leading dimension of an N x N matrix held in shared memory.
__host__ __device__ __forceinline__ int shared_ld(int n) { return n | 1; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Right-looking Cholesky of the lower triangle of m in place, in panels of
// kPanel columns: the panel's columns one by one (a column, then the
// panel's later columns), then one rank-kPanel update of the trailing lower
// triangle. pcol: shared [kPanel * n]. Returns, to every thread, whether
// every pivot was finite and positive; stops at the first that is not.
// Every thread reads the same pivot after a barrier, so the result and the
// early exit are uniform.
__device__ bool factor_lower(float* m, int n, int ld, float* pcol) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int jb = min(kPanel, n - j0);
    const int j_end = j0 + jb;
    for (int t = 0; t < jb; ++t) {
      const int j = j0 + t;
      const float d = sqrtf(m[j * ld + j]);
      if (!(d > 0.f && d < INFINITY)) {
        __syncthreads();
        return false;
      }
      float* col = pcol + t * n;
      for (int i = j + tid; i < n; i += nth) col[i] = (i == j) ? d : m[i * ld + j] / d;
      __syncthreads();
      for (int i = j + tid; i < n; i += nth) m[i * ld + j] = col[i];
      // the panel's later columns c in (j, j_end), rows i >= c
      for (int i = j + 1 + warp; i < n; i += n_warps) {
        const float ci = col[i];
        const int c_end = min(i + 1, j_end);
        for (int c = j + 1 + lane; c < c_end; c += 32) m[i * ld + c] -= ci * col[c];
      }
      __syncthreads();
    }
    // trailing lower triangle: a warp per row, lanes along the row
    for (int r = j_end + warp; r < n; r += n_warps) {
      float pr[kPanel];
#pragma unroll
      for (int t = 0; t < kPanel; ++t) pr[t] = (t < jb) ? pcol[t * n + r] : 0.f;
      float* row = m + r * ld;
      for (int c = j_end + lane; c <= r; c += 32) {
        float acc = row[c];
#pragma unroll
        for (int t = 0; t < kPanel; ++t)
          if (t < jb) acc -= pr[t] * pcol[t * n + c];
        row[c] = acc;
      }
    }
    __syncthreads();
  }
  return true;
}

// The factor at the first jitter of (0, 1e-4, 1e-2) whose factorization
// succeeds, chosen for this one system: a healthy system factors once.
// load(m, jitter) writes the pristine lower triangle plus the jitter on the
// diagonal entries the caller chooses (every thread takes its share; no
// barrier needed inside). Returns the level used, or -1 when every level
// failed (m then holds a partial factor).
template <class Load>
__device__ int factor_escalated(float* m, int n, int ld, float* pcol, Load load) {
  for (int level = 0; level < 3; ++level) {
    load(m, level == 0 ? 0.f : (level == 1 ? 1e-4f : 1e-2f));
    __syncthreads();
    if (factor_lower(m, n, ld, pcol)) return level;
  }
  return -1;
}

// z = L^-1 r by forward substitution in warp 0 (r and z may be the same
// array). Returns |z|^2 to every thread.
__device__ float forward_subst(const float* m, int n, int ld, const float* r, float* z,
                               float* red) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float q = 0.f;
    for (int i = 0; i < n; ++i) {
      float part = 0.f;
      for (int k = tid; k < i; k += 32) part += m[i * ld + k] * z[k];
      part = warp_sum(part);
      const float zi = (r[i] - part) / m[i * ld + i];
      __syncwarp();
      if (tid == 0) z[i] = zi;
      q += zi * zi;
      __syncwarp();
    }
    if (tid == 0) *red = q;
  }
  __syncthreads();
  const float q = *red;
  __syncthreads();
  return q;
}

// 2 sum log diag L, to every thread (one fixed order of sums).
__device__ float logdet_lower(const float* m, int n, int ld, float* red) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    float s = 0.f;
    for (int i = tid; i < n; i += 32) s += logf(m[i * ld + i]);
    s = warp_sum(s);
    if (tid == 0) *red = 2.f * s;
  }
  __syncthreads();
  const float v = *red;
  __syncthreads();
  return v;
}

// W = L^-1 in place over the lower triangle, a column at a time from the
// last: with W22 the inverse of the trailing block already in place,
// column j below the diagonal becomes -W22 L[j+1:, j] / L_jj and the
// diagonal 1 / L_jj. col: shared [n].
__device__ void invert_lower(float* m, int n, int ld, float* col) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  for (int j = n - 1; j >= 0; --j) {
    const float djj = 1.f / m[j * ld + j];
    for (int i = j + 1 + tid; i < n; i += nth) col[i] = m[i * ld + j];
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += n_warps) {
      float s = 0.f;
      for (int k = j + 1 + lane; k <= i; k += 32) s += m[i * ld + k] * col[k];
      s = warp_sum(s);
      if (lane == 0) m[i * ld + j] = -s * djj;
    }
    if (tid == 0) m[j * ld + j] = djj;
    __syncthreads();
  }
}

// (K^-1)_ab = sum_{k >= max(a, b)} W_ka W_kb from W = L^-1 in m.
__device__ __forceinline__ float kinv_entry(const float* m, int n, int ld, int a, int b) {
  float s = 0.f;
  for (int k = max(a, b); k < n; ++k) s += m[k * ld + a] * m[k * ld + b];
  return s;
}

// alpha = W^T z (= K^-1 r) from W = L^-1 in m: a thread per entry.
__device__ void wt_times(const float* m, int n, int ld, const float* z, float* alpha) {
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    float s = 0.f;
    for (int k = a; k < n; ++k) s += m[k * ld + a] * z[k];
    alpha[a] = s;
  }
  __syncthreads();
}
