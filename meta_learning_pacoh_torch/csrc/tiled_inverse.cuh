// The inverse W = L^-1 of a factor held as csrc/tiled_chol.cuh leaves it, and
// K^-1 = W^T W from it, in place, in 32-column tiles: the system algebra of the
// big-N fused SVGD and VI kernels (csrc/fused_svgd_bign.cu, B10, and
// csrc/fused_vi_bign.cu, B11, through csrc/bign_score.cuh), of the big-N
// fused MAP kernel (csrc/fused_map_bign.cu, B9) and of the blocked MLL
// backward (csrc/blocked_mll.cu, B4).
//
// The counterpart of assemble_w_inv and of the K^-1 = W^T W product of
// meta_learning_pacoh_tpu/ops/pallas/fused_svgd_bign_kernel.py (:254-256)
// and fused_map_bign_kernel.py (:267-274), as LAPACK's trtri and lauum
// (lower) order them, for N <= 512 at 512 threads (B9 takes N up to 512):
//   tiled_invert  every diagonal tile inverted at once, a warp a tile, in
//                 registers (one row a lane, each finished row broadcast
//                 through a 32-float buffer); then the panels from the last
//                 up, two block barriers each: every thread forms one row of
//                 Y = L21 W11 in registers into a row-major buffer, then
//                 every thread one 4 x 4 micro-tile of W21 = -W22 Y from
//                 16-byte loads (a second round where the panel has more
//                 micro-tiles than the block threads), written in place
//                 (W22 is final by then);
//   tiled_lauum   block rows of 32 from the top (of 16 where a block row
//                 of 32 has more micro-tiles than the block threads: N >
//                 280 at 512 threads), one 4 x 4 micro-tile of (W^T W) a
//                 thread held in registers, one block barrier, written
//                 back over the block row's W (later block rows read only
//                 rows below it), so about N/32 barriers.
// The column-at-a-time design these replace took two barriers and a warp's
// shuffle tree a column for the inverse and a serial dot a K^-1 entry.
// Full float32 FMA throughout (TF32 breaks these matrices), each sum in one
// fixed order, no atomics.
//
// Only rows < M.n are touched: the border row of the factor (z = L^-1 r)
// stays. Entries above the diagonal are never read as values: a packed row's
// padding and the square's upper triangle may hold anything, and every load
// that reaches them is masked by a select. Every function is called by all
// threads of the block and ends with a barrier. Included after
// tiled_chol.cuh inside an anonymous namespace of each kernel's source.

constexpr int kMaxTiles = 8;  // diagonal tiles of B10 and B11's largest system, N = 256

#include "lane_sums.cuh"

// Entries c..c+3 of row i, c a multiple of 4 and c <= i: 16 bytes from a
// packed row (entries past i are its padding, any value); from the square,
// scalar loads, 0 past i.
__device__ __forceinline__ float4 row_quad(const TiledMatrix& M, int i, int c) {
  const float* p = M.row(i) + c;
  if (M.packed) return *reinterpret_cast<const float4*>(p);
  const int m = i - c;
  return make_float4(p[0], m >= 1 ? p[1] : 0.f, m >= 2 ? p[2] : 0.f, m >= 3 ? p[3] : 0.f);
}

// Entries c..c+3 of row i into it, c a multiple of 4 and c <= i: 16 bytes
// into a packed row (what lies past i lands in its padding), else the
// entries up to i.
__device__ __forceinline__ void row_quad_store(const TiledMatrix& M, int i, int c, float4 v) {
  float* p = M.row(i) + c;
  if (M.packed) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const int m = i - c;
  p[0] = v.x;
  if (m >= 1) p[1] = v.y;
  if (m >= 2) p[2] = v.z;
  if (m >= 3) p[3] = v.w;
}

// One warp: the diagonal tile at j0 (jb <= kTile real rows; the lanes beyond
// are identity rows) replaced by its inverse. Lane r builds row r of W11 =
// L11^-1 in registers, reading its row of L11 where it needs it: at step k
// lane k scales its row by 1 / L_kk and publishes it in buf (two rows of
// kTile, alternating, so one __syncwarp a step), and every lane below takes
// L_rk times it off its own row. Writes sum_c log L_cc of the tile to
// *log_sum.
__device__ void tile_invert(const TiledMatrix& M, int j0, int jb, float* buf, float* log_sum) {
  const int lane = threadIdx.x & 31;
  const bool real = lane < jb;
  const float* lrow = M.row(j0 + (real ? lane : 0)) + j0;
  float lg = real ? logf(lrow[lane]) : 0.f;
  const float inv = real ? 1.f / lrow[lane] : 1.f;  // off the chain below
  float x[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) x[c] = c == lane ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    if (k >= jb) break;  // the identity rows' steps change nothing real
    float* row = buf + (k & 1) * kTile;
    if (lane == k) {
#pragma unroll
      for (int c = 0; c <= k; ++c) x[c] *= inv;
#pragma unroll
      for (int q = 0; q <= k / 4; ++q)
        reinterpret_cast<float4*>(row)[q] =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    }
    __syncwarp();
    if (lane > k && real) {
      const float l = lrow[k];
#pragma unroll
      for (int q = 0; q <= k / 4; ++q) {
        const float4 w = reinterpret_cast<const float4*>(row)[q];
        if (4 * q <= k) x[4 * q] -= l * w.x;
        if (4 * q + 1 <= k) x[4 * q + 1] -= l * w.y;
        if (4 * q + 2 <= k) x[4 * q + 2] -= l * w.z;
        if (4 * q + 3 <= k) x[4 * q + 3] -= l * w.w;
      }
    }
  }
  __syncwarp();
  if (real) {  // entries past the lane are 0 and land in the row's padding
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q)
      if (4 * q <= lane)
        row_quad_store(M, j0 + lane, j0 + 4 * q,
                       make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]));
  }
  lg = warp_total(lg);
  if (lane == 0) *log_sum = lg;
}

// W = L^-1 in place over rows < M.n. scratch: tiled_scratch_floats(n, n_rows)
// floats of shared memory (its first kTile^2 floats give each of up to 16
// warps its 2 kTile-float buffer, its panel buffer holds Y); tile_log[t]
// receives sum log L_cc of diagonal tile t (t < kMaxTiles).
__device__ void tiled_invert(const TiledMatrix& M, float* scratch, float* tile_log) {
  const int tid = threadIdx.x, nth = blockDim.x, warp = tid >> 5, n_warps = nth >> 5;
  const int n = M.n, nt = (n + kTile - 1) / kTile;
  float* ybuf = scratch + kTile * kTile + 4;
  for (int t = warp; t < nt; t += n_warps)
    tile_invert(M, t * kTile, min(kTile, n - t * kTile), scratch + 2 * kTile * (warp & 15),
                tile_log + t);
  __syncthreads();
  for (int p = nt - 2; p >= 0; --p) {
    const int j0 = p * kTile, j_end = j0 + kTile;
    // Y = L21 W11, a row a thread: y_c = sum_{m >= c} L_im W11_mc, in order of m
    for (int i = j_end + tid; i < n; i += nth) {
      const float* xrow = M.row(i) + j0;
      float y[kTile];
#pragma unroll
      for (int c = 0; c < kTile; ++c) y[c] = 0.f;
#pragma unroll
      for (int m = 0; m < kTile; ++m) {
        const float xm = xrow[m];
#pragma unroll
        for (int q = 0; q <= m / 4; ++q) {
          const float4 w = row_quad(M, j0 + m, j0 + 4 * q);
          if (4 * q <= m) y[4 * q] = fmaf(xm, w.x, y[4 * q]);
          if (4 * q + 1 <= m) y[4 * q + 1] = fmaf(xm, w.y, y[4 * q + 1]);
          if (4 * q + 2 <= m) y[4 * q + 2] = fmaf(xm, w.z, y[4 * q + 2]);
          if (4 * q + 3 <= m) y[4 * q + 3] = fmaf(xm, w.w, y[4 * q + 3]);
        }
      }
      float4* yr = reinterpret_cast<float4*>(ybuf + (i - j_end) * kTile);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q)
        yr[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    }
    __syncthreads();
    // W21 = -W22 Y by 4 x 4 micro-tiles (rows i0..i0+3, columns j0+c0..+3),
    // each summed over k = j_end..i0+3 (W22 is lower triangular) by a group
    // of g lanes, lane part taking the 4-row chunks part, part + g, ...
    const int n_tiles = (n - j_end + 3) / 4 * (kTile / 4);
    const int g = group_lanes(n_tiles, (n - j_end + 3) / 4);
    // every thread runs the same rounds, so that a group's lanes meet in its shuffles
    for (int base = 0; base < n_tiles * g; base += nth) {
      const int item = (base + tid) / g, part = (base + tid) % g;
      const bool mine = item < n_tiles;
      const int i0 = j_end + 4 * (item / (kTile / 4)), c0 = 4 * (item % (kTile / 4));
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
      for (int k = j_end + 4 * part; mine && k <= i0; k += 4 * g) {
        float wv[4][4], yv[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i0 + u < n) w = row_quad(M, i0 + u, k);
          // the chunk on the diagonal: W_{i0+u, k+v} = 0 for k + v > i0 + u
          const bool diag = k == i0;
          wv[u][0] = w.x;
          wv[u][1] = diag && u < 1 ? 0.f : w.y;
          wv[u][2] = diag && u < 2 ? 0.f : w.z;
          wv[u][3] = diag && u < 3 ? 0.f : w.w;
          float4 yy = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k + u < n) yy = *reinterpret_cast<const float4*>(ybuf + (k + u - j_end) * kTile + c0);
          yv[u][0] = yy.x;
          yv[u][1] = yy.y;
          yv[u][2] = yy.z;
          yv[u][3] = yy.w;
        }
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[u][c] = fmaf(wv[u][v], yv[v][c], acc[u][c]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = group_total(acc[u][v], g);
      if (mine && part == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i0 + u < n)
            row_quad_store(M, i0 + u, j0 + c0,
                           make_float4(-acc[u][0], -acc[u][1], -acc[u][2], -acc[u][3]));
      }
    }
    __syncthreads();
  }
}

// alpha = W^T z (= K^-1 r) from W = L^-1 in place: alpha_a = sum_{k >= a}
// W_ka z_k, a group of g lanes an entry (lane part taking k = a + part, a +
// part + g, ...). Ends with a barrier.
__device__ void tiled_wt_times(const TiledMatrix& M, const float* z, float* alpha) {
  const int n = M.n, g = group_lanes(n, n), a = threadIdx.x / g, part = threadIdx.x % g;
  float s = 0.f;
  for (int k = a + part; a < n && k < n; k += g) s = fmaf(M.row(k)[a], z[k], s);
  s = group_total(s, g);
  if (a < n && part == 0) alpha[a] = s;
  __syncthreads();
}

// K^-1 = W^T W over the lower triangle in place of W = L^-1: entry (i, j),
// i >= j, the sum over k >= i of W_ki W_kj. Block rows of kTile rows from
// the top; in each, 4 x 4 micro-tiles (rows i0..i0+3, columns c0..c0+3 <=
// i0+3), each summed by a group of g lanes (lane part taking k = i0 + part,
// i0 + part + g, ..., then the group's xor tree) and held in registers
// until the block barrier, then written over the block row. A block row of
// 32 has at most 8 (N/4 + 1) micro-tiles, at most blockDim.x for N <= 280 at
// 512 threads; beyond, block rows of 16 (at most 4 (N/4 + 1) micro-tiles:
// N = 512 fits).
__device__ void tiled_lauum(const TiledMatrix& M) {
  const int tid = threadIdx.x, n = M.n;
  // block rows of rh rows: 32, halved while one has more micro-tiles than threads
  int rh = kTile;
  for (bool fits = false; !fits && rh > 4;) {
    fits = true;
    for (int r0 = 0; r0 < n; r0 += rh) {
      const int tr = (min(rh, n - r0) + 3) / 4;
      fits = fits && tr * (r0 / 4) + tr * (tr + 1) / 2 <= static_cast<int>(blockDim.x);
    }
    if (!fits) rh /= 2;
  }
  for (int r0 = 0; r0 < n; r0 += rh) {
    const int tr = (min(rh, n - r0) + 3) / 4;
    const int n_tiles = tr * (r0 / 4) + tr * (tr + 1) / 2;
    const int g = group_lanes(n_tiles, n - r0), part = tid % g;
    // micro-tile row R < tr holds r0/4 + R + 1 column groups
    int R = 0, t = tid / g;
    while (R < tr && t > r0 / 4 + R) {
      t -= r0 / 4 + R + 1;
      ++R;
    }
    const bool mine = R < tr;
    const int i0 = r0 + 4 * R, c0 = 4 * t;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
    for (int k = i0 + part; mine && k < n; k += g) {
      const float4 a = row_quad(M, k, i0), b = row_quad(M, k, c0);
      float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
      if (k < i0 + 4) {  // W_{k, i0+u} = 0 for k < i0 + u, W_{k, c0+v} = 0 for c0 + v > k
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u > k) av[u] = 0.f;
          if (c0 + u > k) bv[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = group_total(acc[u][v], g);
    __syncthreads();
    if (mine && part == 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < n)
          row_quad_store(M, i0 + u, c0, make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]));
    }
  }
  __syncthreads();
}
