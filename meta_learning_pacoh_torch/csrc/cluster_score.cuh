// The particle score of PACOH's GP prior for one parameter vector, split
// over a thread-block cluster of C CTAs: used by the fused SVGD kernel
// (fused_svgd.cu, one cluster per particle) and the fused VI kernel
// (fused_vi.cu, one cluster per posterior sample); the fused MLAP kernel
// (fused_mlap.cuh, one cluster per hyper-posterior sample) takes its MLP
// passes, factor_inv and the cluster sums, with its own per-task algebra
// (the inner KL's) between the passes. The counterpart of
// make_score_section in meta_learning_pacoh_tpu/ops/pallas/
// fused_train_kernel.py.
//
// The parameter vector th [P] (NN mean and NN kernel, feature_dim 1, L
// hidden layers of width H) lies whole in every CTA's shared memory. CTA r
// owns the tasks [task_lo(r), task_lo(r + 1)) and their rows. Rows are
// independent in the forward, the per-task MLL and the activation
// gradients, so a CTA runs them with no communication:
//   forward   both tanh MLPs over the CTA's rows, both nets in each pass;
//             each thread computes 2 rows x 4 units of a hidden layer with
//             the operands in registers (6 shared loads per 8 multiply-adds)
//   MLL       per task, one thread a task (one lane in each of the warps
//             first): the entry-wise Kn (noise + 1e-6 on real diagonals,
//             1.0 on padded ones), trial factorizations at jitter 0 and 1e-4
//             choosing 0 / 1e-4 / 1e-2 (a factor is good when every
//             pivot is finite and > 0), L, alpha, L^-1, K^-1, and, when
//             asked, the value quad + logdet; the pivots are inverted once
//             (rsqrt) and the kernel entries' exponentials kept for the
//             gradient
//   backward  G = 0.5 w (alpha alpha^T - K^-1) into d(mean), d(feature),
//             d(lengthscale), d(noise); both MLPs' backward: weight
//             gradients as 2 x 4 register tiles over the CTA's rows, input
//             gradients as 2 rows x 4 units
// into sc [P]: the CTA's partial of the gradient of sum_t w_t MLL_t without
// the hyper-prior term. The caller sums the partials of the cluster slice by
// slice in rank order 0..C-1 over distributed shared memory
// (cluster_sum), so the bits depend on C but not on timing or on how a
// run is split into launches. No float atomics.
//
// A CTA whose tasks' rows do not fit in its shared memory walks them in
// tiles of a fixed number of tasks (the plan's `tile`): each tile's rows
// are loaded, run forward, through the per-task algebra and backward, and
// the backward continues every sum of sc from where the previous tile left
// it (the same fmaf chain over the rows, in the same order), so the partial
// score has the bits of the CTA's single pass over all its rows. The slots
// are one tile's height then, and no shared array grows with T.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

namespace cgc = cooperative_groups;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size

#include "cluster_util.cuh"

// The CTA's shared-memory work areas of the score section and its rows.
struct ClusterRows {
  float* act;   // [L + 1 slots][2 nets][rmax][hs]: the activations of layers
                // 0..L-1; in the backward slot l + 1 holds d(pre-activation)
                // of layer l (slot L the last layer's)
  float* xs;    // [rows][D]
  float* ys;    // [rows]
  float* ms;    // [rows]
  float* outm;  // [rows] mean-net output, then d(mean)
  float* outk;  // [rows] kernel-net feature, then d(feature)
  float* pls;   // [nt] per-task d(lengthscale)
  float* pnz;   // [nt] per-task d(noise)
  float* pql;   // [nt] per-task w_t (quad + logdet), with kValue
  float* run;   // [3] the sums of pls, pnz, pql over the tiles so far
  int t0, nt;   // the first task and the number of tasks (the CTA's, or a tile's)
  int rows;     // nt * N
  int rmax;     // a slot's height: rows of the largest CTA of the cluster, or of a tile
  int hs;       // row stride of an activation slot, H or H + 1
};

// Tiles of `tile` tasks over nt tasks (one when nt <= tile).
__host__ __device__ __forceinline__ int n_tiles(int nt, int tile) {
  return nt <= tile ? 1 : (nt + tile - 1) / tile;
}

// The rows of tile j of the CTA's tasks w: tasks [w.t0 + j tile, ..).
__device__ __forceinline__ ClusterRows tile_rows(const ClusterRows& w, int j, int tile, int N) {
  ClusterRows r = w;
  r.t0 = w.t0 + j * tile;
  r.nt = min(tile, w.nt - j * tile);
  r.rows = r.nt * N;
  return r;
}

// Floats of the activation slots of one CTA.
__host__ __device__ __forceinline__ size_t act_floats(int l, int rmax, int hs) {
  return static_cast<size_t>(l + 1) * 2 * rmax * hs;
}

__device__ __forceinline__ float* slot_of(const ClusterRows& w, int s, int net) {
  return w.act + (static_cast<size_t>(s) * 2 + net) * w.rmax * w.hs;
}

// Loads the CTA's rows of x [T, N, D], y, mask [T, N]. No barrier.
__device__ __forceinline__ void load_rows(const float* x, const float* y, const float* mask, int N,
                                          int D, const ClusterRows& w) {
  const size_t r0 = static_cast<size_t>(w.t0) * N;
  for (int c = threadIdx.x; c < w.rows * D; c += blockDim.x) w.xs[c] = x[r0 * D + c];
  for (int c = threadIdx.x; c < w.rows; c += blockDim.x) {
    w.ys[c] = y[r0 + c];
    w.ms[c] = mask[r0 + c];
  }
}

// The forward of both nets of th over the CTA's rows: activations into the
// slots 0..L-1, the mean net's output into outm, the kernel net's feature
// into outk. o: the leaf offsets, per net (0 mean, 1 kernel) w_l, b_l for
// each layer, then w_out, b_out; after both nets lengthscale_raw,
// noise_raw. Ends with a block barrier.
__device__ void cluster_forward(const float* th, const int* o, int D, int H, int L,
                                const ClusterRows& w) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int R = w.rows, hs = w.hs, S = 2 * L + 2;
  for (int e = tid; e < 2 * R * H; e += nth) {
    const int rn = e / H, j = e - rn * H, net = rn >= R, row = rn - net * R;
    const float* w0 = th + o[net * S];
    float s = th[o[net * S + 1] + j];
    for (int c = 0; c < D; ++c) s += w.xs[row * D + c] * w0[c * H + j];
    slot_of(w, 0, net)[row * hs + j] = tanhf(s);
  }
  __syncthreads();
  const int n_rp = (R + 1) >> 1, n_cq = (H + 3) >> 2;
  for (int l = 1; l < L; ++l) {
    for (int e = tid; e < 2 * n_rp * n_cq; e += nth) {
      const int q = e / n_cq, j0 = 4 * (e - q * n_cq), net = q >= n_rp, rp = q - net * n_rp;
      const int r0 = 2 * rp, r1 = min(r0 + 1, R - 1);
      const float* p0 = slot_of(w, l - 1, net) + r0 * hs;
      const float* p1 = slot_of(w, l - 1, net) + r1 * hs;
      const float* wl = th + o[net * S + 2 * l];
      int jc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) jc[k] = min(j0 + k, H - 1);
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < H; ++c) {
        const float u0 = p0[c], u1 = p1[c];
        const float* wr = wl + c * H;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wv = wr[jc[k]];
          a0[k] = fmaf(u0, wv, a0[k]);
          a1[k] = fmaf(u1, wv, a1[k]);
        }
      }
      const float* bl = th + o[net * S + 2 * l + 1];
      float* cur = slot_of(w, l, net);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k < H) {
          const float b = bl[j0 + k];
          cur[r0 * hs + j0 + k] = tanhf(a0[k] + b);
          if (r0 + 1 < R) cur[(r0 + 1) * hs + j0 + k] = tanhf(a1[k] + b);
        }
      }
    }
    __syncthreads();
  }
  // the output layer, four lanes an output, summed in one fixed order
  for (int base = 0; base < 8 * R; base += nth) {
    const int e = base + tid, q = e >> 2, part = e & 3;
    const int net = q >= R, row = q - net * R;
    float s = 0.f;
    if (q < 2 * R) {
      const float* last = slot_of(w, L - 1, net) + row * hs;
      const float* wout = th + o[net * S + 2 * L];
      for (int j = part; j < H; j += 4) s = fmaf(last[j], wout[j], s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (q < 2 * R && part == 0) (net == 0 ? w.outm : w.outk)[row] = s + th[o[net * S + 2 * L + 1]];
  }
  __syncthreads();
}

// The Cholesky factor lf of a + jit I (lower, N <= 8 unrolled) with the
// reciprocals of its diagonal in inv (rsqrt of each pivot, the factor's
// entries by multiplication); true when every pivot is finite and > 0.
template <int N>
__device__ bool factor_inv(const float (&a)[N][N], float jit, float (&lf)[N][N], float (&inv)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i][j] + (i == j ? jit : 0.f);
#pragma unroll
      for (int q = 0; q < j; ++q) s -= lf[i][q] * lf[j][q];
      if (i == j) {
        ok = ok && (s > 0.f) && (s < INFINITY);
        inv[i] = rsqrtf(s);
        lf[i][i] = s * inv[i];
      } else {
        lf[i][j] = s * inv[j];
      }
    }
  }
  return ok;
}

// One task's masked MLL gradient, the kernel entries' exponentials kept for
// the gradient and the factor's pivots inverted once. mu/ph are the rows'
// net outputs on entry and receive d(mean)/d(feature) on exit. With kValue,
// *ql_out receives the task's quad + logdet of the factor used.
template <int N, bool kValue>
__device__ void task_mll(float* mu, float* ph, const float* y, const float* msk, float inv_ls,
                         float sp_nz, float w, float* dls_out, float* dnz_out, float* ql_out) {
  float z[N], mk[N], r[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    z[i] = ph[i] * inv_ls;
    mk[i] = msk[i];
    r[i] = (y[i] - mu[i]) * mk[i];
  }
  float a[N][N], ek[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float dz = z[i] - z[j];
      ek[i][j] = expf(-0.5f * dz * dz);
      float val = ek[i][j] * mk[i] * mk[j];
      if (i == j) val += mk[i] > 0.f ? sp_nz + 1e-6f : 1.f;
      a[i][j] = val;
    }
  }
  float lf[N][N], inv[N];
  if (!factor_inv<N>(a, 0.f, lf, inv) && !factor_inv<N>(a, 1e-4f, lf, inv))
    factor_inv<N>(a, 1e-2f, lf, inv);

  float zs[N], al[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = r[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= lf[i][q] * zs[q];
    zs[i] = s * inv[i];
  }
  if (kValue) {
    float ql = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) ql += zs[i] * zs[i] + 2.f * logf(lf[i][i]);
    *ql_out = ql;
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = zs[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) s -= lf[q][i] * al[q];
    al[i] = s * inv[i];
  }
  // W = L^-1 (lower), then K^-1 = W^T W into a (symmetric, full)
  float wi[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = j; i < N; ++i) {
      float s = (i == j) ? 1.f : 0.f;
#pragma unroll
      for (int q = j; q < i; ++q) s -= lf[i][q] * wi[q][j];
      wi[i][j] = s * inv[i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = 0.f;
#pragma unroll
      for (int q = i; q < N; ++q) s += wi[q][i] * wi[q][j];
      a[i][j] = s;
      a[j][i] = s;
    }
  }

  float dn = 0.f, dl = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = w * al[i] * mk[i];
    dn += 0.5f * w * (al[i] * al[i] - a[i][i]) * mk[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float g = 0.5f * w * (al[i] * al[j] - a[i][j]);
      const float dz = z[i] - z[j];
      const float dd2 = -0.5f * (g * mk[i] * mk[j]) * (i >= j ? ek[i][j] : ek[j][i]);
      acc += 2.f * dd2 * dz;
    }
    const float dz_i = 2.f * acc;
    ph[i] = dz_i * inv_ls;
    dl += dz_i * (-z[i]) * inv_ls;
  }
  *dls_out = dl;
  *dnz_out = dn;
}

// The MLL gradients of the CTA's tasks of N points, task i on thread
// (i mod 32) * warps + i / 32 (one lane in each warp first). w_t [T] the
// task weights, counts [T] this step's draw counts or null (an undrawn task
// gets weight 0). Ends with a block barrier.
template <int N, bool kValue>
__device__ void cluster_tasks(const float* th, const int* o, int L, const float* w_t,
                              const float* counts, const ClusterRows& w) {
  const int S = 2 * L + 2;
  const float inv_ls = 1.f / softplus(th[o[2 * S]]), sp_nz = softplus(th[o[2 * S + 1]]);
  const int n_warps = blockDim.x >> 5;
  for (int i = (threadIdx.x & 31) * n_warps + (threadIdx.x >> 5); i < w.nt; i += blockDim.x) {
    const int t = w.t0 + i;
    float wt = w_t[t];
    if (counts != nullptr) {
      const float c = counts[t];
      wt = c > 0.f ? wt * c : 0.f;
    }
    float ql = 0.f;
    task_mll<N, kValue>(w.outm + i * N, w.outk + i * N, w.ys + i * N, w.ms + i * N, inv_ls, sp_nz,
                        wt, w.pls + i, w.pnz + i, &ql);
    if (kValue) w.pql[i] = wt > 0.f ? wt * ql : 0.f;
  }
  __syncthreads();
}

// The backward of both nets of th into the CTA's partial score sc [P] (every
// weight and bias of both nets, lengthscale_raw and noise_raw), from
// d(mean) in outm and d(feature) in outk. With kValue, *wql_out receives the
// sum of the CTA's pql. Over tiles: the first tile (first) starts every sum
// at 0, a later one continues it from sc (w.run for the per-task sums), and
// only the last (last) forms the lengthscale's and noise's entries and
// *wql_out; a CTA of one tile passes both. No trailing barrier.
template <bool kValue>
__device__ void cluster_backward(const float* th, float* sc, const int* o, int D, int H, int L,
                                 const ClusterRows& w, float* wql_out, bool first = true,
                                 bool last = true) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int R = w.rows, hs = w.hs, S = 2 * L + 2;
  if (tid == 0) {
    float sl = first ? 0.f : w.run[0], sn = first ? 0.f : w.run[1];
    float sq = first || !kValue ? 0.f : w.run[2];
    for (int i = 0; i < w.nt; ++i) {
      sl += w.pls[i];
      sn += w.pnz[i];
      if (kValue) sq += w.pql[i];
    }
    if (last) {
      sc[o[2 * S]] = sl * sigmoid(th[o[2 * S]]);
      sc[o[2 * S + 1]] = sn * sigmoid(th[o[2 * S + 1]]);
      if (kValue) *wql_out = sq;
    } else {
      w.run[0] = sl;
      w.run[1] = sn;
      w.run[2] = sq;
    }
  }
  // the output layer: w_out, b_out gradients; d(pre-activation) of layer L-1 into slot L
  for (int e = tid; e < 2 * (H + 1) + 2 * R * H; e += nth) {
    if (e < 2 * (H + 1)) {
      const int net = e / (H + 1), j = e - net * (H + 1);
      const float* dout = net == 0 ? w.outm : w.outk;
      const float* last_act = slot_of(w, L - 1, net);
      float s = first ? 0.f : sc[j < H ? o[net * S + 2 * L] + j : o[net * S + 2 * L + 1]];
      if (j < H) {
        for (int row = 0; row < R; ++row) s = fmaf(last_act[row * hs + j], dout[row], s);
        sc[o[net * S + 2 * L] + j] = s;
      } else {
        for (int row = 0; row < R; ++row) s += dout[row];
        sc[o[net * S + 2 * L + 1]] = s;
      }
    } else {
      const int e2 = e - 2 * (H + 1);
      const int rn = e2 / H, j = e2 - rn * H, net = rn >= R, row = rn - net * R;
      const float av = slot_of(w, L - 1, net)[row * hs + j];
      const float* wout = th + o[net * S + 2 * L];
      slot_of(w, L, net)[row * hs + j] =
          (net == 0 ? w.outm : w.outk)[row] * wout[j] * (1.f - av * av);
    }
  }
  __syncthreads();
  // hidden layer l: g_l in slot l + 1, a_{l-1} in slot l - 1; the weight and
  // bias gradients (2 x 4 tiles: rows c of W_l, c = H the bias) and
  // d(pre-activation) of layer l - 1 (2 rows x 4 units) into slot l
  const int n_cp = (H + 2) >> 1, n_cq = (H + 3) >> 2, n_rp = (R + 1) >> 1;
  const int tiles_w = 2 * n_cp * n_cq, tiles_g = 2 * n_rp * n_cq;
  for (int l = L - 1; l >= 1; --l) {
    for (int e = tid; e < tiles_w + tiles_g; e += nth) {
      if (e < tiles_w) {
        const int q = e / n_cq, j0 = 4 * (e - q * n_cq), net = q >= n_cp, cp = q - net * n_cp;
        const int c0 = 2 * cp, c1 = c0 + 1;
        const float* g = slot_of(w, l + 1, net);
        const float* a = slot_of(w, l - 1, net);
        const int ca = min(c0, H - 1), cb = min(c1, H - 1);
        const bool one0 = c0 >= H, one1 = c1 >= H;
        int jc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) jc[k] = min(j0 + k, H - 1);
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        if (!first) {  // the sums of the previous tiles
          const int off_w = o[net * S + 2 * l], off_b = o[net * S + 2 * l + 1];
          const float* s0 = sc + (c0 < H ? off_w + c0 * H : off_b) + j0;
          const float* s1 = sc + (c1 < H ? off_w + c1 * H : off_b) + j0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (j0 + k < H) {
              a0[k] = s0[k];
              if (c1 <= H) a1[k] = s1[k];
            }
          }
        }
#pragma unroll 2
        for (int row = 0; row < R; ++row) {
          const float u0 = one0 ? 1.f : a[row * hs + ca];
          const float u1 = one1 ? 1.f : a[row * hs + cb];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float gv = g[row * hs + jc[k]];
            a0[k] = fmaf(u0, gv, a0[k]);
            a1[k] = fmaf(u1, gv, a1[k]);
          }
        }
        const int off_w = o[net * S + 2 * l], off_b = o[net * S + 2 * l + 1];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + k;
          if (j < H) {
            sc[(c0 < H ? off_w + c0 * H : off_b) + j] = a0[k];
            if (c1 < H) sc[off_w + c1 * H + j] = a1[k];
            else if (c1 == H) sc[off_b + j] = a1[k];
          }
        }
      } else {
        const int e2 = e - tiles_w;
        const int q = e2 / n_cq, c0 = 4 * (e2 - q * n_cq), net = q >= n_rp, rp = q - net * n_rp;
        const int r0 = 2 * rp, r1 = min(r0 + 1, R - 1);
        const float* g0 = slot_of(w, l + 1, net) + r0 * hs;
        const float* g1 = slot_of(w, l + 1, net) + r1 * hs;
        const float* wl = th + o[net * S + 2 * l];
        int cc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) cc[k] = min(c0 + k, H - 1) * H;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        // rotated start: the threads of a warp read different banks of W_l
        int j = c0;
#pragma unroll 4
        for (int jj = 0; jj < H; ++jj) {
          const float v0 = g0[j], v1 = g1[j];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wv = wl[cc[k] + j];
            a0[k] = fmaf(v0, wv, a0[k]);
            a1[k] = fmaf(v1, wv, a1[k]);
          }
          j = j + 1 == H ? 0 : j + 1;
        }
        const float* ap = slot_of(w, l - 1, net);
        float* gp = slot_of(w, l, net);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = c0 + k;
          if (c < H) {
            const float u0 = ap[r0 * hs + c];
            gp[r0 * hs + c] = a0[k] * (1.f - u0 * u0);
            if (r0 + 1 < R) {
              const float u1 = ap[(r0 + 1) * hs + c];
              gp[(r0 + 1) * hs + c] = a1[k] * (1.f - u1 * u1);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // layer 0: W_0 [D][H] and b_0 (c = D) from the inputs and slot 1
  for (int e = tid; e < 2 * (D + 1) * H; e += nth) {
    const int rn = e / H, j = e - rn * H, net = rn > D, c = rn - net * (D + 1);
    const float* g = slot_of(w, 1, net);
    float s = first ? 0.f : sc[c < D ? o[net * S] + c * H + j : o[net * S + 1] + j];
    if (c < D) {
      for (int row = 0; row < R; ++row) s = fmaf(w.xs[row * D + c], g[row * hs + j], s);
      sc[o[net * S] + c * H + j] = s;
    } else {
      for (int row = 0; row < R; ++row) s += g[row * hs + j];
      sc[o[net * S + 1] + j] = s;
    }
  }
}

// The CTA's partial score section of th into sc [P] (see the top of this
// file), for tasks of N points. With kValue, *wql_out receives the CTA's
// sum_t w_t (quad_t + logdet_t) (an undrawn or empty task adds exactly 0).
// x, y, mask null: w holds the rows of all the CTA's tasks, loaded once by
// the caller; else the CTA walks its tasks in tiles of `tile` tasks, each
// tile's rows loaded from x [T, N, D], y, mask [T, N] first. No trailing
// barrier: the caller's cluster barrier follows.
template <int N, bool kValue>
__device__ __forceinline__ void cluster_score(const float* th, float* sc, const int* o, int D,
                                              int H, int L, const float* w_t,
                                              const float* counts, const ClusterRows& w,
                                              float* wql_out, int tile = 0,
                                              const float* x = nullptr, const float* y = nullptr,
                                              const float* mask = nullptr) {
  if (x == nullptr) {
    cluster_forward(th, o, D, H, L, w);
    cluster_tasks<N, kValue>(th, o, L, w_t, counts, w);
    cluster_backward<kValue>(th, sc, o, D, H, L, w, wql_out);
    return;
  }
  const int nj = n_tiles(w.nt, tile);
  for (int j = 0; j < nj; ++j) {
    const ClusterRows wt = tile_rows(w, j, tile, N);
    if (j > 0) __syncthreads();  // the previous tile's backward has read its rows
    load_rows(x, y, mask, N, D, wt);
    __syncthreads();
    cluster_forward(th, o, D, H, L, wt);
    cluster_tasks<N, kValue>(th, o, L, w_t, counts, wt);
    cluster_backward<kValue>(th, sc, o, D, H, L, wt, wql_out, j == 0, j == nj - 1);
  }
}

// f(std::integral_constant<int, N>()) for the runtime task size n in 1..8:
// one kernel instance a task size, so that each holds only its own
// unrolled algebra.
template <typename F>
int with_task_size(int n, F f) {
  switch (n) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Coordinate c of the cluster's vector whose CTA partials are v, summed in
// rank order (cluster_util.cuh).
__device__ __forceinline__ float cluster_sum(const cgc::cluster_group& cluster, float* v, int c) {
  return cluster_sum_upto<kMaxCluster>(cluster, v, c);
}

// Copies the other CTAs' slices of the cluster's vector v [p] (slices of
// slice_len floats, CTA q's own in its shared memory) into this CTA's v, a
// coordinate of every slice at a time. Run after a cluster barrier that
// follows every CTA's write of its own slice; no trailing barrier.
__device__ __forceinline__ void cluster_gather(const cgc::cluster_group& cluster, float* v, int p) {
  const int n = static_cast<int>(cluster.num_blocks()), me = static_cast<int>(cluster.block_rank());
  const int sl = slice_len(p, n);
  for (int i = threadIdx.x; i < sl; i += blockDim.x) {
    float part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < n && q != me && q * sl + i < p) part[q] = cluster.map_shared_rank(v, q)[q * sl + i];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < n && q != me && q * sl + i < p) v[q * sl + i] = part[q];
  }
}

// 16 bytes from device memory written in this launch (through L2) to shared
// memory, asynchronously (cp.async.cg); both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of the thread's committed groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Copies coordinate src[j * stride] of rows j < n of two arrays in device
// memory (written by other SMs in this launch: read through L2) to dst[j *
// dst_stride], sixteen rows of each in flight at a time.
__device__ __forceinline__ void stage_rows2(const float* src_a, const float* src_b, size_t stride,
                                            int n, float* dst_a, float* dst_b, int dst_stride) {
  for (int j0 = 0; j0 < n; j0 += 16) {
    float a[16], b[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (j0 + u < n) {
        a[u] = __ldcg(src_a + (j0 + u) * stride);
        b[u] = __ldcg(src_b + (j0 + u) * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (j0 + u < n) {
        dst_a[(j0 + u) * dst_stride] = a[u];
        dst_b[(j0 + u) * dst_stride] = b[u];
      }
    }
  }
}

// Resident clusters of c CTAs (kClusterThreads threads and `bytes` of
// dynamic shared memory each) on the card, into *out.
template <typename Kernel>
int cluster_capacity(Kernel kernel, int c, size_t bytes, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, reinterpret_cast<const void*>(kernel), &cfg));
}

// Launches n_clusters clusters of c CTAs of `kernel` (one argument, q) as one
// cooperative grid, after checking that every cluster can be resident at
// once (cudaOccupancyMaxActiveClusters; refused with
// cudaErrorCooperativeLaunchTooLarge otherwise). Returns cudaGetLastError().
template <typename Kernel, typename Params>
int cluster_launch(Kernel kernel, const Params& q, int n_clusters, int c, size_t bytes,
                   cudaStream_t stream) {
  if (c < 1 || c > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const int e = cluster_capacity(kernel, c, bytes, &resident);
  if (e != 0) return e;
  if (resident < n_clusters) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * c);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
