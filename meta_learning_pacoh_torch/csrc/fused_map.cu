// A whole PACOH-MAP training run in one launch: n_steps iterations of
// (loss -sum_t w_t MLL_t and its gradient, AdamW) for one GP prior with an
// NN mean and an NN-featurised RBF kernel (any depths and widths of the two
// nets, D inputs, F <= 8 features) on T tasks of N <= 8 points.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_map_kernel.py (fused_map_train_packed; body _make_kernel). Per step:
//   forward   both tanh MLPs over the rows of the step's tasks; softplus
//             lengthscale [F], outputscale, noise + the 1e-3 floor
//   MLL       per task, the entry-wise Kn (noise + floor + 1e-6 on real
//             diagonals, 1.0 on padded ones), trial factorizations at jitter
//             0 and 1e-4 choosing 0 / 1e-4 / 1e-2 (a factor is good when
//             every diagonal is finite and > 0), L, z, alpha, L^-1, K^-1, and
//             the loss -sum_t w_t (-1/2)(quad + logdet + n_t log 2 pi) with
//             w_t = 1/n_t (times the step's draw count of a sampled batch)
//   backward  G = w/2 (alpha alpha^T - K^-1) into d(mean), d(feature),
//             d(lengthscale), d(outputscale), d(noise); both MLPs' backward
//   AdamW     optax.adamw: bias corrections 1 - exp(t log b) in float32, then
//             theta - lr (update + weight_decay theta).
//
// What bounds it on the card: at the reference demo (T=20, N=5, D=1, two
// nets 32x32, F=2, P=2343) a full-batch step needs about 1.3 MFLOP of MLP
// products and a few hundred flops of 5x5 linear algebra per task; a
// sampled batch of 5 draws about 4.5 distinct tasks a step and needs only
// their rows, about 0.3 MFLOP. Neither the bytes nor the card's flops bound
// it: the latency of the passes' chains and of the barriers does. There is
// one model, so the design spreads its tasks over the CTAs of one
// thread-block cluster (fused_map_cluster_kernel, C CTAs from
// ops/cuda/fused_map_kernel.py's map_plan): every CTA holds the parameters
// whole in shared memory and owns a contiguous group of tasks (their rows,
// activations and per-task algebra) and a slice of P with its AdamW
// moments. A step: the CTA's drawn tasks' rows forward and backward (an
// undrawn task's rows are skipped: it adds exactly 0) in register tiles
// (map_tiles.cuh; map_nets.cuh's scalar passes for widths that are no
// multiple of 4), the per-task algebra one thread a task, minus the CTA's
// partial gradient and loss into its shared memory; a cluster barrier; each
// CTA sums its slice over the cluster's partials in rank order over
// distributed shared memory, applies AdamW to it and stores the new slice
// into every CTA's copy of the parameters; a cluster barrier. No grid
// barrier and no round trip of the parameters through L2. Where one
// cluster's CTAs cannot hold the tasks' rows and activations (thousands of
// tasks) or the parameters beside their partial gradient (nets of 128
// units), the plan takes the first design (fused_map_kernel): G blocks of a
// cooperative grid, the partial gradients in a [G, P + 1] scratch, two grid
// barriers a step. No float atomics: every sum has one fixed order, so a run
// gives the same bits however it is split into launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;
constexpr int kMaxF = 8;
constexpr int kMaxGroups = 128;
constexpr size_t kMaxSmem = 232448;

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 16;  // the largest cluster a Hopper card holds (non-portable above 8)

#include "map_nets.cuh"
#include "lane_sums.cuh"
#include "map_tiles.cuh"
#include "cluster_util.cuh"

struct Params {
  float* theta;         // [P] in/out
  float* m;             // [P] in/out
  float* v;             // [P] in/out
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] 1 / n_t, 0 for an empty task
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const int* offs;      // leaf offsets, see the kernel
  const int* widths;    // hidden widths: the mean net's, then the kernel net's
  float* gbuf;          // [G, P + 1] scratch: partial loss gradients, partial loss
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, groups, tpb;
  float step0, lr, wd, noise_floor;
};

// Shared-memory floats of one block; ops/cuda/fused_map_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int tpb, int n, int d, int f, int p, int sum_h) {
  const size_t r = static_cast<size_t>(tpb) * n;
  return static_cast<size_t>(p) + r * sum_h + r * (d + 3 + f) + f + static_cast<size_t>(tpb) * (f + 3);
}

// The Cholesky factor lf of a + jit I (lower, N <= 8 unrolled) with the
// reciprocals of its diagonal in inv (rsqrt of each pivot, the factor's
// entries by multiplication, so that no division lies on the pivot chain);
// true when every pivot is finite and > 0.
template <int N>
__device__ __forceinline__ bool factor(const float (&a)[N][N], float jit, float (&lf)[N][N],
                                       float (&inv)[N]) {
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

// One task's weighted MLL and its gradient. On entry mu holds the rows'
// mean-net outputs and ph their features [N][F]; on exit mu holds
// d(sum ll)/d(mean) and ph d(sum ll)/d(feature). out [F + 3] receives the
// task's d/d(softplus lengthscale) [F], d/d(softplus outputscale) times the
// outputscale, d/d(noise), and its loss term -ll. The task's z = feature /
// lengthscale and its kernel entries stay in registers.
// Not inlined: each N's body is compiled as a function of its own, not all
// eight into the kernel, which keeps the build short.
template <int N>
__device__ __noinline__ void task_grad(float* mu, float* ph, const float* y, const float* msk,
                                       int F, const float* sp_ls, float sp_os, float diag_add,
                                       float w, float* out) {
  if (w == 0.f) {  // a task not drawn this step, or an empty one, adds exactly 0
#pragma unroll
    for (int i = 0; i < N; ++i) mu[i] = 0.f;
    for (int c = 0; c < N * F; ++c) ph[c] = 0.f;
    for (int c = 0; c < F + 3; ++c) out[c] = 0.f;
    return;
  }
  float mk[N], r[N], z[N][kMaxF], lsc[kMaxF];
  float n_eff = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxF; ++c) lsc[c] = c < F ? sp_ls[c] : 1.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mk[i] = msk[i];
    r[i] = (y[i] - mu[i]) * mk[i];
    n_eff += mk[i];
#pragma unroll
    for (int c = 0; c < kMaxF; ++c) z[i][c] = c < F ? ph[i * F + c] / lsc[c] : 0.f;
  }

  float km[N][N], a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxF; ++c) {
        const float dz = z[i][c] - z[j][c];
        d2 += dz * dz;
      }
      const float k = sp_os * expf(-0.5f * d2);
      km[i][j] = k;
      km[j][i] = k;
      float val = k * mk[i] * mk[j];
      if (i == j) val += mk[i] > 0.f ? diag_add : 1.f;
      a[i][j] = val;
    }
  }
  // the first of the jitters 0, 1e-4 whose factor is good, else 1e-2
  float lf[N][N], inv[N];
  if (!factor<N>(a, 0.f, lf, inv) && !factor<N>(a, 1e-4f, lf, inv)) factor<N>(a, 1e-2f, lf, inv);

  float zs[N], al[N];
  float quad_logdet = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = r[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= lf[i][q] * zs[q];
    zs[i] = s * inv[i];
    quad_logdet += zs[i] * zs[i] + 2.f * logf(lf[i][i]);
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
  out[F + 2] = 0.5f * w * (quad_logdet + n_eff * kLog2Pi);  // -ll of the task

  // G_ij = w/2 (alpha_i alpha_j - K^-1_ij); dd2 = d/d(squared distance) into a
  float dn = 0.f, dos = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = w * al[i] * mk[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float g = 0.5f * w * (al[i] * al[j] - a[i][j]);
      const float dkm = g * mk[i] * mk[j];
      if (i == j) dn += g * mk[i];
      dos += (i == j ? 1.f : 2.f) * dkm * km[i][j];  // each unordered pair once
      const float dd2 = -0.5f * dkm * km[i][j];
      a[i][j] = dd2;
      a[j][i] = dd2;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxF; ++c) {
    if (c >= F) break;
    float dl = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += 2.f * a[i][j] * (z[i][c] - z[j][c]);
      const float dz = 2.f * acc;  // the ordered pairs (i, j) and (j, i)
      dl += dz * (-z[i][c]) / lsc[c];
      ph[i * F + c] = dz / lsc[c];
    }
    out[c] = dl;
  }
  out[F] = dos;
  out[F + 1] = dn;
}

__device__ void task_grad_n(int n, float* mu, float* ph, const float* y, const float* msk, int F,
                            const float* sp_ls, float sp_os, float diag_add, float w, float* out) {
  switch (n) {
    case 1: task_grad<1>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 2: task_grad<2>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 3: task_grad<3>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 4: task_grad<4>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 5: task_grad<5>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 6: task_grad<6>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    case 7: task_grad<7>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
    default: task_grad<8>(mu, ph, y, msk, F, sp_ls, sp_os, diag_add, w, out); break;
  }
}

__global__ void __launch_bounds__(kThreads) fused_map_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = q.t, N = q.n, D = q.d, F = q.f, P = q.p, G = q.groups;
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x;
  const int task0 = blk * q.tpb;
  const int nt = min(q.tpb, T - task0);  // this block's tasks
  const int R = nt * N, r_max = q.tpb * N;

  float* th = smem;                        // [P] the parameters
  float* act_m = th + P;                   // mean net activations, then their gradients
  float* act_k = act_m + r_max * q.sum_hm; // kernel net activations, then their gradients
  float* xs = act_k + r_max * q.sum_hk;    // [R][D]
  float* ys = xs + r_max * D;            // [R]
  float* ms = ys + r_max;                // [R]
  float* outm = ms + r_max;              // [R] mean-net output, then d(mean)
  float* outk = outm + r_max;            // [R][F] features, then d(feature)
  float* sp_ls = outk + r_max * F;       // [F]
  float* part = sp_ls + F;               // [tpb][F + 3] per-task partials (see task_grad)

  // leaf offsets: the mean net's w_0, b_0, ..., w_out, b_out, then the
  // kernel net's, then lengthscale_raw, outputscale_raw, noise_raw
  const int* o_m = q.offs;
  const int* o_k = q.offs + 2 * q.lm + 2;
  const int off_ls = o_k[2 * q.lk + 2], off_os = o_k[2 * q.lk + 3], off_nz = o_k[2 * q.lk + 4];

  for (int c = tid; c < P; c += nth) th[c] = q.theta[c];
  for (int c = tid; c < R * D; c += nth) xs[c] = q.x[static_cast<size_t>(task0) * N * D + c];
  for (int c = tid; c < R; c += nth) {
    ys[c] = q.y[static_cast<size_t>(task0) * N + c];
    ms[c] = q.mask[static_cast<size_t>(task0) * N + c];
  }
  __syncthreads();

  float loss_sum = 0.f, loss = 0.f;  // kept by thread 0 of block 0
  for (int it = 0; it < q.n_steps; ++it) {
    float* gb = q.gbuf + static_cast<size_t>(blk) * (P + 1);

    net_forward(th, o_m, q.widths, q.lm, 1, xs, D, R, r_max, act_m, outm);
    net_forward(th, o_k, q.widths + q.lm, q.lk, F, xs, D, R, r_max, act_k, outk);
    if (tid < F) sp_ls[tid] = softplus(th[off_ls + tid]);
    __syncthreads();

    // per-task loss and gradient, one thread a task
    const float sp_os = softplus(th[off_os]);
    const float diag_add = softplus(th[off_nz]) + q.noise_floor + 1e-6f;
    for (int i = tid; i < nt; i += nth) {
      const int t = task0 + i;
      float w = q.w_t[t];
      if (q.counts != nullptr) {
        const float c = q.counts[static_cast<size_t>(it) * T + t];
        w = c > 0.f ? w * c : 0.f;
      }
      task_grad_n(N, outm + i * N, outk + i * N * F, ys + i * N, ms + i * N, F, sp_ls, sp_os,
                  diag_add, w, part + i * (F + 3));
    }
    __syncthreads();

    // both nets' backward, and the hyperparameters' gradients
    net_backward(th, o_m, q.widths, q.lm, 1, xs, D, R, r_max, act_m, outm, gb);
    net_backward(th, o_k, q.widths + q.lm, q.lk, F, xs, D, R, r_max, act_k, outk, gb);
    if (tid <= F + 2) {
      float s = 0.f;
      for (int i = 0; i < nt; ++i) s += part[i * (F + 3) + tid];
      if (tid < F) {
        gb[off_ls + tid] = -(s * sigmoid(th[off_ls + tid]));
      } else if (tid == F) {
        gb[off_os] = -(s * sigmoid(th[off_os]) / sp_os);
      } else if (tid == F + 1) {
        gb[off_nz] = -(s * sigmoid(th[off_nz]));
      } else {
        gb[P] = s;
      }
    }
    grid.sync();

    // reduce my coordinates over the G partials in one order; AdamW
    const float step_loss = adamw_split(q.gbuf, G, P, th, q.theta, q.m, q.v,
                                        q.step0 + static_cast<float>(it) + 1.f, q.lr, q.wd);
    if (blk == 0 && tid == 0) {
      loss = step_loss;
      loss_sum += loss;
    }
    if (it + 1 < q.n_steps) {
      grid.sync();
      for (int c = tid; c < P; c += nth) th[c] = __ldcg(q.theta + c);
      __syncthreads();
    }
  }
  if (blk == 0 && tid == 0) {
    q.loss_out[0] = loss;
    q.loss_out[1] = loss_sum;
  }
}


struct ClusterParams {
  float* theta;         // [P] in/out
  float* m;             // [P] in/out
  float* v;             // [P] in/out
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] 1 / n_t, 0 for an empty task
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const int* offs;      // leaf offsets, as fused_map_kernel's
  const int* widths;    // hidden widths: the mean net's, then the kernel net's
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps;
  int tiled;            // 1 map_tiles.cuh's passes, 0 map_nets.cuh's
  float step0, lr, wd, noise_floor;
};

// Shared-memory floats of one CTA of a cluster of c; ops/cuda/fused_map_kernel.py
// (cluster_smem_bytes) states the same count: the parameters, the partial
// gradient and loss, the AdamW moments of the slice, both nets' activations
// [sum_h][rmax | 1], the rows (and their compaction to the drawn tasks'), the
// nets' outputs, the per-task partials, weights and indices, four scalars.
__host__ __device__ __forceinline__ size_t cluster_smem_floats(int t, int n, int d, int f, int p,
                                                               int sum_h, int c) {
  const size_t tmax = (t + c - 1) / c, rmax = tmax * n;
  return 2 * static_cast<size_t>(p) + 1 + 2 * static_cast<size_t>(slice_len(p, c)) +
         static_cast<size_t>(sum_h) * (rmax | 1) + rmax * (2 * d + 5 + f) + tmax * (f + 5) + f + 4;
}

__global__ void __launch_bounds__(kClusterThreads, 1) fused_map_cluster_kernel(ClusterParams q) {
  extern __shared__ __align__(16) float smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int T = q.t, N = q.n, D = q.d, F = q.f, P = q.p;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, nth = blockDim.x, lane = tid & 31, n_warps = nth >> 5;
  const int tmax = (T + C - 1) / C, rmax = tmax * N, ld = rmax | 1;
  const int t0 = task_lo(rank, T, C), nt = task_lo(rank + 1, T, C) - t0;
  const int sl = slice_len(P, C), s_lo = min(P, rank * sl), s_hi = min(P, s_lo + sl);

  float* th = smem;                          // [P] the parameters, whole
  float* sc = th + P;                        // [P + 1] minus the CTA's partial gradient, its loss
  float* ms_m = sc + P + 1;                  // [sl] AdamW m of my slice
  float* ms_v = ms_m + sl;                   // [sl] AdamW v of my slice
  float* act_m = ms_v + sl;                  // [sum_hm][ld] mean-net activations
  float* act_k = act_m + q.sum_hm * ld;      // [sum_hk][ld] kernel-net activations
  float* xs = act_k + q.sum_hk * ld;         // [rmax][D] the CTA's rows
  float* ys = xs + rmax * D;                 // [rmax]
  float* mk = ys + rmax;                     // [rmax]
  float* xa = mk + rmax;                     // [rmax][D] the drawn tasks' rows
  float* ya = xa + rmax * D;                 // [rmax]
  float* ma = ya + rmax;                     // [rmax]
  float* outm = ma + rmax;                   // [rmax] mean-net output, then d(mean)
  float* outk = outm + rmax;                 // [rmax][F] features, then d(feature)
  float* part = outk + rmax * F;             // [tmax][F + 3] per-task partials (task_grad)
  float* wa = part + tmax * (F + 3);         // [tmax] the drawn tasks' weights
  int* ta = reinterpret_cast<int*>(wa + tmax);  // [tmax] their local indices
  float* sp_ls = wa + 2 * tmax;              // [F]
  int* scal = reinterpret_cast<int*>(sp_ls + F);  // [4] the number of drawn tasks

  const int* o_m = q.offs;
  const int* o_k = q.offs + 2 * q.lm + 2;
  const int* wd_m = q.widths;
  const int* wd_k = q.widths + q.lm;
  const int off_ls = o_k[2 * q.lk + 2], off_os = o_k[2 * q.lk + 3], off_nz = o_k[2 * q.lk + 4];
  const TileNet nets[2] = {{o_m, wd_m, q.lm, 1, act_m, outm}, {o_k, wd_k, q.lk, F, act_k, outk}};

  for (int c = tid; c < P; c += nth) th[c] = q.theta[c];
  for (int c = s_lo + tid; c < s_hi; c += nth) {
    ms_m[c - s_lo] = q.m[c];
    ms_v[c - s_lo] = q.v[c];
  }
  const size_t r0 = static_cast<size_t>(t0) * N;
  for (int c = tid; c < nt * N * D; c += nth) xs[c] = q.x[r0 * D + c];
  for (int c = tid; c < nt * N; c += nth) {
    ys[c] = q.y[r0 + c];
    mk[c] = q.mask[r0 + c];
  }
  __syncthreads();

  float loss_sum = 0.f, loss = 0.f;  // kept by thread 0 of rank 0
  for (int it = 0; it < q.n_steps; ++it) {
    // the step's drawn tasks of the CTA, in order (warp 0, 32 tasks a round)
    if (tid < 32) {
      int na = 0;
      for (int b = 0; b < nt; b += 32) {
        const int i = b + lane;
        float w = 0.f;
        if (i < nt) {
          w = q.w_t[t0 + i];
          if (q.counts != nullptr) {
            const float c = q.counts[static_cast<size_t>(it) * T + t0 + i];
            w = c > 0.f ? w * c : 0.f;
          }
        }
        const unsigned drawn = __ballot_sync(0xffffffffu, w != 0.f);
        if (w != 0.f) {
          const int at = na + __popc(drawn & ((1u << lane) - 1u));
          wa[at] = w;
          ta[at] = i;
        }
        na += __popc(drawn);
      }
      if (lane == 0) scal[0] = na;
    }
    if (tid < F) sp_ls[tid] = softplus(th[off_ls + tid]);
    __syncthreads();
    const int na = scal[0], R = na * N;
    const bool all = na == nt;  // no compaction needed
    if (!all) {
      for (int e = tid; e < R * D; e += nth) {
        const int a = e / (N * D), rest = e - a * N * D;
        xa[e] = xs[ta[a] * N * D + rest];
      }
      for (int e = tid; e < R; e += nth) {
        const int a = e / N, rest = e - a * N;
        ya[e] = ys[ta[a] * N + rest];
        ma[e] = mk[ta[a] * N + rest];
      }
      __syncthreads();
    }
    const float* xr = all ? xs : xa;
    const float* yr = all ? ys : ya;
    const float* mr = all ? mk : ma;

    if (q.tiled) {
      tile_nets_forward(th, nets, xr, D, R, ld);
    } else {
      net_forward(th, o_m, wd_m, q.lm, 1, xr, D, R, ld, act_m, outm);
      net_forward(th, o_k, wd_k, q.lk, F, xr, D, R, ld, act_k, outk);
      __syncthreads();
    }

    // per-task loss and gradient, task a on thread (a mod 32) * warps + a / 32
    const float sp_os = softplus(th[off_os]);
    const float diag_add = softplus(th[off_nz]) + q.noise_floor + 1e-6f;
    for (int a = (tid & 31) * n_warps + (tid >> 5); a < na; a += nth)
      task_grad_n(N, outm + a * N, outk + a * N * F, yr + a * N, mr + a * N, F, sp_ls, sp_os,
                  diag_add, wa[a], part + a * (F + 3));
    __syncthreads();

    // both nets' backward, and the hyperparameters' gradients and the loss
    if (q.tiled) {
      tile_nets_backward(th, nets, xr, D, R, ld, sc);
    } else {
      net_backward(th, o_m, wd_m, q.lm, 1, xr, D, R, ld, act_m, outm, sc);
      net_backward(th, o_k, wd_k, q.lk, F, xr, D, R, ld, act_k, outk, sc);
    }
    if (tid <= F + 2) {
      float s = 0.f;
      for (int a = 0; a < na; ++a) s += part[a * (F + 3) + tid];
      if (tid < F) {
        sc[off_ls + tid] = -(s * sigmoid(th[off_ls + tid]));
      } else if (tid == F) {
        sc[off_os] = -(s * sigmoid(th[off_os]) / sp_os);
      } else if (tid == F + 1) {
        sc[off_nz] = -(s * sigmoid(th[off_nz]));
      } else {
        sc[P] = s;
      }
    }
    cluster.sync();

    // my slice: the cluster's sum in rank order, AdamW; the step's loss
    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    const bool more = it + 1 < q.n_steps;
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      const float g = cluster_sum_upto<kMaxCluster>(cluster, sc, c);
      const float mn = kB1 * ms_m[c - s_lo] + kOneMinusB1 * g;
      const float vn = kB2 * ms_v[c - s_lo] + kOneMinusB2 * g * g;
      ms_m[c - s_lo] = mn;
      ms_v[c - s_lo] = vn;
      const float upd = (mn / bc1) / (sqrtf(vn / bc2) + kEps);
      const float tn = th[c] - q.lr * (upd + q.wd * th[c]);
      th[c] = tn;
      // the new coordinate into every other CTA's copy: each reads only its
      // own slice of th until the barrier below
      if (more)
        for (int r = 0; r < C; ++r)
          if (r != rank) cluster.map_shared_rank(th, r)[c] = tn;
    }
    if (rank == 0 && tid == 0) {
      loss = cluster_sum_upto<kMaxCluster>(cluster, sc, P);
      loss_sum += loss;
    }
    // every slice is updated and in every copy (and no CTA reads another's
    // shared memory any more, so none may exit early)
    cluster.sync();
  }
  for (int c = s_lo + tid; c < s_hi; c += nth) {
    q.theta[c] = th[c];
    q.m[c] = ms_m[c - s_lo];
    q.v[c] = ms_v[c - s_lo];
  }
  if (rank == 0 && tid == 0) {
    q.loss_out[0] = loss;
    q.loss_out[1] = loss_sum;
  }
}

// The launch configuration of one cluster of c CTAs with `bytes` of dynamic
// shared memory each (attrs: room for one attribute).
template <typename Kernel>
cudaLaunchConfig_t cluster_config(Kernel kernel, int c, size_t bytes, cudaLaunchAttribute* attr,
                                  cudaStream_t stream, cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
  if (*err == cudaSuccess && c > 8)
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" int pacoh_fused_map(float* theta, float* m, float* v, const float* x, const float* y,
                               const float* mask, const float* w_t, const float* counts,
                               const int* offs, const int* widths, float* gbuf, float* loss_out,
                               int t, int n, int d, int f, int lm, int lk, int sum_hm, int sum_hk,
                               int p, int n_steps, int groups, int tpb, float step0,
                               float lr, float wd, float noise_floor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxN || f < 1 || f > kMaxF || t < 1 || d < 1 || lm < 1 || lk < 1 ||
      sum_hm < lm || sum_hk < lk || p < 1 || n_steps < 1 || groups < 1 || groups > kMaxGroups || tpb < 1 ||
      groups * tpb < t || (groups - 1) * tpb >= t)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(tpb, n, d, f, p, sum_hm + sum_hk) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_map_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < groups) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{theta, m, v, x, y, mask, w_t, counts, offs, widths, gbuf, loss_out,
           t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, groups, tpb, step0, lr, wd,
           noise_floor};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_map_kernel), dim3(groups),
                                    dim3(kThreads), args, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster design: one cluster of c CTAs (1 <= c <= 16) holds the model;
// refused (cudaErrorCooperativeLaunchTooLarge) where the card cannot hold
// one such cluster (cudaOccupancyMaxActiveClusters).
extern "C" int pacoh_fused_map_cluster(float* theta, float* m, float* v, const float* x,
                                       const float* y, const float* mask, const float* w_t,
                                       const float* counts, const int* offs, const int* widths,
                                       float* loss_out, int t, int n, int d, int f, int lm, int lk,
                                       int sum_hm, int sum_hk, int p, int n_steps, int c,
                                       int tiled, float step0, float lr, float wd,
                                       float noise_floor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || n > kMaxN || f < 1 || f > kMaxF || t < 1 || d < 1 || lm < 1 || lk < 1 ||
      sum_hm < lm || sum_hk < lk || p < 1 || n_steps < 1 || c < 1 || c > kMaxCluster || c > t)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = cluster_smem_floats(t, n, d, f, p, sum_hm + sum_hk, c) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(fused_map_cluster_kernel, c, bytes, attr,
                                          static_cast<cudaStream_t>(stream), &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(
      &resident, reinterpret_cast<const void*>(fused_map_cluster_kernel), &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const ClusterParams q{theta, m, v, x, y, mask, w_t, counts, offs, widths, loss_out,
                        t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, tiled,
                        step0, lr, wd, noise_floor};
  err = cudaLaunchKernelEx(&cfg, fused_map_cluster_kernel, q);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
