// A whole PACOH-VI training run in one launch: n_steps iterations of
// (S reparameterised samples, their scores, the closed-form gradients of the
// negative ELBO, Adam) for the diagonal Gaussian hyper-posterior
// q = N(loc, diag(exp(log_scale))^2) over a GP prior with an NN mean and an
// NN kernel (feature_dim 1, L hidden layers of width H), on T tasks of
// N <= 8 points.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_vi_kernel.py (fused_vi_train_packed; body _make_vi_kernel, spec
// ops/fused_vi_math.py). Per step, with eps_s the step's standard normals:
//   sample    theta_s = loc + exp(log_scale) * eps_s
//   score     score_s = d obj_s / d theta_s: the GP prior's score section
//             (cluster_score.cuh, shared with the fused SVGD kernel) plus the
//             hyper-prior term pf * -(theta - loc_p) / scale_p^2
//   objective obj_s = pf * lp_s - 0.5 (wql_s + mll_const), lp_s =
//             -0.5 sum_p ((theta_s - loc_p) / scale_p)^2 + lp_const, wql_s =
//             sum_t w_t (quad_t + logdet_t) from the score section's factors
//   gradients g_loc = -mean_s score_s,
//             g_log_scale = -exp(log_scale) mean_s(score_s eps_s) - pf
//   Adam      on loc and log_scale, bias corrections 1 - exp(t log b) in
//             float32; the loss -(mean_s obj_s + pf (ent_const +
//             sum log_scale)) of the pre-update posterior.
//
// What bounds it on the card: at sin_20 (S=10, T=20, N=5, H=32, P=2308) a
// sample's score is the fused SVGD kernel's particle score (about 1.3 MFLOP
// of MLP products and a few thousand flops of 5x5 linear algebra a task),
// and the step's reduction over the samples is about 3 S P flops. Neither
// the bytes (the step's eps page is S P floats, 92 KB) nor the card's flops
// bound it: latency does. With one block a sample (this kernel's first
// design) a clock64() profile of block 0 found the MLP passes 72% of its
// cycles and the reduction over the samples with Adam 16%. With clusters of
// 8 a step takes about 32k cycles of block 0, 17 us (H100 80GB HBM3,
// 700 W): both MLP passes 44%, the reduction over the samples with Adam
// 16%, the three barriers 13%.
// The design: one thread-block cluster of C CTAs a sample (C from
// ops/cuda/fused_vi_kernel.py's cluster_plan). Every CTA holds the sample
// whole in shared memory, owns a contiguous group of tasks (their rows'
// forward, MLL and backward, in register tiles) and a slice of P, with the
// posterior and both pairs of Adam moments of that slice. The cluster sums
// the CTAs' partial scores slice by slice in rank order over distributed
// shared memory; each CTA adds the hyper-prior term to its slice, publishes
// it to an L2-resident scratch double-buffered by step parity (so no CTA
// overwrites what a slower one still reads), with its partial objective
// terms, and passes one grid barrier a step (cooperative launch). Then
// every cluster performs the identical reduction over the S samples of each
// slice, in one fixed order, and the identical Adam update, so all copies
// of a slice keep the same bits; each CTA forms its slice of the next sample
// and gathers the others over distributed shared memory. Cluster 0 keeps
// the loss (a step late, where its first CTA waits anyway) and writes the
// state back at the end. No float atomics: a run
// gives the same bits however it is split into launches. Where a CTA's rows
// do not fit beside the rest (many tasks), it walks them in tiles of the
// plan's `tile` tasks (cluster_score.cuh), with the bits of one pass over
// them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxS = 32;
constexpr int kMaxN = 8;
constexpr size_t kMaxSmem = 232448;
// Adam constants as optax forms them in float32 from Python doubles
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);   // log(0.9)
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835335); // log(0.999)

struct Params {
  float* loc;           // [P] in/out
  float* lsc;           // [P] in/out, log_scale
  float* m_loc;         // [P] in/out, Adam moments of loc and log_scale
  float* m_lsc;
  float* v_loc;
  float* v_lsc;
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] pre / n_eff, 0 for empty tasks
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const float* eps;     // [n_steps, S, P] standard normals
  const float* prior_loc;    // [P]
  const float* prior_scale;  // [P]
  const int* offs;      // leaf offsets (cluster_score.cuh)
  float* s_buf;         // [2, S, P] scratch: the samples' scores
  float* o_buf;         // [2, S, C, 2] scratch: each CTA's partial quad and wql
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int s, t, n, d, h, l, p, n_steps;
  int c;                // CTAs a cluster
  int hs;               // row stride of the activations, H or H + 1
  int tile;             // tasks a tile; >= ceil(T / C): the CTA's rows held whole
  float step0, lr, pf, mll_const, lp_const, ent_const;
};

// Shared-memory floats of one CTA, its rows those of `tile` tasks at most;
// ops/cuda/fused_vi_kernel.py (smem_bytes) states the same count.
size_t smem_floats(int t, int n, int d, int l, int p, int c, int hs, int tile) {
  const int groups = (t + c - 1) / c;
  const size_t tmax = groups < tile ? groups : tile, rmax = tmax * n;
  return 2 * static_cast<size_t>(p) + act_floats(l, static_cast<int>(rmax), hs) + rmax * (d + 4) +
         3 * tmax + 6 * static_cast<size_t>(slice_len(p, c)) + 32 + 8 + 4 * static_cast<size_t>(l) +
         6;
}

#include "fused_update.cuh"

template <int N>
__global__ void __launch_bounds__(kClusterThreads, 1) fused_vi_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = q.s, T = q.t, D = q.d, H = q.h, L = q.l, P = q.p, C = q.c;
  const int me = blockIdx.x / C, rank = blockIdx.x - me * C;  // sample, CTA of its cluster
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tmax = (T + C - 1) / C, tile = min(tmax, q.tile), rmax = tile * N;
  const bool tiled = tile < tmax;  // the rows loaded a tile at a time, every step
  const int t0 = task_lo(rank, T, C), nt = task_lo(rank + 1, T, C) - t0;
  const int sl = slice_len(P, C), s_lo = min(P, rank * sl), s_hi = min(P, s_lo + sl);

  float* th = smem;                             // [P] this cluster's sample, whole
  float* sc = th + P;                           // [P] this CTA's partial score
  float* act = sc + P;                          // activation slots
  float* xs = act + act_floats(L, rmax, q.hs);  // [rmax][D]
  float* ys = xs + rmax * D;                    // [rmax]
  float* ms = ys + rmax;                        // [rmax]
  float* outm = ms + rmax;                      // [rmax]
  float* outk = outm + rmax;                    // [rmax]
  float* pls = outk + rmax;                     // [tile]
  float* pnz = pls + tile;                      // [tile]
  float* pql = pnz + tile;                      // [tile]
  float* loc = pql + tile;                      // [sl] my slice of the posterior and of
  float* lsc = loc + sl;                        //      its Adam moments, the same bits in
  float* mlo = lsc + sl;                        //      every cluster
  float* mls = mlo + sl;
  float* vlo = mls + sl;
  float* vls = vlo + sl;
  float* red = vls + sl;                        // [32] block_sum's partials
  float* scal = red + 32;                       // [8] 0: my tasks' wql, 1: my slice's sum of
                                                //     log_scale, 4-6: the tiles' sums
  int* o = reinterpret_cast<int*>(scal + 8);    // [4L + 6] the leaf offsets
  const ClusterRows w{act, xs, ys, ms, outm, outk, pls, pnz, pql, scal + 4,
                      t0, nt, nt * N, rmax, q.hs};

  for (int c = s_lo + tid; c < s_hi; c += nth) {
    const int i = c - s_lo;
    loc[i] = q.loc[c];
    lsc[i] = q.lsc[c];
    mlo[i] = q.m_loc[c];
    mls[i] = q.m_lsc[c];
    vlo[i] = q.v_loc[c];
    vls[i] = q.v_lsc[c];
    th[c] = loc[i] + expf(lsc[i]) * __ldg(q.eps + static_cast<size_t>(me) * P + c);
  }
  if (!tiled) load_rows(q.x, q.y, q.mask, N, D, w);
  for (int i = tid; i < 4 * L + 6; i += nth) o[i] = q.offs[i];
  cluster.sync();
  cluster_gather(cluster, th, P);
  __syncthreads();

  const float sf = static_cast<float>(S);
  float loss = 0.f, loss_sum = 0.f;  // kept by CTA 0 of cluster 0
  // the loss of the step that published o_buf[lpar], by the first warp of
  // CTA 0 of cluster 0, sample j on lane j; run before the next step's
  // barrier A, where that CTA (the first task group, never larger than the
  // others) waits anyway
  const auto step_loss = [&](int lpar) {
    if (me != 0 || rank != 0 || tid >= 32) return;
    float obj = 0.f, ls_part = 0.f;
    if (tid < S) {
      const float* o_j = q.o_buf + (static_cast<size_t>(lpar) * S + tid) * C * 2;
      float part[2 * kMaxCluster];
#pragma unroll
      for (int r = 0; r < 2 * kMaxCluster; ++r)
        if (r < 2 * C) part[r] = __ldcg(o_j + r);
      float qj = 0.f, wj = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < C) {
          qj += part[2 * r];
          wj += part[2 * r + 1];
        }
      }
      obj = q.pf * (-0.5f * qj + q.lp_const) + (-0.5f * (wj + q.mll_const));
    }
    if (tid < C) ls_part = cluster.map_shared_rank(scal, tid)[1];
    for (int off = 16; off > 0; off >>= 1) {  // one fixed order
      obj += __shfl_down_sync(0xffffffffu, obj, off);
      ls_part += __shfl_down_sync(0xffffffffu, ls_part, off);
    }
    if (tid == 0) {
      loss = -(obj / sf + q.pf * (q.ent_const + ls_part));
      loss_sum += loss;
    }
  };
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;
    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;
    const bool more = it + 1 < q.n_steps;
    const float* eps_next = eps_it + static_cast<size_t>(S) * P + static_cast<size_t>(me) * P;
    // bring the step's noise of my slice (every sample's, for the reduction)
    // and the next step's of my sample into L2 while the score runs
    const int line0 = s_lo >> 5, n_lines = s_hi > s_lo ? ((s_hi - 1) >> 5) - line0 + 1 : 0;
    for (int e = tid; e < (S + more) * n_lines; e += nth) {
      const int j = e / n_lines, at = (line0 + e - j * n_lines) << 5;
      const float* row = j < S ? eps_it + static_cast<size_t>(j) * P : eps_next;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + at));
    }

    // ---- my tasks' partial of the sample's score and objective; the
    // cluster's sum of my slice with the hyper-prior term; publish both
    cluster_score<N, true>(th, sc, o, D, H, L, q.w_t,
                        q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T,
                        w, scal, tile, tiled ? q.x : nullptr, q.y, q.mask);
    if (it > 0) step_loss((it - 1) & 1);
    cluster.sync();
    float* s_pub = q.s_buf + (static_cast<size_t>(par) * S + me) * P;
    float quad = 0.f;
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      const float scale = q.prior_scale[c];
      const float dv = th[c] - q.prior_loc[c];
      const float z = dv / scale;
      quad += z * z;
      s_pub[c] = cluster_sum(cluster, sc, c) + q.pf * (-dv / (scale * scale));
    }
    quad = block_sum(quad, red);
    if (tid == 0) {
      float* o_pub = q.o_buf + ((static_cast<size_t>(par) * S + me) * C + rank) * 2;
      o_pub[0] = quad;
      o_pub[1] = scal[0];
    }
    grid.sync();

    // ---- every cluster: the gradients of my slice over the S samples in one
    // order, Adam; my slice of the next sample
    const float* s_all = q.s_buf + static_cast<size_t>(par) * S * P;
    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    float lsum = 0.f;  // the pre-update sum of my slice's log_scale, for the loss
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      const int i = c - s_lo;
      float gs = 0.f, ge = 0.f;
      for (int j0 = 0; j0 < S; j0 += 16) {  // sixteen samples' loads in flight
        float sv[16], ev[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (j0 + u < S) {
            sv[u] = __ldcg(s_all + static_cast<size_t>(j0 + u) * P + c);
            ev[u] = __ldg(eps_it + static_cast<size_t>(j0 + u) * P + c);
          }
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (j0 + u < S) {
            gs += sv[u];
            ge += sv[u] * ev[u];
          }
        }
      }
      const float ls = lsc[i];
      lsum += ls;
      const float g_loc = -gs / sf;
      const float g_lsc = -expf(ls) * ge / sf - q.pf;
      adam(g_loc, loc[i], mlo[i], vlo[i], q.lr, bc1, bc2);
      adam(g_lsc, lsc[i], mls[i], vls[i], q.lr, bc1, bc2);
      if (more) th[c] = loc[i] + expf(lsc[i]) * __ldg(eps_next + c);
    }
    lsum = block_sum(lsum, red);
    if (tid == 0) scal[1] = lsum;
    cluster.sync();
    if (more) cluster_gather(cluster, th, P);
    __syncthreads();
  }
  step_loss((q.n_steps - 1) & 1);
  cluster.sync();  // no CTA exits while another reads its shared memory

  if (me == 0) {
    for (int c = s_lo + tid; c < s_hi; c += nth) {
      const int i = c - s_lo;
      q.loc[c] = loc[i];
      q.lsc[c] = lsc[i];
      q.m_loc[c] = mlo[i];
      q.m_lsc[c] = mls[i];
      q.v_loc[c] = vlo[i];
      q.v_lsc[c] = vls[i];
    }
    if (rank == 0 && tid == 0) {
      q.loss_out[0] = loss;
      q.loss_out[1] = loss_sum;
    }
  }
}

}  // namespace

extern "C" int pacoh_fused_vi(float* loc, float* lsc, float* m_loc, float* m_lsc, float* v_loc,
                              float* v_lsc, const float* x, const float* y, const float* mask,
                              const float* w_t, const float* counts, const float* eps,
                              const float* prior_loc, const float* prior_scale, const int* offs,
                              float* s_buf, float* o_buf, float* loss_out, int s, int t, int n,
                              int d, int h, int l, int p, int n_steps, int c, int hs, int tile,
                              float step0, float lr, float pf, float mll_const, float lp_const,
                              float ent_const, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s < 1 || s > kMaxS || n < 1 || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 || p < 1 ||
      n_steps < 1 || c < 1 || c > kMaxCluster || (hs != h && hs != h + 1) || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, l, p, c, hs, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, counts, eps, prior_loc,
                 prior_scale, offs, s_buf, o_buf, loss_out, s, t, n, d, h, l, p, n_steps, c, hs,
                 tile, step0, lr, pf, mll_const, lp_const, ent_const};
  return with_task_size(n, [&](auto nn) {
    return cluster_launch(fused_vi_kernel<decltype(nn)::value>, q, s, c, bytes,
                          static_cast<cudaStream_t>(stream));
  });
}

// Resident clusters of c CTAs of the kernel at this configuration, into *out
// (cudaOccupancyMaxActiveClusters).
extern "C" int pacoh_fused_vi_clusters(int t, int n, int d, int h, int l, int p, int c, int hs,
                                       int tile, int* out, int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c < 1 || c > kMaxCluster || (hs != h && hs != h + 1) || tile < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, l, p, c, hs, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return with_task_size(n, [&](auto nn) {
    return cluster_capacity(fused_vi_kernel<decltype(nn)::value>, c, bytes, out);
  });
}
