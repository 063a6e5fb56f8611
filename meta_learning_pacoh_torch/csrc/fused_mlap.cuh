// A whole PACOH-MLAP training run in one launch, or, in meta-test mode, the
// whole inference of per-task posteriors on new tasks: n_steps iterations
// of the nested two-level PAC-Bayes bound with every gradient in closed
// form and two-group Adam.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_mlap_kernel.py (fused_mlap_train_packed; body _make_mlap_kernel,
// spec ops/fused_mlap_math.py). The state: the diagonal Gaussian
// hyper-posterior (loc, log_scale) [P] over a GP prior with an NN mean and
// an NN kernel (feature_dim 1, L hidden layers of width H), the likelihood
// noise raw_noise, and per task t of N <= 8 points a Gaussian q_t(f) =
// N(q_means[t], L0_t L0_t^T), L0_t = tril(q_trils[t]) (padded points pinned
// to N(0, 1)). Per step, with eps_s the step's standard normals and u_t the
// task weights (the step's draw counts times u_scale):
//   sample    theta_s = loc + exp(log_scale) eps_s, s < S
//   inner KL  KL_st = KL(q_t || GP prior of theta_s at the task's points):
//             the gram K1 without noise, jitter 1e-6 / 1e-4 / 1e-2 chosen by
//             trial factorizations, L1, L1^-1, K^-1, w = K^-1 (mu - m0)
//   bound     c_t = log 2 + log n_t + log n_tasks - log delta,
//             C_t = sqrt((kl_outer + tkw mean_s KL_st + c_t) / (2 (n_t - 1))),
//             loss = sum_t u_t (-avg_ll_t + C_t) + meta_complexity, the
//             outer KL in closed form (times mkw)
//   gradients gamma_t = u_t tkw / (2 (2 (n_t - 1)) C_t S); the KL's closed
//             form VJP dKL/dK1 = 0.5 (K^-1 - (K^-1 L0)(K^-1 L0)^T - w w^T)
//             chained through the gram into d(mean), d(feature) and both
//             MLPs' backward (cluster_score.cuh) into score_s; (loc,
//             log_scale) by the reparameterisation reduction over s plus the
//             outer KL's terms; q_t and the noise from the expected
//             log-likelihood and the sqrt chain
//   Adam      optax's, bias corrections 1 - exp(t log b) in float32: lr_main
//             on loc, log_scale, raw_noise; lr_post on q_means, q_trils.
// Meta-test mode (the TPU kernel's meta_test=True): loc, log_scale and
// raw_noise are frozen (theta still sampled every step), the loss is the
// plain sum of the per-task bounds (u_t = 1, no meta-complexity), and only
// q_means, q_trils get gradients and Adam at lr_post; c_t keeps the
// meta-train task count.
//
// What bounds it on the card: one sample's work a step is the fused VI
// kernel's (both MLPs forward and backward over T*N rows, about 1.3 MFLOP at
// sin_20) plus T small KL systems, and the step's reduction over the samples
// is about 3 S P flops: a few MFLOP on a few hundred KB, microseconds at the
// card's peaks. Not bytes and not flops but latency bounds it: the MLP
// passes, the serial N x N algebra of one thread a task, and the grid
// barriers (two a step, one in meta-test mode). The first design ran one
// block a sample (5 of 132 SMs at mlap's S=5) on one-block MLP passes and
// repeated the whole Adam update of every coordinate in every block.
// The design: one thread-block cluster of C CTAs a sample (C from
// ops/cuda/fused_mlap_kernel.py's cluster_plan), B7's layout (fused_vi.cu).
// Every CTA holds the sample whole in shared memory and owns a contiguous
// group of tasks (their rows, the q-side state of those tasks and its Adam
// moments) and a slice of P (loc, log_scale and both pairs of moments of
// it). A step: both nets forward over the CTA's rows in register tiles
// (cluster_forward); one thread a task computes KL_st (rsqrt pivots,
// cluster_score.cuh's factor_inv) with gamma left out (the gradients are
// linear in gamma_t), the q-side partials K^-1 (mu - m0) and K^-1 L0, the
// task's d(mean), d(feature), d(lengthscale), avg_ll and its noise
// derivative; it publishes them to an L2-resident scratch double-buffered
// by step parity, and the grid passes barrier 1 (cooperative launch).
// Every CTA then forms every task's bound from all samples' KLs, in one
// order: gamma_t of its own tasks, chi, the noise gradient (cluster 0 also
// the loss and diagnostics). It scales its rows' cotangents by gamma_t,
// runs both nets backward (cluster_backward), the cluster sums the CTAs'
// partial scores slice by slice in rank order over distributed shared
// memory, each CTA publishes its slice, and the grid passes barrier 2. Then
// the CTA of rank r of every cluster reduces over the S samples, in one
// fixed order, its slice of P and its tasks' q-side coordinates, and runs
// Adam on them, so all copies of a coordinate keep the same bits; it forms
// its slice of the next sample and of the next step's outer KL, and the
// cluster gathers both over distributed shared memory. No float atomics: a
// run gives the same bits however it is split into launches.
// Many tasks (kTiled, where a CTA's rows, posteriors and moments do not fit
// beside the rest): each cluster keeps its own copy of the posteriors and
// their moments in device memory (touched by one owner CTA, the same bits in
// every copy as in shared memory), and a CTA walks its tasks in tiles of the
// plan's `tile` tasks: before barrier 1 each tile's forward and inner KLs,
// with the cotangents d(mean), d(feature), d(lengthscale) kept in device
// memory; after it each tile's forward again, its cotangents times gamma_t
// and its backward, every sum of the partial score continued from the
// previous tile (cluster_score.cuh). Each task's bound, each gradient and
// so every bit of the state are the untiled CTA's. One barrier a step still
// in meta-test mode, two in training.
//
// The kernel and its launch, shared by fused_mlap.cu (the untiled kernel) and
// fused_mlap_tiled.cu (the tiled one): two files, so that nvcc builds the
// two sets of instances in parallel. Included once a translation unit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cluster_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxS = 32;
constexpr int kMaxN = 8;
constexpr size_t kMaxSmem = 232448;
constexpr int kWarps = kClusterThreads / 32;
constexpr int kRed = 5 * kWarps;  // block_sums' partials, up to five values
// Adam constants as optax forms them in float32 from Python doubles
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);   // log(0.9)
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835335); // log(0.999)
constexpr float kLog2 = static_cast<float>(0.6931471805599453);
constexpr float kLog2Pi = static_cast<float>(1.8378770664093453);

struct Params {
  // the state and its Adam moments, updated in place; in meta-test mode the
  // moments of loc, log_scale and raw_noise are not read and may be null
  float* loc;    // [P]
  float* lsc;    // [P] log_scale
  float* qm;     // [T, N] q_means
  float* qt;     // [T, N, N] q_trils
  float* nu;     // [1] raw_noise
  float* m_loc;
  float* m_lsc;
  float* m_qm;
  float* m_qt;
  float* m_nu;
  float* v_loc;
  float* v_lsc;
  float* v_qm;
  float* v_qt;
  float* v_nu;
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* counts;  // [n_steps, T] task-draw counts, or null (every count 1)
  const float* eps;     // [n_steps, S, P] standard normals
  const float* prior_loc;    // [P]
  const float* prior_scale;  // [P]
  const int* offs;      // leaf offsets (cluster_score.cuh)
  float* kl_buf;        // [2, S, T, 3] scratch: KL_st, avg_ll_t, d avg_ll_t / d noise_var
  float* q_buf;         // [2, S, T N (N + 1)] scratch: K^-1 (mu - m0), then K^-1 L0
  float* s_buf;         // [2, S, P] scratch: the samples' scores
  float* t_buf;         // [S, tile_floats(T, N)] scratch of the tiled kernel, else null
  float* out;           // [5] last loss, sum of the launch's losses, and the last
                        // step's sum_t u_t avg_ll_t, kl_outer, sum_t u_t kl_inner_t
  int s, t, n, d, h, l, p, n_steps, meta_test;
  int c;                // CTAs a cluster
  int hs;               // row stride of the activations, H or H + 1
  int tile;             // tasks a tile; >= ceil(T / C): the untiled kernel
  float step0, lr_main, lr_post, u_scale, tkw, mkw, neg_log_delta, log_n_tasks, cm2,
      sum_log_sigma_p;
};

// Floats of one cluster's scratch in the tiled kernel, at M = T N: the
// posteriors and their moments (3 M (N + 1)), the rows' cotangents (2 M),
// each task's d(lengthscale), gamma_t and u_t (3 T).
__host__ __device__ __forceinline__ size_t tile_floats(int t, int n) {
  const size_t m = static_cast<size_t>(t) * n;
  return 3 * m * (n + 1) + 2 * m + 3 * static_cast<size_t>(t);
}

// Shared-memory floats of one CTA; tiled (tile < ceil(T / C)): its rows
// those of `tile` tasks and no task's posterior. ops/cuda/
// fused_mlap_kernel.py (smem_bytes) states the same count.
size_t smem_floats(int t, int n, int d, int l, int p, int c, int hs, int tile) {
  const size_t tmax = (t + c - 1) / c;
  const size_t rest = 2 * static_cast<size_t>(p) + 6 * static_cast<size_t>(slice_len(p, c)) +
                      kRed + 16 + 4 * static_cast<size_t>(l) + 6;
  if (static_cast<size_t>(tile) < tmax) {
    const size_t rmax = static_cast<size_t>(tile) * n;
    return rest + act_floats(l, static_cast<int>(rmax), hs) + rmax * (d + 4) + 2 * tile;
  }
  const size_t rmax = tmax * n;
  return rest + act_floats(l, static_cast<int>(rmax), hs) + rmax * (d + 4) + 4 * tmax +
         3 * rmax * (n + 1);
}

#include "fused_update.cuh"

// The block's sums of K values a thread, each in one fixed order (the same
// in every block); every thread receives them in v. red: [K * kWarps]
// shared floats.
template <int K>
__device__ __forceinline__ void block_sums(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[k * kWarps + w];
    v[k] = s;
  }
  __syncthreads();
}

// sum_j p[j * stride], j < n, in order of j, eight loads in flight at a
// time (device memory written in this launch: read through L2).
__device__ __forceinline__ float sum_rows(const float* p, size_t stride, int n) {
  float s = 0.f;
  for (int j0 = 0; j0 < n; j0 += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < n) v[u] = __ldcg(p + (j0 + u) * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < n) s += v[u];
  }
  return s;
}

__device__ __forceinline__ float signf(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// One task's inner KL against one sample's GP prior, and everything of the
// task the step needs. mu/ph: the rows' net outputs on entry; on exit
// d(mean) and d(feature) of the task's KL with gamma_t = 1 (every read
// happens first). qm [N], qt [N, N]: the task's posterior. Out: *kl, *dls
// (d(lengthscale) with gamma_t = 1, before the softplus' sigmoid), *avg_ll
// and *dvar (d avg_ll / d noise_var), wq [N] = K^-1 (mu - m0), pq [N, N] =
// K^-1 L0 (device memory).
template <int N>
__device__ void task_kl(float* mu, float* ph, const float* y, const float* msk, const float* qm,
                        const float* qt, float sp_ls, float nv, float* kl, float* dls,
                        float* avg_ll, float* dvar, float* wq, float* pq) {
  float z[N], mk[N], dv[N];
  float l0[N][N];
  float n_eff = 0.f, lp_sum = 0.f, dv_sum = 0.f, logdet0 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mk[i] = msk[i];
    z[i] = ph[i] / sp_ls;
    n_eff += mk[i];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float f_var = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float v = 0.f;
      if (j <= i) {
        v = qt[i * N + j] * mk[i] * mk[j];
        if (i == j) v += 1.f - mk[i];
      }
      l0[i][j] = v;
      f_var += v * v;
    }
    const float qme = qm[i] * mk[i];
    const float r = y[i] - qme;
    lp_sum += -0.5f * ((r * r + f_var) / nv + logf(nv) + kLog2Pi) * mk[i];
    dv_sum += mk[i] * (0.5f * (r * r + f_var) / (nv * nv) - 0.5f / nv);
    logdet0 += 2.f * logf(fabsf(l0[i][i]) + 1e-12f);
    dv[i] = mu[i] * mk[i] - qme;
  }
  *avg_ll = lp_sum / n_eff;
  *dvar = dv_sum / n_eff;

  // the prior's gram at the task's points, no noise; padded rows identity
  float a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const float d2 = fmaxf(z[i] * z[i] + z[j] * z[j] - 2.f * (z[i] * z[j]), 0.f);
      float v = expf(-0.5f * d2) * mk[i] * mk[j];
      if (i == j) v += 1.f - mk[i];
      a[i][j] = v;
    }
  }
  float lf[N][N], inv[N];
  if (!factor_inv<N>(a, 1e-6f, lf, inv) && !factor_inv<N>(a, 1e-4f, lf, inv))
    factor_inv<N>(a, 1e-2f, lf, inv);

  // W = L1^-1 (lower), then K^-1 = W^T W into a (symmetric, full)
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

  float w[N];
  float quad = 0.f, trace = 0.f, logdet1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) s += a[i][j] * dv[j];
    w[i] = s;
    quad += dv[i] * s;
    logdet1 += 2.f * logf(lf[i][i]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float sig = 0.f;  // (L0 L0^T)_ij
#pragma unroll
      for (int k = 0; k < N; ++k) sig += l0[i][k] * l0[j][k];
      trace += a[i][j] * sig;
    }
  }
  *kl = 0.5f * (trace + quad - static_cast<float>(N) + logdet1 - logdet0);

  // PL = K^-1 L0 (reuses lf)
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = k; j < N; ++j) s += a[i][j] * l0[j][k];
      lf[i][k] = s;
      pq[i * N + k] = s;
    }
    wq[i] = w[i];
  }

  // dKL/dK1 with gamma = 1, chained through the gram into d(feature)
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float plpl = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) plpl += lf[i][k] * lf[j][k];
      const float g = 0.5f * (a[i][j] - plpl - w[i] * w[j]);
      const float dz = z[i] - z[j];
      const float d2 = fmaxf(z[i] * z[i] + z[j] * z[j] - 2.f * (z[i] * z[j]), 0.f);
      const float dd2 = -0.5f * (g * mk[i] * mk[j]) * expf(-0.5f * d2);
      acc += 2.f * dd2 * dz;
    }
    const float dz_i = 2.f * acc;
    mu[i] = w[i] * mk[i];
    ph[i] = dz_i / sp_ls;
    dl += dz_i * (-z[i]) / sp_ls;
  }
  *dls = dl;
}

// The outer KL's sums over the CTA's slice of the hyper-posterior:
// sum (exp(log_scale) / prior_scale)^2, sum ((loc - prior_loc) /
// prior_scale)^2, sum log_scale, into part [3] (one thread writes them).
__device__ __forceinline__ void outer_partials(const float* loc, const float* lsc, int s_lo,
                                               int s_hi, const float* prior_loc,
                                               const float* prior_scale, float* red,
                                               float* part) {
  float v[3] = {0.f, 0.f, 0.f};
  for (int c = s_lo + threadIdx.x; c < s_hi; c += blockDim.x) {
    const int i = c - s_lo;
    const float sp = prior_scale[c];
    const float rs = expf(lsc[i]) / sp;
    const float rq = (loc[i] - prior_loc[c]) / sp;
    v[0] += rs * rs;
    v[1] += rq * rq;
    v[2] += lsc[i];
  }
  block_sums<3>(v, red);
  if (threadIdx.x == 0) {
    part[0] = v[0];
    part[1] = v[1];
    part[2] = v[2];
  }
}

// The weighted outer KL from the cluster's slice sums (part [3] in every
// CTA's shared memory), summed in rank order, into part[3]: warp 0, rank r's
// sums on lane r. Run after a cluster barrier that follows every CTA's
// write of its part; part[3] is read after the next block barrier.
__device__ __forceinline__ void outer_kl(const cg::cluster_group& cluster, float* part,
                                         const Params& q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float v[3] = {0.f, 0.f, 0.f};
  if (lane < q.c) {
    const float* pr = cluster.map_shared_rank(part, lane);
    v[0] = pr[0];
    v[1] = pr[1];
    v[2] = pr[2];
  }
  float a_sq = 0.f, a_rq = 0.f, a_ls = 0.f;
  for (int r = 0; r < q.c; ++r) {
    a_sq += __shfl_sync(0xffffffffu, v[0], r);
    a_rq += __shfl_sync(0xffffffffu, v[1], r);
    a_ls += __shfl_sync(0xffffffffu, v[2], r);
  }
  if (lane == 0)
    part[3] = q.mkw * (0.5f * (a_sq + a_rq - static_cast<float>(q.p) + 2.f * q.sum_log_sigma_p -
                               2.f * a_ls));
}

template <int N, bool kTiled>
__global__ void __launch_bounds__(kClusterThreads, 1) fused_mlap_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const cg::cluster_group cluster = cg::this_cluster();
  const int S = q.s, T = q.t, D = q.d, H = q.h, L = q.l, P = q.p, C = q.c;
  const int M = T * N;
  const int NQ = M + M * N;  // q-side partials of one sample: w [T, N], then K^-1 L0 [T, N, N]
  const bool train = q.meta_test == 0;
  const int me = blockIdx.x / C, rank = blockIdx.x - me * C;  // sample, CTA of its cluster
  const int tid = threadIdx.x, nth = blockDim.x;
  const int tmax = (T + C - 1) / C, tile = kTiled ? q.tile : tmax, rmax = tile * N;
  const int t0 = task_lo(rank, T, C), nt = task_lo(rank + 1, T, C) - t0, rows = nt * N;
  const int nj = kTiled ? n_tiles(nt, tile) : 1;  // tiles of my tasks
  const int sl = slice_len(P, C), s_lo = min(P, rank * sl), s_hi = min(P, s_lo + sl);
  const size_t q0 = static_cast<size_t>(t0) * N;  // my tasks' first point

  float* th = smem;                             // [P] this cluster's sample, whole
  float* sc = th + P;                           // [P] this CTA's partial score
  float* act = sc + P;                          // activation slots
  float* xs = act + act_floats(L, rmax, q.hs);  // [rmax][D] (rows of a tile, kTiled)
  float* ys = xs + rmax * D;                    // [rmax]
  float* ms = ys + rmax;                        // [rmax]
  float* outm = ms + rmax;                      // [rmax]
  float* outk = outm + rmax;                    // [rmax]
  float* pls = outk + rmax;                     // [tile] d(lengthscale), then times gamma_t
  float* pnz = pls + tile;                      // [tile] 0: the inner KL has no noise
  float* sh = pnz + tile;
  // gamma_t and u_t of my tasks; my tasks' q_means, q_trils and moments, the
  // same bits in every cluster; kTiled: in this cluster's device scratch,
  // with my rows' cotangents and d(lengthscale) between the two passes
  float* tb = kTiled ? q.t_buf + static_cast<size_t>(me) * tile_floats(T, N) : nullptr;
  float* gam = kTiled ? tb + 3 * static_cast<size_t>(M) * (N + 1) + 2 * M + T + t0 : sh;
  float* uu = kTiled ? gam + T : gam + tmax;
  float* qm = kTiled ? tb + q0 : uu + tmax;     // [rows]
  float* mqm = kTiled ? qm + M : qm + rmax;
  float* vqm = kTiled ? mqm + M : mqm + rmax;
  float* qt = kTiled ? tb + 3 * M + q0 * N : vqm + rmax;  // [rows N]
  float* mqt = kTiled ? qt + M * N : qt + rmax * N;
  float* vqt = kTiled ? mqt + M * N : mqt + rmax * N;
  float* cotm = kTiled ? tb + 3 * static_cast<size_t>(M) * (N + 1) + q0 : nullptr;  // [rows]
  float* cotk = kTiled ? cotm + M : nullptr;                                           // [rows]
  float* cotl = kTiled ? tb + 3 * static_cast<size_t>(M) * (N + 1) + 2 * M + t0 : nullptr;  // [nt]
  float* loc = kTiled ? sh : vqt + rmax * N;    // [sl] my slice of the hyper-posterior and
  float* lsc = loc + sl;                        //      of its Adam moments, the same bits
  float* mlo = lsc + sl;                        //      in every cluster
  float* mls = mlo + sl;
  float* vlo = mls + sl;
  float* vls = vlo + sl;
  float* red = vls + sl;                        // [kRed] block_sums' partials
  float* scal = red + kRed;                     // [16] 0-2 my slice's outer-KL sums, 3 the
                                                //      outer KL, 4-6 the tiles' sums, 8-10
                                                //      raw_noise and its m, v
  int* o = reinterpret_cast<int*>(scal + 16);   // [4L + 6] the leaf offsets
  const ClusterRows w{act, xs, ys, ms, outm, outk, pls, pnz, nullptr, scal + 4,
                      t0, nt, rows, rmax, q.hs};
  const int off_ls = 4 * L + 4;                 // o[off_ls]: lengthscale_raw
  // my rows' targets and mask for the posteriors' update
  const float* yq = kTiled ? q.y + q0 : ys;
  const float* mq = kTiled ? q.mask + q0 : ms;

  for (int c = s_lo + tid; c < s_hi; c += nth) {
    const int i = c - s_lo;
    loc[i] = q.loc[c];
    lsc[i] = q.lsc[c];
    if (train) {
      mlo[i] = q.m_loc[c];
      mls[i] = q.m_lsc[c];
      vlo[i] = q.v_loc[c];
      vls[i] = q.v_lsc[c];
    }
    th[c] = loc[i] + expf(lsc[i]) * __ldg(q.eps + static_cast<size_t>(me) * P + c);
  }
  if (!kTiled) load_rows(q.x, q.y, q.mask, N, D, w);
  for (int c = tid; c < rows; c += nth) {
    qm[c] = q.qm[q0 + c];
    mqm[c] = q.m_qm[q0 + c];
    vqm[c] = q.v_qm[q0 + c];
  }
  for (int c = tid; c < rows * N; c += nth) {
    qt[c] = q.qt[q0 * N + c];
    mqt[c] = q.m_qt[q0 * N + c];
    vqt[c] = q.v_qt[q0 * N + c];
  }
  for (int i = tid; i < 4 * L + 6; i += nth) o[i] = q.offs[i];
  if (tid == 0) {
    scal[8] = q.nu[0];
    scal[9] = train ? q.m_nu[0] : 0.f;
    scal[10] = train ? q.v_nu[0] : 0.f;
  }
  outer_partials(loc, lsc, s_lo, s_hi, q.prior_loc, q.prior_scale, red, scal);
  cluster.sync();
  cluster_gather(cluster, th, P);
  outer_kl(cluster, scal, q);  // of the pre-update hyper-posterior
  __syncthreads();

  const float sf = static_cast<float>(S);
  const int n_warps = nth >> 5;
  float loss_sum = 0.f;  // kept by CTA 0 of cluster 0
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;
    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;
    const bool more = it + 1 < q.n_steps;
    const float* eps_next = eps_it + static_cast<size_t>(S) * P + static_cast<size_t>(me) * P;
    const float* cnt = q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T;
    // bring the step's noise of my slice (every sample's, for the reduction)
    // and the next step's of my sample into L2 while the step runs
    const int line0 = s_lo >> 5, n_lines = s_hi > s_lo ? ((s_hi - 1) >> 5) - line0 + 1 : 0;
    const int n_pre = train ? S : 0;
    for (int e = tid; e < (n_pre + more) * n_lines; e += nth) {
      const int j = e / n_lines, at = (line0 + e - j * n_lines) << 5;
      const float* row = j < n_pre ? eps_it + static_cast<size_t>(j) * P : eps_next;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + at));
    }
    const float nv = softplus(scal[8]) + 1e-4f;  // the pre-update noise variance

    // ---- both nets forward over my rows (a tile at a time); one thread a
    // task (one lane in each warp first): its KL and partials, published
    float* kl_pub = q.kl_buf + (static_cast<size_t>(par) * S + me) * T * 3;
    float* q_pub = q.q_buf + (static_cast<size_t>(par) * S + me) * NQ;
    for (int j = 0; j < nj; ++j) {
      const ClusterRows wt = kTiled ? tile_rows(w, j, tile, N) : w;
      const int i0 = j * tile;  // the tile's first task among mine
      if (kTiled) {
        if (j > 0) __syncthreads();  // the previous tile's tasks have read its rows
        load_rows(q.x, q.y, q.mask, N, D, wt);
        __syncthreads();
      }
      cluster_forward(th, o, D, H, L, wt);
      const float sp_ls = softplus(th[o[off_ls]]);
      for (int i = (tid & 31) * n_warps + (tid >> 5); i < wt.nt; i += nth) {
        const int t = wt.t0 + i, im = i0 + i;
        float kl, avl, dvr;
        task_kl<N>(outm + i * N, outk + i * N, ys + i * N, ms + i * N, qm + im * N,
                   qt + im * N * N, sp_ls, nv, &kl, pls + i, &avl, &dvr, q_pub + t * N,
                   q_pub + M + t * N * N);
        kl_pub[3 * t] = kl;
        kl_pub[3 * t + 1] = avl;
        kl_pub[3 * t + 2] = dvr;
        if (kTiled) {  // this task's cotangents, for the backward after barrier 1
#pragma unroll
          for (int k = 0; k < N; ++k) {
            cotm[im * N + k] = outm[i * N + k];
            cotk[im * N + k] = outk[i * N + k];
          }
          cotl[im] = pls[i];
        }
      }
    }
    grid.sync();

    // ---- every CTA: every task's bound from all samples' KLs, in one
    // order; gamma_t and u_t of my tasks, chi, the noise's gradient and the
    // loss terms
    const float* kl_all = q.kl_buf + static_cast<size_t>(par) * S * T * 3;
    const float* kl_mine = kl_all + static_cast<size_t>(me) * T * 3;
    const float kl_outer = scal[3];
    float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // beta, u (-dvar), u bound, u avg_ll, u kl_in
    for (int t = tid; t < T; t += nth) {
      const float avl = __ldcg(kl_mine + 3 * t + 1), dvr = __ldcg(kl_mine + 3 * t + 2);
      float n_eff = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) n_eff += __ldg(q.mask + static_cast<size_t>(t) * N + i);
      const float ks = sum_rows(kl_all + 3 * t, static_cast<size_t>(T) * 3, S);
      const float kl_in = q.tkw * (ks / sf);
      const float c_t = ((kLog2 + logf(n_eff)) + q.log_n_tasks) + q.neg_log_delta;
      const float c2 = 2.f * (n_eff - 1.f);
      const float cplx = sqrtf((kl_outer + kl_in + c_t) / c2);
      const float u = (cnt == nullptr ? 1.f : __ldg(cnt + t)) * q.u_scale;
      const float beta = u / (2.f * c2 * cplx);
      if (t >= t0 && t < t0 + nt) {
        gam[t - t0] = beta * q.tkw / sf;
        uu[t - t0] = u;
      }
      v[0] += beta;
      v[1] += u * (-dvr);
      v[2] += u * (-avl + cplx);
      v[3] += u * avl;
      v[4] += u * kl_in;
    }
    // not needed for order (block_sums has its own), but measured: a step
    // 3-4 us faster with it on an H100 (block 0's bound phase 8.5k to 3.2k
    // cycles in the clock64() profile)
    __syncthreads();
    block_sums<5>(v, red);
    float chi = v[0];
    if (train) {
      const float meta_c =
          sqrtf((((kl_outer + kLog2) + q.log_n_tasks) + q.neg_log_delta) / q.cm2);
      chi += 1.f / (2.f * q.cm2 * meta_c);
      v[2] += meta_c;
    }
    if (me == 0 && rank == 0 && tid == 0) {
      loss_sum += v[2];
      if (!more) {
        q.out[0] = v[2];
        q.out[1] = loss_sum;
        q.out[2] = v[3];
        q.out[3] = kl_outer;
        q.out[4] = v[4];
      }
    }

    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    if (train) {
      // ---- my rows' share of the sample's score: the cotangents times
      // gamma_t, both nets backward (a tile at a time, each tile's forward
      // again); the cluster's sum of my slice, published
      for (int j = 0; j < nj; ++j) {
        const ClusterRows wt = kTiled ? tile_rows(w, j, tile, N) : w;
        const int i0 = j * tile;
        if (kTiled) {
          if (j > 0) __syncthreads();  // the previous tile's backward has read its rows
          load_rows(q.x, q.y, q.mask, N, D, wt);
          __syncthreads();
          cluster_forward(th, o, D, H, L, wt);
          for (int r = tid; r < wt.rows; r += nth) {
            const float g = gam[i0 + r / N];
            outm[r] = cotm[i0 * N + r] * g;
            outk[r] = cotk[i0 * N + r] * g;
          }
          for (int i = tid; i < wt.nt; i += nth) {
            pls[i] = cotl[i0 + i] * gam[i0 + i];
            pnz[i] = 0.f;
          }
        } else {
          for (int r = tid; r < rows; r += nth) {
            const float g = gam[r / N];
            outm[r] *= g;
            outk[r] *= g;
          }
          for (int i = tid; i < nt; i += nth) {
            pls[i] *= gam[i];
            pnz[i] = 0.f;
          }
        }
        __syncthreads();
        cluster_backward<false>(th, sc, o, D, H, L, wt, nullptr, j == 0, j == nj - 1);
      }
      cluster.sync();
      float* s_pub = q.s_buf + (static_cast<size_t>(par) * S + me) * P;
      for (int c = s_lo + tid; c < s_hi; c += nth) s_pub[c] = cluster_sum(cluster, sc, c);
      grid.sync();

      // ---- every cluster: the gradients of my slice over the S samples in
      // one order, Adam; my slice of the next sample and of the outer KL
      const float* s_all = q.s_buf + static_cast<size_t>(par) * S * P;
      float vo[3] = {0.f, 0.f, 0.f};
      for (int c = s_lo + tid; c < s_hi; c += nth) {
        const int i = c - s_lo;
        const float sp = __ldg(q.prior_scale + c), mp = __ldg(q.prior_loc + c);
        const float e_next = more ? __ldg(eps_next + c) : 0.f;
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
        const float scale = expf(lsc[i]);
        const float rs = scale / sp;
        const float g_loc = gs + chi * q.mkw * (loc[i] - mp) / (sp * sp);
        const float g_lsc = scale * ge + chi * q.mkw * (rs * rs - 1.f);
        adam(g_loc, loc[i], mlo[i], vlo[i], q.lr_main, bc1, bc2);
        adam(g_lsc, lsc[i], mls[i], vls[i], q.lr_main, bc1, bc2);
        const float scale_n = expf(lsc[i]);
        const float rs_n = scale_n / sp, rq_n = (loc[i] - mp) / sp;
        vo[0] += rs_n * rs_n;
        vo[1] += rq_n * rq_n;
        vo[2] += lsc[i];
        if (more) th[c] = loc[i] + scale_n * e_next;
      }
      block_sums<3>(vo, red);
      if (tid == 0) {
        scal[0] = vo[0];
        scal[1] = vo[1];
        scal[2] = vo[2];
        // the noise, from the pre-update state
        adam(sigmoid(scal[8]) * v[1], scal[8], scal[9], scal[10], q.lr_main, bc1, bc2);
      }
    } else if (more) {  // meta-test: the frozen hyper-posterior's next sample
      for (int c = s_lo + tid; c < s_hi; c += nth) {
        const int i = c - s_lo;
        th[c] = loc[i] + expf(lsc[i]) * __ldg(eps_next + c);
      }
    }

    // ---- my tasks' posteriors: their gradients over the S samples in one
    // order, Adam at lr_post; q_means on threads [0, rows), q_trils after
    const float* q_all = q.q_buf + static_cast<size_t>(par) * S * NQ;
    for (int f = tid; f < rows * (N + 1); f += nth) {
      const bool mean = f < rows;
      const int e = mean ? f : f - rows;
      const int i = e / (mean ? N : N * N);  // my task
      float n_eff = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) n_eff += mq[i * N + k];
      const float ll_coef = uu[i] / (nv * n_eff);
      if (mean) {
        const float mk = mq[e];
        const float ws_ = sum_rows(q_all + q0 + e, NQ, S);
        const float r = yq[e] - qm[e] * mk;
        const float g = -ll_coef * mk * r - mk * (gam[i] * ws_);
        adam(g, qm[e], mqm[e], vqm[e], q.lr_post, bc1, bc2);
      } else {
        const int ij = e - i * N * N;
        const int a = ij / N, b = ij - a * N;
        float g = 0.f;
        if (b <= a) {
          const float mi = mq[i * N + a], mj = mq[i * N + b];
          float l0 = qt[e] * mi * mj;
          if (a == b) l0 += 1.f - mi;
          const float ps = sum_rows(q_all + M + q0 * N + e, NQ, S);
          float gl = gam[i] * ps;
          if (a == b) gl -= (sf * gam[i]) * (signf(l0) / (fabsf(l0) + 1e-12f));
          g = ((uu[i] / (nv * n_eff)) * l0 + gl) * mi * mj;
        }
        adam(g, qt[e], mqt[e], vqt[e], q.lr_post, bc1, bc2);
      }
    }
    if (more) {  // the next sample whole, and the next step's outer KL
      cluster.sync();
      cluster_gather(cluster, th, P);
      if (train) outer_kl(cluster, scal, q);
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA exits while another reads its shared memory

  if (me == 0) {
    for (int c = s_lo + tid; c < s_hi && train; c += nth) {
      const int i = c - s_lo;
      q.loc[c] = loc[i];
      q.lsc[c] = lsc[i];
      q.m_loc[c] = mlo[i];
      q.m_lsc[c] = mls[i];
      q.v_loc[c] = vlo[i];
      q.v_lsc[c] = vls[i];
    }
    for (int c = tid; c < rows; c += nth) {
      q.qm[q0 + c] = qm[c];
      q.m_qm[q0 + c] = mqm[c];
      q.v_qm[q0 + c] = vqm[c];
    }
    for (int c = tid; c < rows * N; c += nth) {
      q.qt[q0 * N + c] = qt[c];
      q.m_qt[q0 * N + c] = mqt[c];
      q.v_qt[q0 * N + c] = vqt[c];
    }
    if (rank == 0 && tid == 0 && train) {
      q.nu[0] = scal[8];
      q.m_nu[0] = scal[9];
      q.v_nu[0] = scal[10];
    }
  }
}

bool valid(int n, int d, int h, int l, int p, int c, int hs) {
  return n >= 1 && n <= kMaxN && d >= 1 && h >= 1 && l >= 1 && p >= 1 && c >= 1 &&
         c <= kMaxCluster && (hs == h || hs == h + 1);
}

// The launch of fused_mlap_kernel<N, kTiled> (the C entries' body):
// refuses a plan whose tiling is not kTiled.
template <bool kTiled>
int mlap_launch(float* loc, float* lsc, float* qm, float* qt, float* nu, float* m_loc,
                float* m_lsc, float* m_qm, float* m_qt, float* m_nu, float* v_loc, float* v_lsc,
                float* v_qm, float* v_qt, float* v_nu, const float* x, const float* y,
                const float* mask, const float* counts, const float* eps,
                const float* prior_loc, const float* prior_scale, const int* offs,
                float* kl_buf, float* q_buf, float* s_buf, float* t_buf, float* out, int s,
                int t, int n, int d, int h, int l, int p, int n_steps, int meta_test, int c,
                int hs, int tile, float step0, float lr_main, float lr_post, float u_scale,
                float tkw, float mkw, float neg_log_delta, float log_n_tasks, float cm2,
                float sum_log_sigma_p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s < 1 || s > kMaxS || t < 1 || n_steps < 1 || !valid(n, d, h, l, p, c, hs) || tile < 1 ||
      (tile < (t + c - 1) / c) != kTiled || (kTiled && t_buf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, l, p, c, hs, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Params q{loc, lsc, qm, qt, nu, m_loc, m_lsc, m_qm, m_qt, m_nu, v_loc, v_lsc, v_qm, v_qt,
                 v_nu, x, y, mask, counts, eps, prior_loc, prior_scale, offs, kl_buf, q_buf,
                 s_buf, t_buf, out, s, t, n, d, h, l, p, n_steps, meta_test, c, hs, tile, step0,
                 lr_main, lr_post, u_scale, tkw, mkw, neg_log_delta, log_n_tasks, cm2,
                 sum_log_sigma_p};
  return with_task_size(n, [&](auto nn) {
    return cluster_launch(fused_mlap_kernel<decltype(nn)::value, kTiled>, q, s, c, bytes,
                          static_cast<cudaStream_t>(stream));
  });
}

// Resident clusters of c CTAs of fused_mlap_kernel<N, kTiled> at this
// configuration, into *out (cudaOccupancyMaxActiveClusters).
template <bool kTiled>
int mlap_capacity(int t, int n, int d, int h, int l, int p, int c, int hs, int tile, int* out,
                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (t < 1 || tile < 1 || !valid(n, d, h, l, p, c, hs) || (tile < (t + c - 1) / c) != kTiled)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, l, p, c, hs, tile) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return with_task_size(n, [&](auto nn) {
    return cluster_capacity(fused_mlap_kernel<decltype(nn)::value, kTiled>, c, bytes, out);
  });
}

}  // namespace
