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
//             MLPs' backward (score_section.cuh) into score_s; (loc,
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
// card's peaks. Not bytes and not flops but one SM per sample does (its
// shared-memory loads in the MLP products, block barriers, the serial N x N
// algebra of one thread a task) plus two grid barriers a step (one in
// meta-test mode).
// The design: one block owns one sample s. Each block holds the whole state
// (hyper-posterior, per-task posteriors, noise, their Adam moments) in
// shared memory, 135 KB at sin_20 with the MLP activations. A step: each
// block forms theta_s, runs both MLPs forward, and one thread a task
// computes KL_st with gamma left out (the gradients are linear in gamma_t):
// K^-1 (mu - m0) and K^-1 L0 (the q-side partials) and the task's
// d(mean), d(feature), d(lengthscale). It publishes KL_st and the partials
// to a scratch in device memory, double-buffered by step parity, and passes
// a grid barrier (cooperative launch). Every block then forms the same
// gamma_t from all samples' KLs, scales its own cotangents, runs both MLPs
// backward into score_s, publishes it, and passes the second barrier; then
// every block performs the identical reduction over the samples, in one
// fixed order, and the identical Adam update of its own copy of the state,
// so all copies keep the same bits; block 0 writes the state back at the end.
// No float atomics: a run gives the same bits however it is split into
// launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "score_section.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 32;
constexpr int kMaxN = 8;
constexpr size_t kMaxSmem = 232448;
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
  const int* offs;      // leaf offsets (score_section.cuh)
  float* kl_buf;        // [2, S, T] scratch: KL_st
  float* q_buf;         // [2, S, T N (N + 1)] scratch: K^-1 (mu - m0), then K^-1 L0
  float* s_buf;         // [2, S, P] scratch: the samples' scores
  float* out;           // [5] last loss, sum of the launch's losses, and the last
                        // step's sum_t u_t avg_ll_t, kl_outer, sum_t u_t kl_inner_t
  int s, t, n, d, h, l, p, n_steps, meta_test;
  float step0, lr_main, lr_post, u_scale, tkw, mkw, neg_log_delta, log_n_tasks, cm2,
      sum_log_sigma_p;
};

// Shared-memory floats of one block; ops/cuda/fused_mlap_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int t, int n, int d, int h, int l, int p) {
  const size_t m = static_cast<size_t>(t) * n;
  return 8 * static_cast<size_t>(p) + 3 * m * (n + 1) + 2 * static_cast<size_t>(l) * m * h +
         m * (d + 4) + 8 * static_cast<size_t>(t) + 32 + 16;
}

// The block's sum of one value a thread, in one fixed order (the same in
// every block); every thread receives it. red: [32] shared floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < n_warps; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ __forceinline__ void adam(float g, float& theta, float& m, float& v, float lr, float bc1,
                                     float bc2) {
  const float mn = kB1 * m + kOneMinusB1 * g;
  const float vn = kB2 * v + kOneMinusB2 * g * g;
  m = mn;
  v = vn;
  theta -= lr * ((mn / bc1) / (sqrtf(vn / bc2) + kEps));
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
  float lf[N][N];
  if (!factor<N>(a, 1e-6f, lf) && !factor<N>(a, 1e-4f, lf)) factor<N>(a, 1e-2f, lf);

  // W = L1^-1 (lower), then K^-1 = W^T W into a (symmetric, full)
  float wi[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = j; i < N; ++i) {
      float s = (i == j) ? 1.f : 0.f;
#pragma unroll
      for (int q = j; q < i; ++q) s -= lf[i][q] * wi[q][j];
      wi[i][j] = s / lf[i][i];
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

__device__ void task_kl_n(int n, float* mu, float* ph, const float* y, const float* msk,
                          const float* qm, const float* qt, float sp_ls, float nv, float* kl,
                          float* dls, float* avg_ll, float* dvar, float* wq, float* pq) {
  switch (n) {
    case 1: task_kl<1>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 2: task_kl<2>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 3: task_kl<3>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 4: task_kl<4>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 5: task_kl<5>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 6: task_kl<6>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    case 7: task_kl<7>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
    default: task_kl<8>(mu, ph, y, msk, qm, qt, sp_ls, nv, kl, dls, avg_ll, dvar, wq, pq); break;
  }
}

__global__ void __launch_bounds__(kThreads) fused_mlap_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int S = q.s, T = q.t, N = q.n, D = q.d, H = q.h, L = q.l, P = q.p;
  const int M = T * N, MN = M * N;
  const int NQ = M + MN;  // q-side partials of one sample: w [T, N], then K^-1 L0 [T, N, N]
  const bool train = q.meta_test == 0;
  const int me = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n_leaves = 2 * L + 2;
  const int off_ls = q.offs[2 * n_leaves], off_nz = q.offs[2 * n_leaves + 1];

  float* th = smem;                 // [P] this block's sample
  float* sc = th + P;               // [P] its score
  float* loc = sc + P;              // [P] the hyper-posterior and its Adam moments,
  float* lsc = loc + P;             //     the same bits in every block
  float* mlo = lsc + P;
  float* mls = mlo + P;
  float* vlo = mls + P;
  float* vls = vlo + P;
  float* qm = vls + P;              // [M] q_means and its moments
  float* mqm = qm + M;
  float* vqm = mqm + M;
  float* qt = vqm + M;              // [M N] q_trils and its moments
  float* mqt = qt + MN;
  float* vqt = mqt + MN;
  float* act = vqt + MN;            // [2 nets][L][M][H]
  float* xs = act + 2 * L * M * H;  // [M][D]
  float* ys = xs + M * D;           // [M]
  float* ms = ys + M;               // [M]
  float* outm = ms + M;             // [M]
  float* outk = outm + M;           // [M]
  float* pls = outk + M;            // [T] d(lengthscale) of the task, gamma left out
  float* avl = pls + T;             // [T] avg_ll
  float* dvr = avl + T;             // [T] d avg_ll / d noise_var
  float* uu = dvr + T;              // [T] u_t
  float* gam = uu + T;              // [T] gamma_t
  float* bet = gam + T;             // [T] beta_t
  float* bnd = bet + T;             // [T] u_t bound_t
  float* ukl = bnd + T;             // [T] u_t kl_inner_t
  float* red = ukl + T;             // [32] block_sum's partials
  float* scal = red + 32;           // [16] 0 loss, 1 chi, 8-10 raw_noise and its m, v
  const ScoreSmem ws{act, xs, ys, ms, outm, outk, nullptr, nullptr, nullptr};

  for (int c = tid; c < P; c += nth) {
    loc[c] = q.loc[c];
    lsc[c] = q.lsc[c];
    if (train) {
      mlo[c] = q.m_loc[c];
      mls[c] = q.m_lsc[c];
      vlo[c] = q.v_loc[c];
      vls[c] = q.v_lsc[c];
    }
  }
  for (int c = tid; c < M; c += nth) {
    qm[c] = q.qm[c];
    mqm[c] = q.m_qm[c];
    vqm[c] = q.v_qm[c];
    ys[c] = q.y[c];
    ms[c] = q.mask[c];
  }
  for (int c = tid; c < MN; c += nth) {
    qt[c] = q.qt[c];
    mqt[c] = q.m_qt[c];
    vqt[c] = q.v_qt[c];
  }
  for (int c = tid; c < M * D; c += nth) xs[c] = q.x[c];
  if (tid == 0) {
    scal[8] = q.nu[0];
    scal[9] = train ? q.m_nu[0] : 0.f;
    scal[10] = train ? q.v_nu[0] : 0.f;
  }
  __syncthreads();

  const float sf = static_cast<float>(S);
  float loss_sum = 0.f;  // kept by block 0's thread 0
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;
    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;
    const float* cnt = q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T;
    const float nv = softplus(scal[8]) + 1e-4f;  // the pre-update noise variance

    // ---- the outer KL of the pre-update hyper-posterior; my sample
    float a_sq = 0.f, a_rq = 0.f, a_ls = 0.f;
    const float* eps_me = eps_it + static_cast<size_t>(me) * P;
    for (int c = tid; c < P; c += nth) {
      const float sp = q.prior_scale[c];
      const float scale = expf(lsc[c]);
      const float rs = scale / sp;
      const float rq = (loc[c] - q.prior_loc[c]) / sp;
      a_sq += rs * rs;
      a_rq += rq * rq;
      a_ls += lsc[c];
      th[c] = loc[c] + scale * __ldg(eps_me + c);
    }
    a_sq = block_sum(a_sq, red);
    a_rq = block_sum(a_rq, red);
    a_ls = block_sum(a_ls, red);
    const float kl_outer = q.mkw * (0.5f * (a_sq + a_rq - static_cast<float>(P) +
                                            2.f * q.sum_log_sigma_p - 2.f * a_ls));

    // ---- both nets forward; one thread a task: its KL and partials, published
    nets_forward(th, q.offs, M, D, H, L, ws);
    const float sp_ls = softplus(th[off_ls]);
    float* kl_pub = q.kl_buf + (static_cast<size_t>(par) * S + me) * T;
    float* q_pub = q.q_buf + (static_cast<size_t>(par) * S + me) * NQ;
    for (int t = tid; t < T; t += nth) {
      float kl;
      task_kl_n(N, outm + t * N, outk + t * N, ys + t * N, ms + t * N, qm + t * N,
                qt + t * N * N, sp_ls, nv, &kl, pls + t, avl + t, dvr + t, q_pub + t * N,
                q_pub + M + t * N * N);
      kl_pub[t] = kl;
    }
    grid.sync();

    // ---- every block: the bound from all samples' KLs, gamma, the loss
    const float* kl_all = q.kl_buf + static_cast<size_t>(par) * S * T;
    for (int t = tid; t < T; t += nth) {
      float ks = 0.f, n_eff = 0.f;
      for (int j = 0; j < S; ++j) ks += __ldcg(kl_all + j * T + t);
      for (int i = 0; i < N; ++i) n_eff += ms[t * N + i];
      const float kl_in = q.tkw * (ks / sf);
      const float c_t = ((kLog2 + logf(n_eff)) + q.log_n_tasks) + q.neg_log_delta;
      const float c2 = 2.f * (n_eff - 1.f);
      const float cplx = sqrtf((kl_outer + kl_in + c_t) / c2);
      const float u = (cnt == nullptr ? 1.f : cnt[t]) * q.u_scale;
      const float beta = u / (2.f * c2 * cplx);
      uu[t] = u;
      gam[t] = beta * q.tkw / sf;
      bet[t] = beta;
      bnd[t] = u * (-avl[t] + cplx);
      ukl[t] = u * kl_in;
    }
    __syncthreads();
    if (tid == 0) {
      float loss = 0.f, chi = 0.f;
      for (int t = 0; t < T; ++t) {
        loss += bnd[t];
        chi += bet[t];
      }
      if (train) {
        const float meta_c =
            sqrtf((((kl_outer + kLog2) + q.log_n_tasks) + q.neg_log_delta) / q.cm2);
        loss += meta_c;
        chi += 1.f / (2.f * q.cm2 * meta_c);
      }
      scal[0] = loss;
      scal[1] = chi;
      if (me == 0) {
        float s_ll = 0.f, s_kl = 0.f;
        for (int t = 0; t < T; ++t) {
          s_ll += uu[t] * avl[t];
          s_kl += ukl[t];
        }
        loss_sum += loss;
        if (it == q.n_steps - 1) {
          q.out[0] = loss;
          q.out[1] = loss_sum;
          q.out[2] = s_ll;
          q.out[3] = kl_outer;
          q.out[4] = s_kl;
        }
      }
    }
    __syncthreads();

    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    if (train) {
      // ---- my sample's score: the cotangents times gamma_t, both nets backward
      for (int row = tid; row < M; row += nth) {
        const float g = gam[row / N];
        outm[row] *= g;
        outk[row] *= g;
      }
      __syncthreads();
      nets_backward(th, sc, q.offs, M, D, H, L, ws);
      if (tid == 0) {
        float dl = 0.f;
        for (int t = 0; t < T; ++t) dl += gam[t] * pls[t];
        sc[off_ls] = dl * sigmoid(th[off_ls]);
        sc[off_nz] = 0.f;
      }
      __syncthreads();
      float* s_pub = q.s_buf + (static_cast<size_t>(par) * S + me) * P;
      for (int c = tid; c < P; c += nth) s_pub[c] = sc[c];
      grid.sync();

      // ---- every block: the hyper-posterior's gradients over the S samples
      // in one order, Adam
      const float chi = scal[1];
      const float* s_all = q.s_buf + static_cast<size_t>(par) * S * P;
      for (int c = tid; c < P; c += nth) {
        float gs = 0.f, ge = 0.f;
        for (int j = 0; j < S; ++j) {
          const float sj = __ldcg(s_all + static_cast<size_t>(j) * P + c);
          gs += sj;
          ge += sj * __ldg(eps_it + static_cast<size_t>(j) * P + c);
        }
        const float sp = q.prior_scale[c];
        const float scale = expf(lsc[c]);
        const float rs = scale / sp;
        const float g_loc = gs + chi * q.mkw * (loc[c] - q.prior_loc[c]) / (sp * sp);
        const float g_lsc = scale * ge + chi * q.mkw * (rs * rs - 1.f);
        adam(g_loc, loc[c], mlo[c], vlo[c], q.lr_main, bc1, bc2);
        adam(g_lsc, lsc[c], mls[c], vls[c], q.lr_main, bc1, bc2);
      }
      if (tid == 0) {  // the noise, from the pre-update state
        float g = 0.f;
        for (int t = 0; t < T; ++t) g += uu[t] * (-dvr[t]);
        adam(sigmoid(scal[8]) * g, scal[8], scal[9], scal[10], q.lr_main, bc1, bc2);
      }
    }

    // ---- every block: the per-task posteriors' gradients over the S samples
    // in one order, Adam at lr_post
    const float* q_all = q.q_buf + static_cast<size_t>(par) * S * NQ;
    for (int e = tid; e < M; e += nth) {
      const int t = e / N;
      const float mk = ms[e];
      float ws_ = 0.f;
      for (int j = 0; j < S; ++j) ws_ += __ldcg(q_all + static_cast<size_t>(j) * NQ + e);
      float n_eff = 0.f;
      for (int i = 0; i < N; ++i) n_eff += ms[t * N + i];
      const float ll_coef = uu[t] / (nv * n_eff);
      const float r = ys[e] - qm[e] * mk;
      const float g = -ll_coef * mk * r - mk * (gam[t] * ws_);
      adam(g, qm[e], mqm[e], vqm[e], q.lr_post, bc1, bc2);
    }
    for (int e = tid; e < MN; e += nth) {
      const int t = e / (N * N);
      const int ij = e - t * N * N;
      const int i = ij / N, j = ij - i * N;
      float g = 0.f;
      if (j <= i) {
        const float mi = ms[t * N + i], mj = ms[t * N + j];
        float l0 = qt[e] * mi * mj;
        if (i == j) l0 += 1.f - mi;
        float ps = 0.f;
        for (int k = 0; k < S; ++k) ps += __ldcg(q_all + static_cast<size_t>(k) * NQ + M + e);
        float n_eff = 0.f;
        for (int c = 0; c < N; ++c) n_eff += ms[t * N + c];
        float gl = gam[t] * ps;
        if (i == j) gl -= (sf * gam[t]) * (signf(l0) / (fabsf(l0) + 1e-12f));
        g = ((uu[t] / (nv * n_eff)) * l0 + gl) * mi * mj;
      }
      adam(g, qt[e], mqt[e], vqt[e], q.lr_post, bc1, bc2);
    }
    __syncthreads();
  }

  if (me == 0) {
    for (int c = tid; c < P && train; c += nth) {
      q.loc[c] = loc[c];
      q.lsc[c] = lsc[c];
      q.m_loc[c] = mlo[c];
      q.m_lsc[c] = mls[c];
      q.v_loc[c] = vlo[c];
      q.v_lsc[c] = vls[c];
    }
    for (int c = tid; c < M; c += nth) {
      q.qm[c] = qm[c];
      q.m_qm[c] = mqm[c];
      q.v_qm[c] = vqm[c];
    }
    for (int c = tid; c < MN; c += nth) {
      q.qt[c] = qt[c];
      q.m_qt[c] = mqt[c];
      q.v_qt[c] = vqt[c];
    }
    if (tid == 0 && train) {
      q.nu[0] = scal[8];
      q.m_nu[0] = scal[9];
      q.v_nu[0] = scal[10];
    }
  }
}

}  // namespace

extern "C" int pacoh_fused_mlap(float* loc, float* lsc, float* qm, float* qt, float* nu,
                                float* m_loc, float* m_lsc, float* m_qm, float* m_qt, float* m_nu,
                                float* v_loc, float* v_lsc, float* v_qm, float* v_qt, float* v_nu,
                                const float* x, const float* y, const float* mask,
                                const float* counts, const float* eps, const float* prior_loc,
                                const float* prior_scale, const int* offs, float* kl_buf,
                                float* q_buf, float* s_buf, float* out, int s, int t, int n, int d,
                                int h, int l, int p, int n_steps, int meta_test, float step0,
                                float lr_main, float lr_post, float u_scale, float tkw, float mkw,
                                float neg_log_delta, float log_n_tasks, float cm2,
                                float sum_log_sigma_p, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s < 1 || s > kMaxS || n < 1 || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 || p < 1 ||
      n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, h, l, p) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_mlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlap_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < s) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{loc, lsc, qm, qt, nu, m_loc, m_lsc, m_qm, m_qt, m_nu, v_loc, v_lsc, v_qm, v_qt, v_nu,
           x, y, mask, counts, eps, prior_loc, prior_scale, offs, kl_buf, q_buf, s_buf, out,
           s, t, n, d, h, l, p, n_steps, meta_test, step0, lr_main, lr_post, u_scale, tkw, mkw,
           neg_log_delta, log_n_tasks, cm2, sum_log_sigma_p};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_mlap_kernel), dim3(s),
                                    dim3(kThreads), args, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
