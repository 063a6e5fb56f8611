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
//             (score_section.cuh, shared with the fused SVGD kernel) plus the
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
// sample's score is the fused SVGD kernel's particle score, about 1.3 MFLOP
// of MLP products and a few thousand flops of 5x5 linear algebra a task,
// and the step's reduction over the samples is about 3 S P flops. Neither
// the bytes (the step's eps page is S P floats, 92 KB) nor the card's flops
// bound it: one SM per sample does, as in the SVGD kernel (its
// shared-memory loads in the MLP products, its block barriers, the serial
// per-task factorization), plus one grid barrier a step.
// The design: one block owns one sample. Every block holds the posterior
// (loc, log_scale) and both pairs of Adam moments in shared memory (6 P
// floats, 55 KB at sin_20, beside the score section's 72 KB). Each block
// forms its sample, computes its score and objective, publishes both to an
// L2-resident scratch double-buffered by step parity (so no block
// overwrites what a slower block still reads), and passes one grid barrier
// (cooperative launch). Then every block performs the identical reduction
// over the S samples, in one fixed order, and the identical Adam update of
// its own copy of the state, so all copies keep the same bits and no second
// barrier is needed; block 0 writes the state back at the end. No float
// atomics: a run gives the same bits however it is split into launches.

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
  const int* offs;      // leaf offsets (score_section.cuh)
  float* s_buf;         // [2, S, P] scratch: the samples' scores
  float* o_buf;         // [2, S] scratch: the samples' objectives
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int s, t, n, d, h, l, p, n_steps;
  float step0, lr, pf, mll_const, lp_const, ent_const;
};

// Shared-memory floats of one block; ops/cuda/fused_vi_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int t, int n, int d, int h, int l, int p) {
  const size_t m = static_cast<size_t>(t) * n;
  return 8 * static_cast<size_t>(p) + 2 * static_cast<size_t>(l) * m * h + m * (d + 4) +
         3 * static_cast<size_t>(t) + 32 + 8;
}

#include "fused_update.cuh"

__global__ void __launch_bounds__(kThreads) fused_vi_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int S = q.s, T = q.t, N = q.n, D = q.d, H = q.h, L = q.l, P = q.p;
  const int M = T * N;
  const int me = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;

  float* th = smem;                 // [P] this block's sample
  float* sc = th + P;               // [P] its score, without the hyper-prior term
  float* loc = sc + P;              // [P] the posterior and its Adam moments, the same
  float* lsc = loc + P;             //     bits in every block
  float* mlo = lsc + P;
  float* mls = mlo + P;
  float* vlo = mls + P;
  float* vls = vlo + P;
  float* act = vls + P;             // [2 nets][L][M][H]
  float* xs = act + 2 * L * M * H;  // [M][D]
  float* ys = xs + M * D;           // [M]
  float* ms = ys + M;               // [M]
  float* outm = ms + M;             // [M]
  float* outk = outm + M;           // [M]
  float* pls = outk + M;            // [T]
  float* pnz = pls + T;             // [T]
  float* pql = pnz + T;             // [T]
  float* red = pql + T;             // [32] block_sum's partials
  float* scal = red + 32;           // [8] block-wide scalars: 0 the sample's wql
  const ScoreSmem ws{act, xs, ys, ms, outm, outk, pls, pnz, pql};

  for (int c = tid; c < P; c += nth) {
    loc[c] = q.loc[c];
    lsc[c] = q.lsc[c];
    mlo[c] = q.m_loc[c];
    mls[c] = q.m_lsc[c];
    vlo[c] = q.v_loc[c];
    vls[c] = q.v_lsc[c];
  }
  for (int c = tid; c < M * D; c += nth) xs[c] = q.x[c];
  for (int c = tid; c < M; c += nth) {
    ys[c] = q.y[c];
    ms[c] = q.mask[c];
  }
  __syncthreads();

  const float sf = static_cast<float>(S);
  float loss = 0.f, loss_sum = 0.f;  // kept by block 0
  for (int it = 0; it < q.n_steps; ++it) {
    const int par = it & 1;
    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;

    // ---- my sample
    const float* eps_me = eps_it + static_cast<size_t>(me) * P;
    for (int c = tid; c < P; c += nth) th[c] = loc[c] + expf(lsc[c]) * __ldg(eps_me + c);
    __syncthreads();

    // ---- its score and objective; publish both
    score_section<true>(th, sc, q.offs, T, N, D, H, L, q.w_t,
                        q.counts == nullptr ? nullptr : q.counts + static_cast<size_t>(it) * T,
                        ws, scal);
    float* s_pub = q.s_buf + (static_cast<size_t>(par) * S + me) * P;
    float quad = 0.f;
    for (int c = tid; c < P; c += nth) {
      const float scale = q.prior_scale[c];
      const float dv = th[c] - q.prior_loc[c];
      const float z = dv / scale;
      quad += z * z;
      s_pub[c] = sc[c] + q.pf * (-dv / (scale * scale));
    }
    quad = block_sum(quad, red);
    if (tid == 0) {
      const float lp = -0.5f * quad + q.lp_const;
      q.o_buf[par * S + me] = q.pf * lp + (-0.5f * (scal[0] + q.mll_const));
    }
    grid.sync();

    // ---- every block: the gradients over the S samples in one order, Adam
    const float* s_all = q.s_buf + static_cast<size_t>(par) * S * P;
    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    float lsum = 0.f;  // the pre-update sum of log_scale, for the loss
    for (int c = tid; c < P; c += nth) {
      float gs = 0.f, ge = 0.f;
      for (int j = 0; j < S; ++j) {
        const float sj = __ldcg(s_all + static_cast<size_t>(j) * P + c);
        gs += sj;
        ge += sj * __ldg(eps_it + static_cast<size_t>(j) * P + c);
      }
      const float ls = lsc[c];
      lsum += ls;
      const float g_loc = -gs / sf;
      const float g_lsc = -expf(ls) * ge / sf - q.pf;
      adam(g_loc, loc[c], mlo[c], vlo[c], q.lr, bc1, bc2);
      adam(g_lsc, lsc[c], mls[c], vls[c], q.lr, bc1, bc2);
    }
    if (me == 0) {  // the step's loss
      lsum = block_sum(lsum, red);
      if (tid == 0) {
        float obj = 0.f;
        for (int j = 0; j < S; ++j) obj += __ldcg(q.o_buf + par * S + j);
        loss = -(obj / sf + q.pf * (q.ent_const + lsum));
        loss_sum += loss;
      }
    }
    __syncthreads();
  }

  if (me == 0) {
    for (int c = tid; c < P; c += nth) {
      q.loc[c] = loc[c];
      q.lsc[c] = lsc[c];
      q.m_loc[c] = mlo[c];
      q.m_lsc[c] = mls[c];
      q.v_loc[c] = vlo[c];
      q.v_lsc[c] = vls[c];
    }
    if (tid == 0) {
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
                              int d, int h, int l, int p, int n_steps, float step0, float lr,
                              float pf, float mll_const, float lp_const, float ent_const,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s < 1 || s > kMaxS || n < 1 || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 || p < 1 ||
      n_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_floats(t, n, d, h, l, p) * sizeof(float);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_vi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_vi_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < s) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, counts, eps, prior_loc,
           prior_scale, offs, s_buf, o_buf, loss_out, s, t, n, d, h, l, p, n_steps,
           step0, lr, pf, mll_const, lp_const, ent_const};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_vi_kernel), dim3(s),
                                    dim3(kThreads), args, bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
