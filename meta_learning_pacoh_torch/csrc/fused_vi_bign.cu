// A whole PACOH-VI training run for tasks of 9 <= N <= 256 points in one
// launch: n_steps iterations of (S reparameterised samples, their scores,
// the closed-form gradients of the negative ELBO, Adam) for the diagonal
// Gaussian hyper-posterior q = N(loc, diag(exp(log_scale))^2) over a GP
// prior with an NN mean and an NN kernel (feature_dim 1, L hidden layers of
// width H), on T tasks.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_vi_bign_kernel.py (fused_vi_bign_train_packed; body _make_kernel,
// the big-N score section of fused_svgd_bign_kernel.py with its value).
// Per step, with eps_s the step's standard normals, as the fused VI kernel
// B7 (fused_vi.cu) with the big-N score section in place of the small one:
//   sample    theta_s = loc + exp(log_scale) * eps_s
//   score     score_s = d obj_s / d theta_s: the G = S*T systems (s, t) of
//             bign_score.cuh (shared with the big-N SVGD kernel), each
//             sample's T partial gradients summed in order, plus the
//             hyper-prior term pf * -(theta - loc_p) / scale_p^2
//   objective obj_s = pf * lp_s - 0.5 (wql_s + mll_const), lp_s =
//             -0.5 sum_p ((theta_s - loc_p) / scale_p)^2 + lp_const, wql_s =
//             sum_t w_t (quad_t + logdet_t) from the systems' factors
//   gradients g_loc = -mean_s score_s,
//             g_log_scale = -exp(log_scale) mean_s(score_s eps_s) - pf
//   Adam      on loc and log_scale, bias corrections 1 - exp(t log b) in
//             float32; the loss -(mean_s obj_s + pf (ent_const + sum
//             log_scale)) of the pre-update posterior.
//
// What bounds it on the card: the systems' algebra and nets, as in the big-N
// SVGD kernel (fused_svgd_bign.cu): one block per system walks its matrix
// through the tiled panels of tiled_chol.cuh and tiled_inverse.cuh, 50
// systems side by side at bench.py's vi_t5_n200 (S=10, T=5, N=200); the
// step's noise page (S P floats) and the reduction over the samples (about
// 3 S P flops) are small beside them.
// A step: every block forms its systems' samples, computes their partial
// gradients and weighted MLL values into a [G, P + 1] scratch (the block of
// each sample's first task also the sample's prior quad, the block of
// system 0 the sum of log_scale); a grid barrier; a share of the P
// coordinates per block: the coordinate's S scores (each a fixed-order sum
// of T partials plus the prior term), their reductions and both Adam steps,
// in place; block 0 forms the step's loss; a second grid barrier. No float
// atomics, so any split into launches gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMinN = 9;
constexpr int kMaxN = 256;
constexpr int kMaxS = 32;
constexpr int kMaxGroups = 128;

#include "tiled_chol.cuh"
#include "tiled_inverse.cuh"
#include "map_nets.cuh"
#include "fused_update.cuh"
#include "bign_score.cuh"

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
  const float* w_t;     // [T] pre / n_eff, 0 for an empty task
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const float* eps;     // [n_steps, S, P] standard normals
  const float* prior_loc;    // [P]
  const float* prior_scale;  // [P]
  const int* offs;      // leaf offsets (bign_score.cuh)
  const int* widths;    // [2L] hidden widths
  float* gbuf;          // [G, P + 1] scratch: minus the partial gradients; w (quad + logdet)
  float* act;           // [blocks, 2 L H (N | 1)] scratch: MLP activations, unless held in shared memory
  float* work;          // [blocks, N, N] scratch: the matrix, when not in shared memory
  float* aux;           // [S + 1] scratch: the samples' prior quads, the sum of log_scale
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  // shared: 0 the matrix and the activations in device memory, 1 the
  // matrix in shared memory, 2 both
  int s, t, n, d, h, l, p, n_steps, blocks, spb, shared;
  float step0, lr, pf, mll_const, lp_const, ent_const;
};

// Shared-memory floats of one block; ops/cuda/fused_vi_bign_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int n, int d, int p, int h, int l, int shared) {
  return bign_matrix_floats(n, shared) + static_cast<size_t>(p) + bign_vector_floats(n, d) + 32 +
         bign_act_floats(n, h, l, shared);
}

__global__ void __launch_bounds__(kThreads) fused_vi_bign_kernel(Params q) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int S = q.s, T = q.t, N = q.n, D = q.d, L = q.l, P = q.p;
  const int G = S * T, P1 = P + 1;
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x, n_blk = gridDim.x;

  float* tws = smem;                // the tiled matrix's scratch
  float* tri = tws + tiled_scratch_floats(N, N + 1);  // its packed rows, when held here
  float* th = tri + (q.shared ? packed_off(N + 1) : 0);  // [P] the system's sample
  float* xs = th + P;               // [N][D]
  float* ys = xs + N * D;           // [N]
  float* ms = ys + N;               // [N]
  float* outm = ms + N;             // [N]
  float* outk = outm + N;           // [N]
  float* rv = outk + N;             // [N]
  float* al = rv + N;               // [N]
  float* rowp = al + N;             // [N][3]
  float* border = rowp + 3 * N;     // [N] the border row, when the matrix is in device memory
  float* hyp = border + N;          // [4]
  float* sums = hyp + 4;            // [kMaxTiles + 4]
  float* red32 = sums + kMaxTiles + 4;  // [32] block_sum's partials
  float* act_s = red32 + 32;        // [2][L][H][N | 1] the activations, when held here
  const TiledMatrix mat{q.shared ? tri : q.work + static_cast<size_t>(blk) * N * N,
                        q.shared ? nullptr : border, N, N + 1, q.shared != 0};
  float* act_m = q.shared == 2 ? act_s : q.act + blk * bign_act_size(N, q.h, L);
  const BignWork work{xs, ys, ms, outm, outk, rv, al, rowp, hyp, sums, tws, mat,
                      act_m, act_m + bign_act_size(N, q.h, L) / 2};

  const float sf = static_cast<float>(S);
  const int g0 = blk * q.spb, g1 = min(G, g0 + q.spb);
  float loss = 0.f, loss_sum = 0.f;  // kept by thread 0 of block 0
  for (int it = 0; it < q.n_steps; ++it) {
    const float* eps_it = q.eps + static_cast<size_t>(it) * S * P;

    // ---- the block's systems, in order
    for (int g = g0; g < g1; ++g) {
      const int si = g / T, t = g % T;
      float w = q.w_t[t];
      if (q.counts != nullptr) {
        const float c = q.counts[static_cast<size_t>(it) * T + t];
        w = c > 0.f ? w * c : 0.f;
      }
      const float* eps_s = eps_it + static_cast<size_t>(si) * P;
      for (int c = tid; c < P; c += nth)
        th[c] = __ldcg(q.loc + c) + expf(__ldcg(q.lsc + c)) * __ldg(eps_s + c);
      for (int c = tid; c < N * D; c += nth) xs[c] = q.x[static_cast<size_t>(t) * N * D + c];
      for (int c = tid; c < N; c += nth) {
        ys[c] = q.y[static_cast<size_t>(t) * N + c];
        ms[c] = q.mask[static_cast<size_t>(t) * N + c];
      }
      __syncthreads();
      float* gb = q.gbuf + static_cast<size_t>(g) * P1;
      const float ql = bign_system(th, q.offs, q.widths, L, N, D, w, gb, work);
      if (tid == 0) gb[P] = w > 0.f ? w * ql : 0.f;
      if (t == 0) {  // the sample's prior quad
        float quad = 0.f;
        for (int c = tid; c < P; c += nth) {
          const float z = (th[c] - q.prior_loc[c]) / q.prior_scale[c];
          quad += z * z;
        }
        quad = block_sum(quad, red32);
        if (tid == 0) q.aux[si] = quad;
      }
      if (g == 0) {  // the pre-update sum of log_scale, for the loss
        float lsum = 0.f;
        for (int c = tid; c < P; c += nth) lsum += __ldcg(q.lsc + c);
        lsum = block_sum(lsum, red32);
        if (tid == 0) q.aux[S] = lsum;
      }
    }
    grid.sync();

    // ---- a share of the P coordinates: S scores, the gradients, Adam
    const float t_f = q.step0 + static_cast<float>(it) + 1.f;
    const float bc1 = 1.f - expf(t_f * kLogB1);
    const float bc2 = 1.f - expf(t_f * kLogB2);
    for (int c = blk * nth + tid; c < P; c += n_blk * nth) {
      const float lo = q.loc[c], ls = q.lsc[c];
      const float ploc = q.prior_loc[c], pscale = q.prior_scale[c];
      float gs = 0.f, ge = 0.f;
      for (int j = 0; j < S; ++j) {
        const float e = __ldg(eps_it + static_cast<size_t>(j) * P + c);
        float part = 0.f;
        for (int t = 0; t < T; ++t) part += __ldcg(q.gbuf + static_cast<size_t>(j * T + t) * P1 + c);
        const float dv = (lo + expf(ls) * e) - ploc;
        const float sj = -part + q.pf * (-dv / (pscale * pscale));
        gs += sj;
        ge += sj * e;
      }
      float loc_c = lo, lsc_c = ls;
      adam(-gs / sf, loc_c, q.m_loc[c], q.v_loc[c], q.lr, bc1, bc2);
      adam(-expf(ls) * ge / sf - q.pf, lsc_c, q.m_lsc[c], q.v_lsc[c], q.lr, bc1, bc2);
      q.loc[c] = loc_c;
      q.lsc[c] = lsc_c;
    }
    if (blk == 0 && tid == 0) {  // the step's loss
      float obj = 0.f;
      for (int j = 0; j < S; ++j) {
        float wql = 0.f;
        for (int t = 0; t < T; ++t) wql += __ldcg(q.gbuf + static_cast<size_t>(j * T + t) * P1 + P);
        const float lp = -0.5f * __ldcg(q.aux + j) + q.lp_const;
        obj += q.pf * lp + (-0.5f * (wql + q.mll_const));
      }
      loss = -(obj / sf + q.pf * (q.ent_const + __ldcg(q.aux + S)));
      loss_sum += loss;
    }
    grid.sync();
  }
  if (blk == 0 && tid == 0) {
    q.loss_out[0] = loss;
    q.loss_out[1] = loss_sum;
  }
}

}  // namespace

extern "C" int pacoh_fused_vi_bign(float* loc, float* lsc, float* m_loc, float* m_lsc,
                                   float* v_loc, float* v_lsc, const float* x, const float* y,
                                   const float* mask, const float* w_t, const float* counts,
                                   const float* eps, const float* prior_loc,
                                   const float* prior_scale, const int* offs, const int* widths,
                                   float* gbuf, float* act, float* work, float* aux,
                                   float* loss_out, int s, int t, int n, int d, int h, int l,
                                   int p, int n_steps, int blocks, int spb, int shared,
                                   float step0, float lr, float pf, float mll_const,
                                   float lp_const, float ent_const, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = s * t;
  if (s < 1 || s > kMaxS || n < kMinN || n > kMaxN || t < 1 || d < 1 || h < 1 || l < 1 ||
      p < 1 || n_steps < 1 || blocks < 1 || blocks > kMaxGroups || spb < 1 || blocks * spb < g ||
      (blocks - 1) * spb >= g || shared < 0 || shared > 2 || (!shared && work == nullptr) ||
      (shared < 2 && act == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_floats(n, d, p, h, l, shared) * sizeof(float);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_vi_bign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_vi_bign_kernel, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < blocks) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{loc, lsc, m_loc, m_lsc, v_loc, v_lsc, x, y, mask, w_t, counts, eps, prior_loc,
           prior_scale, offs, widths, gbuf, act, work, aux, loss_out, s, t, n, d, h, l, p,
           n_steps, blocks, spb, shared, step0, lr, pf, mll_const, lp_const, ent_const};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_vi_bign_kernel),
                                    dim3(blocks), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
