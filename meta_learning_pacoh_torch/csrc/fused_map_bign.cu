// A whole PACOH-MAP training run for tasks of 9 <= N <= 512 points in one
// launch: n_steps iterations of (loss -sum_t w_t MLL_t and its gradient,
// AdamW) for one GP prior with an NN mean and an NN-featurised RBF kernel
// (any depths and widths of the two nets, D inputs, F <= 8 features).
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_map_bign_kernel.py (fused_map_bign_train_packed; body _make_kernel).
// Per step, as the TPU kernel's body (:195-327):
//   forward   both tanh MLPs over the T*N rows; z = feature / lengthscale;
//             d2 = |z_a|^2 + |z_b|^2 - 2 z_a.z_b, Km = os exp(-0.5 max(d2, 0))
//   MLL       per task Kn = Km m_a m_b + diag(real ? noise + floor + 1e-6 : 1),
//             factored at the first jitter of (0, 1e-4, 1e-2) that succeeds,
//             the jitter on the real rows' diagonal only (eye * mask, :153);
//             z = L^-1 r, quad = |z|^2, logdet = 2 sum log diag L;
//             the loss term 0.5 w_t (quad + logdet + n_t log 2 pi)
//   backward  W = L^-1 in place, alpha = W^T z, per entry
//             score = 0.5 w (alpha_a alpha_b - (W^T W)_ab) into d(mean),
//             d(feature) (a clamped d2 passes no gradient), d(lengthscale),
//             d(outputscale), d(noise); both MLPs' backward
//   AdamW     optax.adamw with float32 bias corrections (csrc/map_nets.cuh,
//             shared with B6).
//
// What bounds it on the card: at bench.py's map_t5_n200 (T=5, N=200, D=1,
// nets 32x32, F=2, P=2343) a step needs per task about N^3/3 flops for the
// factor, N^3/3 for the inverse and 2 N^3/3 for the K^-1 entries, 8 MFLOP,
// and 2.6 MFLOP of MLP products: 54 MFLOP a step, under 1 us of the card's
// f32 rate. Nothing near that is reached here: one block per task (5 of
// 132 SMs) walks the factorization's and the inversion's columns in order,
// two barriers each, so the step is bound by that chain of barriers. The
// task's matrix lives in shared memory when it fits beside the parameters
// (N=200 does; N <= 224 at these widths), else in the block's region of a
// device scratch (in L2); the MLP activations live in a device scratch, so
// shared memory holds the matrix. No second N x N matrix is stored: each
// K^-1 entry is formed from W where the score chain needs it, and each Km
// entry is rebuilt from the F features. A step is B6's (csrc/fused_map.cu):
// partial gradients into a [G, P + 1] scratch, a grid barrier, a
// fixed-order reduction and AdamW split over the blocks, a second barrier.
// No float atomics, so any split into launches gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMinN = 9;
constexpr int kMaxN = 512;
constexpr int kMaxF = 8;
constexpr int kMaxGroups = 128;

#include "blocked_factor.cuh"
#include "map_nets.cuh"

struct Params {
  float* theta;         // [P] in/out
  float* m;             // [P] in/out
  float* v;             // [P] in/out
  const float* x;       // [T, N, D]
  const float* y;       // [T, N]
  const float* mask;    // [T, N]
  const float* w_t;     // [T] 1 / n_t, 0 for an empty task
  const float* counts;  // [n_steps, T] task-draw counts, or null
  const int* offs;      // leaf offsets, as B6's
  const int* widths;    // hidden widths: the mean net's, then the kernel net's
  float* gbuf;          // [G, P + 1] scratch: partial loss gradients, partial loss
  float* act;           // [G, tpb * N * (sum_hm + sum_hk)] scratch: MLP activations
  float* work;          // [G, N, N] scratch: the task's matrix, when not in shared memory
  float* loss_out;      // [2] last step's loss, sum of the launch's losses
  int t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, groups, tpb, shared;
  float step0, lr, wd, noise_floor;
};

// Shared-memory floats of one block; ops/cuda/fused_map_bign_kernel.py
// (smem_bytes) states the same count.
size_t smem_floats(int tpb, int n, int d, int f, int p, int shared) {
  const size_t r = static_cast<size_t>(tpb) * n;
  return static_cast<size_t>(p) + r * (d + 3 + f) + f + (f + 3) + 3 * static_cast<size_t>(n) +
         static_cast<size_t>(n) * (2 * f + 2) + static_cast<size_t>(kPanel) * n + 1 +
         (shared ? static_cast<size_t>(n) * shared_ld(n) : 0);
}

// d2 of rows a and b of z [N][F] by the expansion the TPU kernel and
// ops/kernels.sq_dists use; symmetric to the bit.
__device__ __forceinline__ float d2_raw(const float* z, int F, int a, int b) {
  float na = 0.f, nb = 0.f, dot = 0.f;
  for (int c = 0; c < F; ++c) {
    const float za = z[a * F + c], zb = z[b * F + c];
    na += za * za;
    nb += zb * zb;
    dot += za * zb;
  }
  return (na + nb) - 2.f * dot;
}

// One task's weighted MLL and its gradient, by the whole block. On entry mu
// holds the task's mean-net outputs [N] and ph its features [N][F]; on exit
// mu holds d(sum ll)/d(mean) and ph d(sum ll)/d(feature). hyp [F + 3]
// accumulates d/d(softplus lengthscale) [F], d/d(softplus outputscale)
// times the outputscale, d/d(noise), and the loss term -ll.
__device__ __noinline__ void task_grad(float* mu, float* ph, const float* y, const float* msk,
                                       int N, int F, const float* sp_ls, float sp_os,
                                       float diag_add, float w, float* mat, int ld, float* pcol,
                                       float* rv, float* zv, float* al, float* rowp, float* red,
                                       float* hyp) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nth >> 5;
  if (w == 0.f) {  // a task not drawn this step, or an empty one, adds exactly 0
    for (int i = tid; i < N; i += nth) mu[i] = 0.f;
    for (int e = tid; e < N * F; e += nth) ph[e] = 0.f;
    __syncthreads();
    return;
  }
  // features -> z = feature / lengthscale, in place; the masked residual
  for (int e = tid; e < N * F; e += nth) ph[e] /= sp_ls[e % F];
  for (int i = tid; i < N; i += nth) rv[i] = (y[i] - mu[i]) * msk[i];
  __syncthreads();

  const int level = factor_escalated(mat, N, ld, pcol, [&](float* a, float jit) {
    for (int idx = tid; idx < N * N; idx += nth) {
      const int i = idx / N, k = idx % N;
      if (k > i) continue;
      float v = sp_os * expf(-0.5f * fmaxf(d2_raw(ph, F, i, k), 0.f)) * msk[i] * msk[k];
      if (i == k) {
        if (msk[i] > 0.f) {
          v += diag_add;
          v += jit;
        } else {
          v += 1.f;
        }
      }
      a[i * ld + k] = v;
    }
  });
  if (level < 0) {  // no level factors: NaN, as the TPU kernel's last level gives
    for (int idx = tid; idx < N * N; idx += nth) {
      const int i = idx / N, k = idx % N;
      if (k <= i) mat[i * ld + k] = nanf("");
    }
    __syncthreads();
  }
  const float quad = forward_subst(mat, N, ld, rv, zv, red);
  const float logdet = logdet_lower(mat, N, ld, red);
  if (tid == 0) {
    float n_eff = 0.f;
    for (int i = 0; i < N; ++i) n_eff += msk[i];
    hyp[F + 2] += 0.5f * w * (quad + logdet + n_eff * kLog2Pi);
  }
  invert_lower(mat, N, ld, pcol);
  wt_times(mat, N, ld, zv, al);
  for (int i = tid; i < N; i += nth) mu[i] = w * al[i] * msk[i];

  // a warp per row a, lanes along the columns b: score_ab and its chains
  const int stride = 2 * F + 2;
  for (int a = warp; a < N; a += n_warps) {
    const float ma = msk[a], al_a = al[a];
    float za[kMaxF], dz[kMaxF];
#pragma unroll
    for (int c = 0; c < kMaxF; ++c) {
      za[c] = c < F ? ph[a * F + c] : 0.f;
      dz[c] = 0.f;
    }
    float dos = 0.f, dn = 0.f;
    for (int b = lane; b < N; b += 32) {
      const float s = 0.5f * w * (al_a * al[b] - kinv_entry(mat, N, ld, a, b));
      const float dkm = s * ma * msk[b];
      if (b == a) dn += s * ma;
      const float d2 = d2_raw(ph, F, a, b);
      const float km = sp_os * expf(-0.5f * fmaxf(d2, 0.f));
      dos += dkm * km;
      const float dd2 = d2 > 0.f ? -0.5f * dkm * km : 0.f;
#pragma unroll
      for (int c = 0; c < kMaxF; ++c)
        if (c < F) dz[c] += 4.f * dd2 * (za[c] - ph[b * F + c]);
    }
    dos = warp_sum(dos);
    dn = warp_sum(dn);
#pragma unroll
    for (int c = 0; c < kMaxF; ++c)
      if (c < F) dz[c] = warp_sum(dz[c]);
    if (lane == 0) {
      float* rp = rowp + a * stride;
      for (int c = 0; c < F; ++c) {
        rp[c] = dz[c];
        rp[F + c] = dz[c] * (-za[c]);
      }
      rp[2 * F] = dos;
      rp[2 * F + 1] = dn;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * F; e += nth) ph[e] = rowp[(e / F) * stride + e % F] / sp_ls[e % F];
  if (tid < F + 2) {  // the task's hyperparameter sums over its rows, in order
    float s = 0.f;
    for (int a = 0; a < N; ++a) s += rowp[a * stride + F + tid];
    hyp[tid] += tid < F ? s / sp_ls[tid] : s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) fused_map_bign_kernel(Params q) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = q.t, N = q.n, D = q.d, F = q.f, P = q.p, G = q.groups;
  const int tid = threadIdx.x, nth = blockDim.x, blk = blockIdx.x;
  const int task0 = blk * q.tpb;
  const int nt = min(q.tpb, T - task0);  // this block's tasks
  const int R = nt * N, r_max = q.tpb * N;

  float* th = smem;                       // [P] the parameters
  float* xs = th + P;                     // [R][D]
  float* ys = xs + r_max * D;             // [R]
  float* ms = ys + r_max;                 // [R]
  float* outm = ms + r_max;               // [R] mean-net output, then d(mean)
  float* outk = outm + r_max;             // [R][F] features, then d(feature)
  float* sp_ls = outk + r_max * F;        // [F]
  float* hyp = sp_ls + F;                 // [F + 3] the block's hyperparameter sums
  float* rv = hyp + F + 3;                // [N] residual
  float* zv = rv + N;                     // [N] L^-1 r
  float* al = zv + N;                     // [N] K^-1 r
  float* rowp = al + N;                   // [N][2F + 2] per-row partials
  float* pcol = rowp + N * (2 * F + 2);   // [kPanel][N] panel columns
  float* red = pcol + kPanel * N;         // [1]
  float* mat = q.shared ? red + 1 : q.work + static_cast<size_t>(blk) * N * N;
  const int ld = q.shared ? shared_ld(N) : N;
  float* act_m = q.act + static_cast<size_t>(blk) * r_max * (q.sum_hm + q.sum_hk);
  float* act_k = act_m + r_max * q.sum_hm;

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
    if (tid < F + 3) hyp[tid] = 0.f;
    __syncthreads();

    const float sp_os = softplus(th[off_os]);
    const float diag_add = softplus(th[off_nz]) + q.noise_floor + 1e-6f;
    for (int i = 0; i < nt; ++i) {
      const int t = task0 + i;
      float w = q.w_t[t];
      if (q.counts != nullptr) {
        const float c = q.counts[static_cast<size_t>(it) * T + t];
        w = c > 0.f ? w * c : 0.f;
      }
      task_grad(outm + i * N, outk + i * N * F, ys + i * N, ms + i * N, N, F, sp_ls, sp_os,
                diag_add, w, mat, ld, pcol, rv, zv, al, rowp, red, hyp);
    }

    // both nets' backward, and the hyperparameters' gradients
    net_backward(th, o_m, q.widths, q.lm, 1, xs, D, R, r_max, act_m, outm, gb);
    net_backward(th, o_k, q.widths + q.lm, q.lk, F, xs, D, R, r_max, act_k, outk, gb);
    if (tid <= F + 2) {
      const float s = hyp[tid];
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

}  // namespace

extern "C" int pacoh_fused_map_bign(float* theta, float* m, float* v, const float* x,
                                    const float* y, const float* mask, const float* w_t,
                                    const float* counts, const int* offs, const int* widths,
                                    float* gbuf, float* act, float* work, float* loss_out, int t,
                                    int n, int d, int f, int lm, int lk, int sum_hm, int sum_hk,
                                    int p, int n_steps, int groups, int tpb, int shared,
                                    float step0, float lr, float wd, float noise_floor,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < kMinN || n > kMaxN || f < 1 || f > kMaxF || t < 1 || d < 1 || lm < 1 || lk < 1 ||
      sum_hm < lm || sum_hk < lk || p < 1 || n_steps < 1 || groups < 1 || groups > kMaxGroups ||
      tpb < 1 || groups * tpb < t || (groups - 1) * tpb >= t || (!shared && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_floats(tpb, n, d, f, p, shared) * sizeof(float);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(fused_map_bign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // every block must be resident at once for the grid barrier
  int per_sm = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_map_bign_kernel, kThreads,
                                                      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * n_sm < groups) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  Params q{theta, m, v, x, y, mask, w_t, counts, offs, widths, gbuf, act, work, loss_out,
           t, n, d, f, lm, lk, sum_hm, sum_hk, p, n_steps, groups, tpb, shared, step0, lr, wd,
           noise_floor};
  void* args[] = {&q};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fused_map_bign_kernel),
                                    dim3(groups), dim3(kThreads), args, bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
