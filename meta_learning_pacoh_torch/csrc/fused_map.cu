// A whole PACOH-MAP training run in one launch: n_steps iterations of
// (loss -sum_t w_t MLL_t and its gradient, AdamW) for one GP prior with an
// NN mean and an NN-featurised RBF kernel (any depths and widths of the two
// nets, D inputs, F <= 8 features) on T tasks of N <= 8 points.
//
// Replaces the Pallas TPU kernel meta_learning_pacoh_tpu/ops/pallas/
// fused_map_kernel.py (fused_map_train_packed; body _make_kernel). Per step:
//   forward   both tanh MLPs over the T*N rows; softplus lengthscale [F],
//             outputscale, noise + the 1e-3 floor
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
// their rows, about 0.3 MFLOP, though this kernel runs both nets over every
// row (an undrawn task's gradient is zeroed after them). Neither the bytes
// nor the card's flops bound it: the latency of the chain of barriers and of
// the serial per-task factorization does. There is one model, not one block
// per particle, so one block would leave the step on one SM (the bound of
// the SVGD kernel, csrc/fused_svgd.cu). Instead one cooperative launch
// spreads the tasks over G blocks (G = T up to 128; beyond, tasks are
// grouped evenly), each holding the parameters and its tasks' rows and
// activations in shared memory. A step: each block runs its rows forward
// and backward and writes its partial loss gradient to a [G, P + 1] scratch
// in device memory; a grid barrier; the blocks split the P coordinates, each
// sums its coordinates over the G partials in one fixed order and applies
// AdamW to the caller's theta, m, v; a second grid barrier (which also keeps
// the next step's partials from overwriting what a slower block still
// reads); every block re-reads theta. No float atomics:
// every sum has one fixed order, so a run gives the same bits however it is
// split into launches.

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

template <int N>
__device__ bool factor(const float (&a)[N][N], float jit, float (&lf)[N][N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i][j] + (i == j ? jit : 0.f);
#pragma unroll
      for (int q = 0; q < j; ++q) s -= lf[i][q] * lf[j][q];
      if (i == j) {
        lf[i][i] = sqrtf(s);
        ok = ok && (lf[i][i] > 0.f) && (lf[i][i] < INFINITY);
      } else {
        lf[i][j] = s / lf[j][j];
      }
    }
  }
  return ok;
}

// One task's weighted MLL and its gradient. On entry mu holds the rows'
// mean-net outputs and ph their features [N][F]; on exit mu holds
// d(sum ll)/d(mean) and ph d(sum ll)/d(feature). out [F + 3] receives the
// task's d/d(softplus lengthscale) [F], d/d(softplus outputscale) times the
// outputscale, d/d(noise), and its loss term -ll.
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
  float mk[N], r[N];
  float n_eff = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mk[i] = msk[i];
    r[i] = (y[i] - mu[i]) * mk[i];
    n_eff += mk[i];
  }
  // features -> z = feature / lengthscale, in place
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int c = 0; c < F; ++c) ph[i * F + c] /= sp_ls[c];

  float km[N][N], a[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float d2 = 0.f;
      for (int c = 0; c < F; ++c) {
        const float dz = ph[i * F + c] - ph[j * F + c];
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
  // the first of the jitters 0, 1e-4 whose factor is good, else 1e-2; one
  // copy of the unrolled factorization in a loop
  float lf[N][N];
#pragma unroll 1
  for (int lvl = 0; lvl < 3; ++lvl) {
    const float jit = lvl == 0 ? 0.f : (lvl == 1 ? 1e-4f : 1e-2f);
    if (factor<N>(a, jit, lf)) break;
  }

  float zs[N], al[N];
  float quad_logdet = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = r[i];
#pragma unroll
    for (int q = 0; q < i; ++q) s -= lf[i][q] * zs[q];
    zs[i] = s / lf[i][i];
    quad_logdet += zs[i] * zs[i] + 2.f * logf(lf[i][i]);
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = zs[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) s -= lf[q][i] * al[q];
    al[i] = s / lf[i][i];
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
  for (int c = 0; c < F; ++c) {
    float zc[N], dz[N];
#pragma unroll
    for (int i = 0; i < N; ++i) zc[i] = ph[i * F + c];
    float dl = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) acc += 2.f * a[i][j] * (zc[i] - zc[j]);
      dz[i] = 2.f * acc;  // the ordered pairs (i, j) and (j, i)
      dl += dz[i] * (-zc[i]) / sp_ls[c];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) ph[i * F + c] = dz[i] / sp_ls[c];
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
